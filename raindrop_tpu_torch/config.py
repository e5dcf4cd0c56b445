"""Model and training configuration for the PyTorch port.

Its own copy of `raindrop_tpu/config.py`'s `RaindropConfig`, `TrainConfig`,
`DATASETS` and `dataset_config`: every field with the same default, so a
config serialised by the JAX package (`to_json`) loads here unchanged. The
port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class RaindropConfig:
    """Model hyperparameters for the Raindrop (v2) sensor-graph classifier.

    d_model = d_inp * d_ob, nhid = 2*d_model, nlayers=2, nhead=2,
    dropout=0.2 (reference code/Raindrop.py:109-148).
    """

    d_inp: int = 36              # number of sensors F
    d_static: int = 9            # static feature dim (0 => no static path)
    max_len: int = 215           # padded sequence length T
    n_classes: int = 2
    d_ob: int = 4                # per-sensor observation embedding dim
    d_pe: int = 16               # time positional-encoding dim
    nhead: int = 2               # temporal transformer heads
    nlayers: int = 2             # temporal transformer layers
    nhid: Optional[int] = None   # transformer FFN dim; default 2*d_model
    dropout: float = 0.2
    MAX: int = 100               # PE MAX parameter (kept for API parity)
    aggreg: str = "mean"
    sensor_wise_mask: bool = False
    use_beta: bool = False       # time-conditioned edge attention + pruning
    static: bool = True          # static-feature pathway on/off
    prop_dropout: float = 0.0    # attention dropout inside graph propagation
    init_range: float = 1e-10    # encoder/emb tiny-uniform init range
    dtype: str = "float32"       # param storage dtype
    # mixed-precision forward; the port refuses it until a later slice
    compute_dtype: Optional[str] = None
    # 'auto' | 'dense' | 'flash' | 'fused_layer' (nn/transformer.py)
    attention_backend: str = "auto"
    # operand dtype inside the attention kernels (scores and softmax
    # statistics stay f32); only the flash and fused-layer rungs read it
    attention_score_dtype: str = "bfloat16"
    # graph-propagation backend (models/raindrop.prop_branch): 'auto' takes
    # the dense complete-graph path unless a global_adj is passed; 'coo'
    # the segment-op path over the edge list; 'pallas' selects the
    # hand-written CUDA SpMM + segment-softmax kernel of ops/sparse.py (the
    # value keeps the JAX package's name so configs carry over)
    prop_backend: str = "auto"

    @property
    def d_model(self) -> int:
        return self.d_inp * self.d_ob

    @property
    def ffn_dim(self) -> int:
        return self.nhid if self.nhid is not None else 2 * self.d_model

    @property
    def d_transformer(self) -> int:
        """Width of the temporal transformer."""
        if self.sensor_wise_mask:
            return self.d_inp * (self.d_ob + self.d_pe)
        return self.d_model + self.d_pe

    @property
    def d_final(self) -> int:
        """Classifier-head width: the pooled width plus d_inp when static."""
        base = (self.d_inp * (self.d_ob + self.d_pe)
                if self.sensor_wise_mask else self.d_model + self.d_pe)
        return base + (self.d_inp if self.static else 0)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "RaindropConfig":
        return RaindropConfig(**json.loads(s))


@dataclass(frozen=True)
class TrainConfig:
    """Training protocol (reference code/Raindrop.py:105-160, 255-307).
    Every field of the JAX package's TrainConfig with its default; the
    fields of routes the port does not run yet raise when set."""

    dataset: str = "P12"
    num_epochs: int = 20
    learning_rate: float = 1e-4
    batch_size: int = 128
    n_splits: int = 5
    n_runs: int = 1
    # class-balance strategy: 2 = half/half with 3x-expanded positives
    # (binary), 3 = uniform random batches (multiclass)
    batching_strategy: int = 2
    n_batches_strategy3: int = 30
    # ReduceLROnPlateau on val AUPRC
    plateau_factor: float = 0.1
    plateau_patience: int = 1
    plateau_threshold: float = 1e-4
    plateau_min_lr: float = 1e-8
    split_type: str = "random"            # 'random' | 'age' | 'gender'
    reverse: bool = False
    feature_removal_level: str = "no_removal"
    missing_ratio: float = 0.0
    predictive_label: str = "mortality"
    seed: int = 1
    # kept for config round trips; the port's epoch is a Python loop of
    # steps over the device-resident split either way
    scan_epoch: bool = True
    input_pipeline: str = "resident"      # 'streaming' comes later
    prefetch_depth: int = 2
    measure_mfu: bool = False
    checkpoint_dir: str = "checkpoints"
    log_path: Optional[str] = None
    # weight on the model's aux output in the train loss; Raindrop's
    # alpha-distance stays excluded at 0.0 like the reference
    aux_loss_weight: float = 0.0
    diag_frozen_params: bool = False
    resplit_per_run: bool = False
    # scale-out routes: not ported yet
    context_parallel: str = "none"
    pipeline_microbatches: int = 0
    edge_partition: bool = False
    # split each batch into N chunks, average their gradients, one Adam
    # update: numerically the full-batch step (mean of chunk means)
    grad_microbatches: int = 1

    def __post_init__(self):
        if (self.context_parallel != "none" or self.pipeline_microbatches > 0
                or self.edge_partition):
            raise NotImplementedError(
                "context_parallel, pipeline_microbatches and edge_partition "
                "come with the scale-out slice")
        if self.input_pipeline != "resident":
            raise NotImplementedError(
                f"input_pipeline={self.input_pipeline!r} comes with a later "
                f"slice; the port trains from a device-resident split")
        if self.grad_microbatches < 1:
            raise ValueError("grad_microbatches must be >= 1")


# Per-dataset presets, reference code/Raindrop.py:109-148.
DATASETS = {
    "P12": dict(d_inp=36, d_static=9, max_len=215, n_classes=2, static=True),
    "P19": dict(d_inp=34, d_static=6, max_len=60, n_classes=2, static=True),
    "eICU": dict(d_inp=14, d_static=399, max_len=300, n_classes=2, static=True),
    "PAM": dict(d_inp=17, d_static=0, max_len=600, n_classes=8, static=False),
}


def dataset_config(name: str, **overrides) -> RaindropConfig:
    """Build the published per-dataset model config."""
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; options: {sorted(DATASETS)}")
    kw = dict(DATASETS[name])
    kw.update(overrides)
    return RaindropConfig(**kw)
