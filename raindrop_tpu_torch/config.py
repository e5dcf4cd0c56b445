"""Model configuration for the PyTorch port.

Its own copy of `raindrop_tpu/config.py`'s `RaindropConfig`, `DATASETS` and
`dataset_config`: every field with the same default, so a config serialised
by the JAX package (`to_json`) loads here unchanged. The port imports
nothing of the JAX package. `TrainConfig` comes with the training slice.
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
    # graph-propagation backend: the port serves 'auto' (the dense
    # complete-graph path); 'coo' and 'pallas' come with later slices
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
