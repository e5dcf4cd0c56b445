"""Baseline model families (port of raindrop_tpu/baselines/; reference
code/baselines/).

Every baseline has the Trainer's pluggable interface through
baselines/adapters.make_baseline: apply(params, src, static, times,
lengths, train, seeds) -> (logits, aux), so each reuses the flagship's data
pipeline, balanced sampler, metrics, 5-split protocol and InferenceServer.
"""

from raindrop_tpu_torch.baselines.transformer import (  # noqa: F401
    transformer2_init,
    transformer2_apply,
)
from raindrop_tpu_torch.baselines.seft import seft_init, seft_apply  # noqa: F401
from raindrop_tpu_torch.baselines.grud import grud_init, grud_apply  # noqa: F401
from raindrop_tpu_torch.baselines.mtand import mtand_init, mtand_apply  # noqa: F401
from raindrop_tpu_torch.baselines.mtgnn import mtgnn_init, mtgnn_apply  # noqa: F401
from raindrop_tpu_torch.baselines.dgm2 import dgm2_init, dgm2_apply  # noqa: F401
from raindrop_tpu_torch.baselines.ipnet import (  # noqa: F401
    ipnet_init,
    ipnet_apply,
    ipnet_reconstruction_loss,
)
