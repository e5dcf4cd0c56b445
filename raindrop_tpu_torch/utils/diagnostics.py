"""Training diagnostics (of raindrop_tpu/utils/diagnostics.py, the part
the per-split protocol reads). The profiler hooks, the NaN guard and the
FLOPs / MFU accounting come with the diagnostics slice.
"""

from __future__ import annotations

from typing import List

import torch

from raindrop_tpu_torch.train.checkpoint import flatten_params


def frozen_param_report(old_params, new_params) -> List[str]:
    """Paths of the parameters that did not change between two trees (the
    reference GRU-D script's 'Not updated in <name>' diagnostic): the cheap
    way to catch dead parameters, a broken optimizer mask or a detached
    path. For Raindrop a non-empty report is expected: the model carries
    parameters its forward never reads (models/raindrop.raindrop_param_mask).
    """
    new = dict(flatten_params(new_params))
    return [path for path, a in flatten_params(old_params)
            if a.shape == new[path].shape
            and torch.equal(a.detach().cpu(), new[path].detach().cpu())]
