"""Training diagnostics (the port of raindrop_tpu/utils/diagnostics.py):
profiler traces, the NaN guard, the frozen-parameter report, throughput,
and the FLOPs and MFU accounting.

  * `profile_trace` records a scope with torch.profiler and writes a
    Chrome trace to a directory;
  * `nan_guard` counts non-finite elements per parameter path, on the host;
  * `debug_nan_context` turns on autograd's anomaly detection for a scope
    (slow; for debugging);
  * `Throughput` keeps samples/s (and edges/s);
  * `counted_flops` counts the model FLOPs of a call: PyTorch's
    FlopCounterMode for every matmul it sees, plus what the hand-written
    kernels credit for their launches (kernels/build.flop_credit), which
    the counter cannot see. A kernel credits the plain version's matmul
    work at the unpadded shape, a backward twice its forward and no
    recompute (the MFU convention), and only when it launched, so the
    credit follows the encoder rung that really ran;
  * `device_peak_flops` and `mfu`: achieved model FLOP/s over the card's
    dense bf16 tensor-core peak. The JAX package's compile cache has no
    counterpart: the kernels' build cache (kernels/build.py) serves that
    need.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import torch

from raindrop_tpu_torch.kernels import build
from raindrop_tpu_torch.train.checkpoint import flatten_params

# Dense bf16 tensor-core peak FLOP/s by the name torch.cuda.get_device_name
# gives, from NVIDIA's data sheets. H100 SXM5 (80 GB HBM3, 700 W): 989.4
# TFLOP/s dense bf16 (1978.9 with 2:4 sparsity, which nothing here uses).
# A card that is not listed gets no peak and no MFU: nothing is guessed.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the scope (CPU, and CUDA where present) and write a Chrome
    trace, `trace.json`, into `logdir`; view it in chrome://tracing or
    Perfetto. Yields the profiler (its key_averages() for a table)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def nan_guard(tree, name: str = "tree", raise_error: bool = True
              ) -> Dict[str, int]:
    """{path: non-finite element count} over the floating-point leaves of a
    parameter tree (or one tensor, path ""), on the host. Raises
    FloatingPointError when any is found and `raise_error`."""
    leaves = (flatten_params(tree) if isinstance(tree, dict)
              else [("", tree)])
    bad = {}
    for path, leaf in leaves:
        t = torch.as_tensor(leaf).detach()
        if t.is_floating_point():
            n = int(t.numel() - torch.isfinite(t).sum().item())
            if n:
                bad[path] = n
    if bad and raise_error:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
    return bad


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


@contextlib.contextmanager
def debug_nan_context() -> Iterator[None]:
    """autograd's anomaly detection inside the scope: a backward that makes
    a NaN raises, naming the forward op (slow; for debugging)."""
    with torch.autograd.detect_anomaly():
        yield


def counted_flops(fn, *args, **kwargs) -> float:
    """The model FLOPs of one call fn(*args, **kwargs) (the counterpart of
    the JAX package's compiled_flops): FlopCounterMode's count of the
    matmuls PyTorch ran, plus the FLOPs the hand-written kernels credited
    for their launches. fn runs for real; to count a training step, fn
    runs the forward and the backward. The kernels' credit is process-wide
    (kernels/build.flop_credit), so nothing else may launch kernels while
    fn runs: one trainer's count, as Trainer.step_flops takes it."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with build.flop_credit() as credited, counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops()) + credited[0]


def device_peak_flops(device) -> Optional[float]:
    """The dense bf16 tensor-core peak of a CUDA device (PEAK_BF16_FLOPS);
    None for the CPU or a card not in the table."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(device))


def mfu(flops_per_sec: Optional[float],
        peak_flops: Optional[float]) -> Optional[float]:
    """Model FLOPs utilization: achieved model FLOP/s over the peak; None
    where either is unknown."""
    if flops_per_sec is None or not peak_flops:
        return None
    return flops_per_sec / peak_flops


class Throughput:
    """Rolling samples/s and edges/s counters. edges_per_sample: 2 F^2
    for the shipped 2-layer complete-graph model."""

    def __init__(self, edges_per_sample: Optional[int] = None):
        self.edges_per_sample = edges_per_sample
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._samples = 0

    def update(self, n_samples: int) -> None:
        self._samples += n_samples

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def summary(self) -> Dict[str, float]:
        dt = max(self.elapsed, 1e-9)
        out = {"samples_per_sec": self._samples / dt, "elapsed_s": dt}
        if self.edges_per_sample:
            out["edges_per_sec"] = self._samples * self.edges_per_sample / dt
        return out

