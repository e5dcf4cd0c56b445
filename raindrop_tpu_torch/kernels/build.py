"""Build and load the port's CUDA kernels.

Each library `<name>` is compiled by `nvcc` at first use from
`raindrop_tpu_torch/csrc/<name>.cu` (and, for flash_packed and the fused
layer's two libraries, the units in PARTS, each compiled by its own nvcc
process and linked after) into
`raindrop_tpu_torch/kernels/_build/<name>-<hash>.so` (the hash covers the
sources and every header in csrc/, so an edited source rebuilds) and
loaded with ctypes. The sources have a plain C interface and include no
PyTorch header. Nothing here runs at import time.

Every C entry point returns `cudaGetLastError()` after its launches;
`check` raises if it is not 0. Nothing falls back: a missing `nvcc` or a
failed build raises.

Each wrapper counts its launches (`count_launch`) and, while a FLOP count
is open (`flop_credit`, which utils/diagnostics.counted_flops opens beside
PyTorch's FlopCounterMode), credits the model FLOPs of the call it launched
(`credit`): the counter cannot see into a kernel called through ctypes.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Iterator, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("flash_packed", "fused_encoder", "fused_encoder_bwd", "sparse_graph")
# libraries built from several units: flash_packed's 48 tensor-core
# kernels take nvcc far longer in one process than as three units in
# parallel (chip_ab.py, task one_unit), and its 42 kernels past hd_pad 144
# are three units more, its 12 past head dim 368 one more
# (flash_packed_hds) and its 18 on the tensor cores past it three more
# (flash_packed_{fwd,dq,dkv}_tcc); flash_mha's entry points (flash_split)
# launch the same tensor-core kernels on their own strides, so they are a
# unit of this library too; the fused layer's tensor-core attention kernels
# (18 a family on one warpgroup, 4 on two, and the route past head dim
# 368's 4 a pass) are units of their own the same way, and its libraries
# link the units of the tensor-core route past 368 as they are (its
# attention runs the packed pair's kernels on the rows' strides)
PARTS = {"flash_packed": ("flash_packed", "flash_split", "flash_packed_fwd_tc",
                          "flash_packed_dq_tc", "flash_packed_dkv_tc",
                          "flash_packed_fwd_wide", "flash_packed_dq_wide",
                          "flash_packed_dkv_wide", "flash_packed_hds",
                          "flash_packed_fwd_tcc", "flash_packed_dq_tcc",
                          "flash_packed_dkv_tcc"),
         "fused_encoder": ("fused_encoder", "fused_encoder_attn_tc",
                           "fused_encoder_attn_wide", "fused_encoder_attn_hds",
                           "flash_packed_fwd_tcc"),
         "fused_encoder_bwd": ("fused_encoder_bwd", "fused_encoder_dq_tc",
                               "fused_encoder_dkv_tc", "fused_encoder_dq_wide",
                               "fused_encoder_dkv_wide", "fused_encoder_bwd_hds",
                               "flash_packed_dq_tcc", "flash_packed_dkv_tcc")}

_lock = threading.Lock()          # guards builds and _libs
_count_lock = threading.Lock()    # guards the launch counts and credits
# the totals of the open FLOP counts; global, not per thread, because a
# backward on the card runs on autograd's device thread
_credits: List[List[float]] = []
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _units(name: str):
    return [CSRC / f"{u}.cu" for u in PARTS.get(name, (name,))]


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + _units(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str, started: Dict[Path, tuple]):
    """Start one nvcc process per unit of the library: straight to the
    shared library for one unit, to object files for several (linked in
    _finish_build). `started` maps a unit to its (process, object) for the
    libraries of one build(): a unit that several link compiles once.
    Returns (processes, their outputs, the temporary library, the
    library), or None when it is built already."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    units = _units(name)
    if len(units) == 1:
        return [_nvcc_proc([*NVCC_FLAGS, "-o", str(tmp), str(units[0])])], [tmp], tmp, out
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    for u in units:
        if u not in started:
            o = tmp.with_name(f"{tmp.name}.{u.stem}.o")
            started[u] = (_nvcc_proc([*flags, "-c", "-o", str(o), str(u)]), o)
    return [started[u][0] for u in units], [started[u][1] for u in units], tmp, out


def _nvcc_proc(args):
    return subprocess.Popen([_nvcc(), "-I", str(CSRC), *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish_build(job, logs) -> None:
    """Wait for the job's processes (`logs` keeps each one's output: a unit
    another library shares was read already) and link its objects."""
    if job is None:
        return
    procs, outs, tmp, out = job
    for proc in procs:
        if proc not in logs:
            logs[proc] = proc.communicate()[0]
        log = logs[proc]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    if outs != [tmp]:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, outs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {out.name} failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile the named libraries, all nvcc processes started together."""
    with _lock:
        jobs, started, logs = [], {}, {}
        try:
            for n in names:
                jobs.append(_start_build(n, started))
            for job in jobs:
                _finish_build(job, logs)
        finally:
            for job in filter(None, jobs):
                procs, outs, tmp, _ = job
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                for f in {*outs, tmp}:
                    f.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA error {err} launching {what}")


def count_launch(fn, *attrs: str) -> None:
    """Add one to each named launch count of a wrapper (plain int
    attributes): `launches` for the forward (the default), `bwd_launches`
    for the backward, and any a wrapper keeps per route."""
    with _count_lock:
        for attr in attrs or ("launches",):
            setattr(fn, attr, getattr(fn, attr) + 1)


@contextlib.contextmanager
def flop_credit() -> Iterator[List[float]]:
    """Open a count of the model FLOPs the kernels launched in the scope
    credit; yields a one-element list holding the running total. The count
    is process-wide, not the opening thread's (autograd runs the backward
    on a thread of its own): a kernel another thread launches while it is
    open (a ModelServer's batcher, a second Trainer) is counted too, so
    open it only where one thread drives the card."""
    box = [0.0]
    with _count_lock:
        _credits.append(box)
    try:
        yield box
    finally:
        with _count_lock:
            _credits.remove(box)


def credit(flops: float) -> None:
    """Add `flops` to every open count (`flop_credit`); a wrapper calls it
    after its kernel launched, and only then."""
    with _count_lock:
        for box in _credits:
            box[0] += flops
