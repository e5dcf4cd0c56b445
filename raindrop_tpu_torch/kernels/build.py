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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("flash_packed", "flash_split", "fused_encoder", "fused_encoder_bwd",
           "sparse_graph")
# libraries built from several units: flash_packed's 48 tensor-core
# kernels take nvcc far longer in one process than as three units in
# parallel (chip_ab.py, task one_unit); the fused layer's tensor-core
# attention kernels (18 a family) are units of their own the same way
PARTS = {"flash_packed": ("flash_packed", "flash_packed_fwd_tc",
                          "flash_packed_dq_tc", "flash_packed_dkv_tc"),
         "fused_encoder": ("fused_encoder", "fused_encoder_attn_tc"),
         "fused_encoder_bwd": ("fused_encoder_bwd", "fused_encoder_dq_tc",
                               "fused_encoder_dkv_tc")}

_lock = threading.Lock()          # guards builds and _libs
_count_lock = threading.Lock()    # guards the wrappers' launch counts
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


def _start_build(name: str):
    """Start one nvcc process per unit of the library: straight to the
    shared library for one unit, to object files for several (linked in
    _finish_build). Returns (processes, their outputs, the temporary
    library, the library), or None when it is built already."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    units = _units(name)
    if len(units) == 1:
        outs = [tmp]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                 str(units[0])]]
    else:
        outs = [tmp.with_name(f"{tmp.name}.{u.stem}.o") for u in units]
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        cmds = [[_nvcc(), *flags, "-I", str(CSRC), "-c", "-o", str(o), str(u)]
                for u, o in zip(units, outs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    return procs, outs, tmp, out


def _finish_build(job) -> None:
    if job is None:
        return
    procs, outs, tmp, out = job
    for proc in procs:
        log, _ = proc.communicate()
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
        jobs = []
        try:
            for n in names:
                jobs.append(_start_build(n))
            for job in jobs:
                _finish_build(job)
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


def count_launch(fn, attr: str = "launches") -> None:
    """Add one to a wrapper's launch count (a plain int attribute):
    `launches` for the forward, `bwd_launches` for the backward."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)
