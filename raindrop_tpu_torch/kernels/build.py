"""Build and load the port's CUDA kernels.

Each `raindrop_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` at first use
into `raindrop_tpu_torch/kernels/_build/<name>-<hash>.so` (the hash covers
the source and every header in csrc/, so an edited source rebuilds) and
loaded with ctypes. The sources have a plain C interface and include no
PyTorch header, so a build takes seconds. Nothing here runs at import time.

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


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile the named sources, all nvcc processes started together."""
    with _lock:
        jobs = []
        try:
            for n in names:
                jobs.append(_start_build(n))
            for job in jobs:
                _finish_build(job)
        finally:
            for job in jobs:
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
                    job[1].unlink(missing_ok=True)


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
