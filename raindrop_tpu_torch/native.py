"""The host runtime: the data layer's hot loops in C++/OpenMP, bound with
ctypes (the port of raindrop_tpu/native.py).

The source is the port's own copy, `csrc/host/raindrop_host.cpp`. At the
first call in a checkout it is compiled by `$CXX` (default `g++`) with
HOST_FLAGS (`-O3 -march=native -fopenmp -std=c++17 -fPIC`) to an object
and linked with `-shared` into `kernels/_build/librdhost-<hash>.so`, the
hash covering the source, the compiler and the flags: an edited source or
another compiler gets a new file, and six processes building at once each
write a temporary file and rename it into place. `-march=native` ties the
library to the host that built it; `_build/` is not committed, so every
machine builds its own.

Selection, read at every call as in the JAX package: with
`RAINDROP_TPU_NATIVE=0` the data layer (data/normalize.py,
data/preprocess.py's GRU-D deltas, data/prefetch.py's gathers) runs its
numpy functions, which define the semantics; with any other value, or
none, it runs this library. A build or load that fails raises
RuntimeError with the compiler's output and the variable's name. The JAX
package falls back to numpy quietly when its library cannot be built; the
port does not.

Against numpy: the elementwise functions are bit-identical; `get_stats`
sums with Kahan compensation and agrees to about 1e-13 relative;
`build_delta` runs the recurrence in float64 and rounds once (the port's
float32 torch `baselines/grud.build_delta` differs by up to 2e-6).

The library links the OpenMP runtime torch loads: the libgomp its wheel
carries in `torch/lib` (by path, with an rpath to it), else the
compiler's `-lgomp`. So one OpenMP runtime serves torch's intra-op pool
and these loops, and the link needs no `libgomp.spec` from the compiler
(a g++ without one refuses `-fopenmp` at the link, not at the compile).

Each function counts its calls (`gather_rows.calls`, ...), so a caller can
show that a path ran the C++ functions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from raindrop_tpu_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "host" / "raindrop_host.cpp"
HOST_FLAGS = ["-O3", "-march=native", "-fopenmp", "-std=c++17", "-fPIC"]
ENV = "RAINDROP_TPU_NATIVE"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_i64 = ctypes.c_int64
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_ARGTYPES = {
    "rd_get_stats": [_f64p, _i64, _i64, _f64p, _f64p, ctypes.c_double],
    "rd_mask_normalize": [_f64p, _i64, _i64, _i64, _f64p, _f64p, _f32p],
    "rd_mask_normalize_static": [_f64p, _i64, _i64, _f64p, _f64p, _f32p],
    "rd_build_delta": [_f32p, _f64p, _i64, _i64, _i64, _f32p],
    "rd_zero_sensors": [_f32p, _i64, _i64, _i64, _i64p, _i64],
    "rd_gather_rows": [_f32p, _i64, _i64p, _i64, _f32p],
    "rd_gather_time_major": [_f32p, _i64, _i64, _i64p, _i64, _f32p],
}


def enabled() -> bool:
    """True unless RAINDROP_TPU_NATIVE is "0" (read now, not at import)."""
    return os.environ.get(ENV, "1") != "0"


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def gomp_link() -> List[str]:
    """Link arguments for the OpenMP runtime torch loads: its wheel's
    libgomp by path (and an rpath to it), else `-lgomp`."""
    lib = Path(torch.__file__).resolve().parent / "lib"
    bundled = sorted(lib.glob("libgomp*.so*"))
    if bundled:
        return [str(bundled[0]), f"-Wl,-rpath,{lib}"]
    return ["-lgomp"]


def library_path() -> Path:
    """Where this checkout's library is (or will be) built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([_cxx(), *HOST_FLAGS, *gomp_link()]).encode())
    return Path(build.BUILD_DIR) / f"librdhost-{h.hexdigest()[:16]}.so"


def _run(cmd: List[str]) -> None:
    """Run one compiler command; RuntimeError with its output on failure."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the host runtime failed ({' '.join(cmd)}): {e}; "
                           f"{ENV}=0 runs the numpy functions instead") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the host runtime failed (exit {proc.returncode}, "
            f"{' '.join(cmd)}):\n{proc.stdout}{proc.stderr}\n"
            f"{ENV}=0 runs the numpy functions instead")


def _compile(out: Path) -> None:
    """Compile SOURCE to an object, link it with the OpenMP runtime torch
    loads into a temporary library, and rename that to `out`."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    obj = tmp.with_suffix(".o")
    try:
        _run([_cxx(), *HOST_FLAGS, "-c", "-o", str(obj), str(SOURCE)])
        _run([_cxx(), "-shared", "-o", str(tmp), str(obj), *gomp_link()])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        obj.unlink(missing_ok=True)


def load() -> ctypes.CDLL:
    """The loaded library, built first where this checkout has none."""
    path = library_path()
    key = str(path)
    with _lock:
        lib = _libs.get(key)
        if lib is not None:
            return lib
        if not path.exists():
            _compile(path)
        try:
            lib = ctypes.CDLL(key)
        except OSError as e:
            raise RuntimeError(f"loading the host runtime {path} failed: {e}; "
                               f"{ENV}=0 runs the numpy functions instead") from e
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _libs[key] = lib
        return lib


def _called(fn) -> ctypes.CDLL:
    lib = load()
    with _lock:
        fn.calls += 1
    return lib


def get_stats(P: np.ndarray, eps: float = 1e-7) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sensor mean and std over the strictly positive entries of P
    [N, T, F] or [R, F] (data/normalize.get_stats to about 1e-13)."""
    lib = _called(get_stats)
    flat = np.ascontiguousarray(P.reshape(-1, P.shape[-1]), np.float64)
    R, F = flat.shape
    mf = np.empty(F, np.float64)
    stdf = np.empty(F, np.float64)
    lib.rd_get_stats(flat, R, F, mf, stdf, eps)
    return mf, stdf


def mask_normalize(P: np.ndarray, mf: np.ndarray, stdf: np.ndarray) -> np.ndarray:
    """[N, T, F] -> [N, T, 2F] float32, bit-identical to the numpy
    mask_normalize in float64 cast to float32."""
    lib = _called(mask_normalize)
    P = np.ascontiguousarray(P, np.float64)
    N, T, F = P.shape
    out = np.empty((N, T, 2 * F), np.float32)
    lib.rd_mask_normalize(P, N, T, F, np.ascontiguousarray(mf, np.float64),
                          np.ascontiguousarray(stdf, np.float64), out)
    return out


def mask_normalize_static(Ps: np.ndarray, ms: np.ndarray, ss: np.ndarray) -> np.ndarray:
    """[N, S] -> [N, S] float32, bit-identical to the numpy
    mask_normalize_static cast to float32."""
    lib = _called(mask_normalize_static)
    Ps = np.ascontiguousarray(Ps, np.float64)
    N, S = Ps.shape
    out = np.empty((N, S), np.float32)
    lib.rd_mask_normalize_static(Ps, N, S, np.ascontiguousarray(ms, np.float64),
                                 np.ascontiguousarray(ss, np.float64), out)
    return out


def build_delta(mask: np.ndarray, times: np.ndarray) -> np.ndarray:
    """GRU-D deltas [N, T, F] float32 from the observed mask [N, T, F] and
    the times [N, T] (the recurrence in float64, rounded once)."""
    lib = _called(build_delta)
    mask = np.ascontiguousarray(mask, np.float32)
    N, T, F = mask.shape
    times = np.ascontiguousarray(times, np.float64)
    out = np.empty((N, T, F), np.float32)
    lib.rd_build_delta(mask, times, N, T, F, out)
    return out


def _check_bounds(idx: np.ndarray, n: int) -> None:
    """The C gathers do raw pointer arithmetic: an index out of range would
    read past the array instead of raising as numpy does, so check it."""
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"gather index out of bounds for axis of size {n}: "
                         f"[{int(idx.min())}, {int(idx.max())}]")


def gather_rows(P: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[b] = P[idx[b]] for a float32 array [N, ...] (its rows are the
    flattened trailing dims), in one OpenMP pass."""
    lib = _called(gather_rows)
    P = np.ascontiguousarray(P, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    _check_bounds(idx, P.shape[0])
    rowlen = int(np.prod(P.shape[1:], dtype=np.int64))
    out = np.empty((len(idx),) + P.shape[1:], np.float32)
    lib.rd_gather_rows(P.reshape(P.shape[0], -1), rowlen, idx, len(idx),
                       out.reshape(len(idx), -1))
    return out


def gather_time_major(P: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The gather and the [N, T, C] -> [T, B, C] transpose in one pass."""
    lib = _called(gather_time_major)
    P = np.ascontiguousarray(P, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    N, T, C = P.shape
    _check_bounds(idx, N)
    out = np.empty((T, len(idx), C), np.float32)
    lib.rd_gather_time_major(P, T, C, idx, len(idx), out)
    return out


def zero_sensors(P: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Setting 2 in place on a C-contiguous float32 [N, T, 2F]: the value
    columns `idx` zeroed, the mask columns kept; returns P."""
    if P.dtype != np.float32 or not P.flags.c_contiguous or P.ndim != 3:
        raise ValueError("zero_sensors takes a C-contiguous float32 [N, T, 2F] array")
    idx = np.ascontiguousarray(idx, np.int64)
    N, T, F2 = P.shape
    _check_bounds(idx, F2)
    lib = _called(zero_sensors)
    lib.rd_zero_sensors(P, N, T, F2 // 2, idx, len(idx))
    return P


for _fn in (get_stats, mask_normalize, mask_normalize_static, build_delta,
            gather_rows, gather_time_major, zero_sensors):
    _fn.calls = 0
del _fn
