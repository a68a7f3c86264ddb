"""ctypes bindings for the native PCG core (twin of `flexflow_tpu/native.py`).

The C++ source is the repo root's `native/src/pcg_core.cc`, shared with the
JAX package. The port compiles it with g++ into `flexflow_tpu_torch/_build/`
(listed in .gitignore), apart from the JAX package's `native/build/`, on
first use: into a temporary file, then renamed over the library, so two
processes building at once never load a half-written file. The library is
rebuilt when the source is newer. Every entry point has a pure-Python
fallback (in its caller) for a host without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "src" / "pcg_core.cc"
_LIB_PATH = Path(__file__).resolve().parent / "_build" / "libpcg_core.so"

_lib = None
_lib_tried = False


def _build() -> Path:
    if (_LIB_PATH.exists()
            and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime):
        return _LIB_PATH
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    subprocess.run([cxx, "-O2", "-std=c++17", "-fPIC", "-Wall", "-shared",
                    "-o", str(tmp), str(_SRC)], check=True,
                   capture_output=True)
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.ff_topo_order.restype = ctypes.c_int
        lib.ff_topo_order.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                      i32p, i32p, i32p]
        lib.ff_bottlenecks.restype = ctypes.c_int
        lib.ff_bottlenecks.argtypes = lib.ff_topo_order.argtypes
        lib.ff_eval_makespan.restype = ctypes.c_double
        lib.ff_eval_makespan.argtypes = [
            ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32, i32p, i32p]
        lib.ff_eval_makespan_axes.restype = ctypes.c_double
        lib.ff_eval_makespan_axes.argtypes = [
            ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), i32p,
            ctypes.c_int32, i32p, i32p]
        _lib = lib
    except (OSError, subprocess.CalledProcessError, AttributeError):
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _as_i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64(a):
    a = np.ascontiguousarray(a, np.float64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def bottlenecks(n: int, src, dst) -> Optional[np.ndarray]:
    """Mask of the nodes (in topological index) every source-to-sink path
    crosses; None without the library."""
    lib = _load()
    if lib is None:
        return None
    src, dst = _as_i32(src), _as_i32(dst)
    mask = np.zeros(n, np.int32)
    rc = lib.ff_bottlenecks(n, len(src), _ptr(src), _ptr(dst), _ptr(mask))
    return mask.astype(bool) if rc >= 0 else None


def eval_makespan(compute, comm, src, dst) -> Optional[float]:
    """max(sum(compute), longest path of compute + comm); None without the
    library, ValueError on a cyclic graph."""
    lib = _load()
    if lib is None:
        return None
    co, cop = _f64(compute)
    _, cmp_ = _f64(comm)
    src, dst = _as_i32(src), _as_i32(dst)
    out = lib.ff_eval_makespan(len(co), cop, cmp_, len(src), _ptr(src),
                               _ptr(dst))
    if out < 0:
        raise ValueError("eval_makespan: graph has a cycle")
    return float(out)


def eval_makespan_axes(compute, comm, axis, src, dst) -> Optional[float]:
    """`eval_makespan` with a per-axis link-occupancy bound: comm on the
    same mesh axis (`axis[i]`, an int id, -1 none) serializes. None
    without the library, ValueError on a cyclic graph."""
    lib = _load()
    if lib is None:
        return None
    co, cop = _f64(compute)
    _, cmp_ = _f64(comm)
    ax = _as_i32(axis)
    src, dst = _as_i32(src), _as_i32(dst)
    out = lib.ff_eval_makespan_axes(len(co), cop, cmp_, _ptr(ax), len(src),
                                    _ptr(src), _ptr(dst))
    if out < 0:
        raise ValueError("eval_makespan_axes: graph has a cycle")
    return float(out)
