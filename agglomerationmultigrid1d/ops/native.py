"""ctypes bindings for the native setup kernels (``native/aggmg_native.cpp``).

The reference leans on native LAPACK/UMFPACK through Julia for its setup
factorizations (SURVEY §2.9); our host-side setup equivalents (batched tiny
inverses, block-tridiagonal products) get the same treatment: a small C++
library loaded via ctypes, with transparent NumPy fallbacks when it cannot be
built.  The library is compiled on first use on the machine that runs it, into
``native/build/`` under a name keyed by the source, the compile flags, the
architecture and the host CPU, so a binary built elsewhere is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_LIB = None
_LOCK = threading.Lock()
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC_PATH = os.path.join(_REPO_ROOT, "native", "aggmg_native.cpp")
_FLAGS = ["-O3", "-shared", "-fPIC"]


def _so_path() -> str:
    from .. import _cpu_fingerprint

    h = hashlib.sha1(" ".join(_FLAGS).encode())
    with open(_SRC_PATH, "rb") as f:
        h.update(f.read())
    key = f"{platform.machine()}-{_cpu_fingerprint()}-{h.hexdigest()[:12]}"
    return os.path.join(_REPO_ROOT, "native", "build", f"libaggmg_native-{key}.so")


def _try_build(so_path: str) -> bool:
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", *_FLAGS, _SRC_PATH, "-o", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, so_path)  # atomic: concurrent test workers may race
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if os.environ.get("AGGMG_NO_NATIVE"):
            _LIB = False
            return _LIB
        if not os.path.exists(_SRC_PATH):
            _LIB = False
            return _LIB
        so_path = _so_path()
        if not os.path.exists(so_path) and not _try_build(so_path):
            _LIB = False
            return _LIB
        try:
            lib = ctypes.CDLL(so_path)
            lib.aggmg_batched_inv.restype = ctypes.c_int64
            lib.aggmg_batched_inv.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ]
            lib.aggmg_batched_matmul.restype = None
            lib.aggmg_batched_matmul.argtypes = [ctypes.POINTER(ctypes.c_double)] * 3 + [
                ctypes.c_int64, ctypes.c_int64,
            ]
            lib.aggmg_bt_mul_bt.restype = None
            lib.aggmg_bt_mul_bt.argtypes = [ctypes.POINTER(ctypes.c_double)] * 9 + [
                ctypes.c_int64, ctypes.c_int64,
            ]
            _LIB = lib
        except OSError:
            _LIB = False
    return _LIB


def have_native() -> bool:
    return bool(_load())


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def batched_inv(blocks: np.ndarray) -> np.ndarray:
    """Inverse of every ``(bs, bs)`` block in a ``(n, bs, bs)`` f64 stack."""
    blocks = np.ascontiguousarray(blocks, dtype=np.float64)
    lib = _load()
    if not lib:
        return np.linalg.inv(blocks)
    out = blocks.copy()
    n, bs, _ = out.shape
    failures = lib.aggmg_batched_inv(_dptr(out), n, bs)
    if failures:
        raise np.linalg.LinAlgError(f"{failures} singular blocks in batched_inv")
    return out


def batched_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    lib = _load()
    if not lib:
        return a @ b
    out = np.empty_like(a)
    n, bs, _ = a.shape
    lib.aggmg_batched_matmul(_dptr(a), _dptr(b), _dptr(out), n, bs)
    return out
