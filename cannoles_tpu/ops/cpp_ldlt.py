"""ctypes bindings for the native C++ LDLᵀ host backend.

The shared library (``native/ldlt.cpp``) is compiled on demand with g++ and
cached next to the source.  Exposed to the jitted solver through
``jax.pure_callback`` (a host round-trip — this is the debugging / CPU
fallback seam, the analog of the reference's MA57 escape hatch, not the
device hot path)."""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["cpp_available", "cpp_ldlt_factor_solve", "native_lib_path"]

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_SRC = _NATIVE_DIR / "ldlt.cpp"
_LIB = _NATIVE_DIR / "libcannoles_ldlt.so"


def native_lib_path() -> pathlib.Path:
    return _LIB


def _build() -> None:
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
        str(_SRC), "-o", str(_LIB),
    ]
    subprocess.run(cmd, check=True, capture_output=True)


@lru_cache(maxsize=1)
def _load():
    if (not _LIB.exists()) or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        _build()
    lib = ctypes.CDLL(str(_LIB))
    lib.cannoles_ldlt_factor_solve.restype = ctypes.c_int
    lib.cannoles_ldlt_factor_solve.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.cannoles_ldlt_factor_solve_batch.restype = None
    lib.cannoles_ldlt_factor_solve_batch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def cpp_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _solve_host(W: np.ndarray, rhs: np.ndarray, nvar: int, eig_tol: float):
    """Host numpy implementation entry.  Handles an optional leading batch
    dim (from vmap's pure_callback batching)."""
    lib = _load()
    W = np.ascontiguousarray(W, dtype=np.float64)
    rhs = np.ascontiguousarray(rhs, dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    if W.ndim == 2:
        n = W.shape[0]
        x = np.zeros(n)
        d = np.zeros(n)
        ok = lib.cannoles_ldlt_factor_solve(
            n, nvar, eig_tol,
            W.ctypes.data_as(dp), rhs.ctypes.data_as(dp),
            x.ctypes.data_as(dp), d.ctypes.data_as(dp),
        )
        return x, d, np.bool_(ok != 0)
    B, n, _ = W.shape
    x = np.zeros((B, n))
    d = np.zeros((B, n))
    ok = np.zeros(B, dtype=np.int32)
    lib.cannoles_ldlt_factor_solve_batch(
        B, n, nvar, eig_tol,
        W.ctypes.data_as(dp), rhs.ctypes.data_as(dp),
        x.ctypes.data_as(dp), d.ctypes.data_as(dp),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return x, d, ok != 0


def cpp_ldlt_factor_solve(W, rhs, nvar: int, eig_tol: float):
    """jit-compatible fused factor+solve on the host CPU.

    Returns (x, success) with x = W⁻¹ rhs (zeros if inertia failed)."""
    n = W.shape[-1]
    dtype = W.dtype

    def cb(Wh, rh):
        x, d, ok = _solve_host(np.asarray(Wh), np.asarray(rh), nvar, eig_tol)
        return x.astype(dtype), np.asarray(ok)

    x, ok = jax.pure_callback(
        cb,
        (
            jax.ShapeDtypeStruct(W.shape[:-1], dtype),
            jax.ShapeDtypeStruct(W.shape[:-2], jnp.bool_),
        ),
        W,
        rhs,
        vmap_method="broadcast_all",
    )
    return x, ok
