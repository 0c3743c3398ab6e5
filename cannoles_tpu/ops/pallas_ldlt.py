"""Pallas (Triton) kernel: fused batched LDLᵀ factor + solve for small KKT
systems, the hot kernel of the vmapped-instance regime (``vsolve``).

One launch factors a (B, N, N) batch of quasi-definite KKT matrices, solves
``W x = rhs`` for each and returns the raw pivots (the caller's inertia
signal, solver_types.jl:90-96 semantics).  The plain path
(:mod:`cannoles_tpu.ops.ldlt` under ``jax.vmap``) runs the elimination as a
device loop of small XLA kernels, so the (B, N, N) batch makes a round trip
through device memory on every column; here each program keeps its matrices
in registers through all N elimination steps.

Layout, written for the GPU's block model:

* the batch goes on the grid: each program owns ``TB`` instances, a
  (TB, Np, Np) block with N padded to the power of two Np (padded rows and
  columns are identity, padded instances are identity matrices, so both
  factor cleanly and are sliced off);
* small N packs several instances into one program so the block has ~2K
  elements; from Np = 32 on one instance per program, spread over its warps;
* the elimination is a ``lax.fori_loop`` over the column index k (a device
  loop, so compile time does not grow with N).  Column k is read with a
  masked reduction, the trailing rank-1 update is applied to the whole block
  (entries at or above k are untouched because the L column is zero there),
  and forward substitution rides along in the same loop.  After the loop the
  strict lower triangle holds ``L·D`` and the diagonal holds the pivots, so
  backward substitution is a second loop over rows of that block.

Breakdown handling is branch-free and matches :mod:`cannoles_tpu.ops.ldlt`:
a pivot with |d| ≤ eig_tol is skipped (its L column is zeroed) and recorded
raw, so the caller's inertia test fails and its ρ ladder retries.  Only the
lower triangle of W is read.

Platform choice happens at lowering (:func:`jax.lax.platform_dependent`):
the compiled Triton kernel on CUDA, the Pallas interpreter on CPU (tests),
and an error anywhere else.  :func:`fused_ldlt_solve` is a
``jax.custom_batching.custom_vmap``: unbatched calls stay on the plain jnp
path, and under ``vmap`` the batch lands on the kernel for
``N ≤ KERNEL_MAX_N`` and on the vmapped plain path above it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .ldlt import ldlt_factor, ldlt_solve

__all__ = [
    "fused_ldlt_solve",
    "batched_ldlt_solve_pallas",
    "kernel_block",
    "use_kernel",
    "KERNEL_MAX_N",
]

# Largest KKT size the batched dispatch sends to the kernel: one instance is
# a (128, 128) f32 block per program.
KERNEL_MAX_N = 128

# Elements of one program's block; small matrices pack several instances.
_BLOCK_ELEMS = 2048

# Warps per program: four measured fastest at every N from 5 to 128 against
# 8 and 16 (benchmarks/ldlt_kernel_study.py --warps).
_NUM_WARPS = 4


def kernel_block(N: int):
    """``(Np, TB)`` for KKT size N: the padded size and the instances per
    program."""
    Np = max(2, 1 << (N - 1).bit_length())
    return Np, max(1, min(128, _BLOCK_ELEMS // (Np * Np)))


def use_kernel(N: int) -> bool:
    """True when a vmapped KKT of size N goes to the kernel."""
    return 1 <= N <= KERNEL_MAX_N


def _fused_kernel(W_ref, rhs_ref, x_ref, d_ref, *, n: int, eig_tol: float):
    """One program: factor + solve its TB instances.

    W_ref: (TB, Np, Np) symmetric input (lower triangle read);
    rhs_ref: (TB, Np); x_ref: (TB, Np) solution; d_ref: (TB, Np) raw pivots.
    """
    W = W_ref[...]
    y = rhs_ref[...]
    Np = W.shape[-1]
    ri = lax.broadcasted_iota(jnp.int32, (1, Np, 1), 1)
    ci = lax.broadcasted_iota(jnp.int32, (1, 1, Np), 2)
    vi = lax.broadcasted_iota(jnp.int32, (1, Np), 1)
    zero = jnp.zeros((), W.dtype)

    def _inv(d):
        ok = jnp.abs(d) > eig_tol
        return jnp.where(ok, 1.0 / jnp.where(ok, d, 1.0), zero)

    def factor_step(k, carry):
        W, y = carry
        colk = jnp.sum(jnp.where(ci == k, W, zero), axis=2)  # W[:, k]
        dk = jnp.sum(jnp.where(vi == k, colk, zero), axis=1, keepdims=True)
        lcol = jnp.where(vi > k, colk * _inv(dk), zero)  # L[:, k], strict
        # (l_i l_j) d is bitwise symmetric, so W stays symmetric
        W = W - (lcol[:, :, None] * lcol[:, None, :]) * dk[:, :, None]
        yk = jnp.sum(jnp.where(vi == k, y, zero), axis=1, keepdims=True)
        return W, y - lcol * yk

    W, y = lax.fori_loop(0, n, factor_step, (W, y))
    # W now holds L·D below the diagonal and the raw pivots on it
    d = jnp.sum(jnp.where(ri == ci, W, zero), axis=2)
    dinv = _inv(d)

    def back_step(t, z):
        k = n - 1 - t
        rowk = jnp.sum(jnp.where(ri == k, W, zero), axis=1)  # W[k, :]
        xk = jnp.sum(jnp.where(vi == k, z, zero), axis=1, keepdims=True)
        return z - jnp.where(vi < k, rowk * dinv, zero) * xk

    x_ref[...] = lax.fori_loop(0, n, back_step, y * dinv)
    d_ref[...] = d


@functools.lru_cache(maxsize=None)
def _build_call(n: int, Bp: int, eig_tol: float, dtype_str: str, interpret: bool):
    Np, TB = kernel_block(n)
    dtype = jnp.dtype(dtype_str)
    vec = pl.BlockSpec((TB, Np), lambda i: (i, 0))
    return pl.pallas_call(
        functools.partial(_fused_kernel, n=n, eig_tol=eig_tol),
        grid=(Bp // TB,),
        in_specs=[pl.BlockSpec((TB, Np, Np), lambda i: (i, 0, 0)), vec],
        out_specs=[vec, vec],
        out_shape=[jax.ShapeDtypeStruct((Bp, Np), dtype)] * 2,
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name=f"fused_ldlt_n{n}",
    )


def _pad(W, rhs):
    """Pad the batch to a multiple of TB and N to Np with identity blocks."""
    B, N, _ = W.shape
    Np, TB = kernel_block(N)
    Bp = -(-B // TB) * TB
    Wp = jnp.pad(W, ((0, Bp - B), (0, Np - N), (0, Np - N)))
    i = jnp.arange(Np)
    pad_diag = (jnp.arange(Bp)[:, None] >= B) | (i[None, :] >= N)  # (Bp, Np)
    Wp = Wp + jnp.where(pad_diag[:, :, None] & (i[:, None] == i[None, :]), 1.0, 0.0).astype(W.dtype)
    rp = jnp.pad(rhs, ((0, Bp - B), (0, Np - N)))
    return Wp, rp


def _run(W, rhs, eig_tol, *, interpret: bool):
    B, N, _ = W.shape
    Wp, rp = _pad(W, rhs)
    call = _build_call(N, Wp.shape[0], float(eig_tol), str(W.dtype), interpret)
    x, d = call(Wp, rp)
    return x[:B, :N], d[:B, :N]


def batched_ldlt_solve_pallas(W, rhs, eig_tol: float):
    """Batched fused factor + solve.  W: (B, N, N), rhs: (B, N) →
    (x (B, N), d (B, N)).  Compiled Triton on CUDA, interpreted on CPU."""
    return lax.platform_dependent(
        W, rhs,
        cuda=functools.partial(_run, eig_tol=eig_tol, interpret=False),
        cpu=functools.partial(_run, eig_tol=eig_tol, interpret=True),
    )


@functools.lru_cache(maxsize=None)
def _make_fused(eig_tol: float, nb: int):
    def one(W, rhs):
        fac = ldlt_factor(W, eig_tol, nb=nb)
        return ldlt_solve(fac, rhs, eig_tol), fac.vec

    @jax.custom_batching.custom_vmap
    def fused(W, rhs):
        return one(W, rhs)

    @fused.def_vmap
    def _rule(axis_size, in_batched, W, rhs):
        W_b, rhs_b = in_batched
        if not W_b:
            W = jnp.broadcast_to(W, (axis_size,) + W.shape)
        if not rhs_b:
            rhs = jnp.broadcast_to(rhs, (axis_size,) + rhs.shape)
        if use_kernel(W.shape[-1]):
            x, d = batched_ldlt_solve_pallas(W, rhs, eig_tol)
        else:
            x, d = jax.vmap(one)(W, rhs)
        return (x, d), (True, True)

    return fused


def fused_ldlt_solve(W, rhs, eig_tol: float, nb: int = 32):
    """Solve W x = rhs via unpivoted LDLᵀ, returning (x, pivots).

    Scalar calls run the blocked jnp path; under vmap (the vsolve batch
    regime) the custom_vmap rule sends the whole batch to the kernel when
    :func:`use_kernel` says so."""
    return _make_fused(float(eig_tol), int(nb))(W, rhs)
