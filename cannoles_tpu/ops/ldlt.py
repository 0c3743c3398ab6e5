"""Dense blocked LDLᵀ factorization with inertia, jit/vmap-native.

Dense replacement for the reference's sparse symmetric-indefinite
factorizations (HSL MA57 and LDLFactorizations.jl,
``/root/reference/src/solver_types.jl``).  Design notes:

* The KKT matrices of this solver are **symmetric quasi-definite** once the
  regularizers are active (rho > 0 on the (1,1) block, -delta < 0 on the (3,3)
  block), so a fixed-order (unpivoted) LDLᵀ is stable in the Vanderbei sense —
  the same property the pure-Julia backend relies on (LDLFactorizations does no
  numerical pivoting either).  The algorithm *starts* at rho = 0 and detects
  failure through the **inertia of D**, exactly like the reference backend
  (`solver_types.jl:90-96`): success ⇔ exactly ``nvar`` pivots > eig_tol and no
  pivot with |d| ≤ eig_tol.

* Breakdown handling is branch-free: a pivot with |d| ≤ eig_tol is *skipped*
  (its elimination column is zeroed) so the factorization finishes with finite
  numbers; the raw pivot is still recorded, so the inertia test fails and the
  caller's rho-bump loop retries — the jittable analog of "factorization
  failed, increase regularization" (`CaNNOLeS.jl:1029-1047`).

* The factorization is *blocked*: panels of ``nb`` columns are eliminated with
  a fori_loop of skinny rank-1 updates (VPU work), and the trailing submatrix
  is updated with one matmul per panel — the O(N³) bulk — which XLA maps onto
  a dense matmul kernel.  Everything vmaps, so a (B, N, N) batch of KKT systems factorizes as
  batched matmuls.

* A dense symmetric-eigendecomposition backend (``eigh``) provides exact
  inertia and a rank-revealing solve — the robustness analog of MA57's pivoted
  factorization — and is the debugging/fallback seam mirroring the reference's
  two-backend design (`CaNNOLeS.jl:317-332`).
"""

from __future__ import annotations


from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular

__all__ = [
    "Factorization",
    "ldlt_factor",
    "ldlt_solve",
    "eigh_factor",
    "eigh_solve",
    "factorize",
    "factor_solve",
    "inertia_success",
]


class Factorization(NamedTuple):
    """Either (L, d) for LDLᵀ or (V, w) for eigh — both (N,N) + (N,)."""

    mat: jax.Array  # L (unit lower) or V (orthogonal)
    vec: jax.Array  # d (pivots)     or w (eigenvalues)


def _panel_factor(P: jax.Array, eig_tol: float) -> Tuple[jax.Array, jax.Array]:
    """Eliminate one (R, nb) panel column-by-column.

    Rows 0..nb-1 of P are the diagonal block.  Returns the unit-lower panel of
    L (R, nb) and the nb raw pivots.
    """
    R, nb = P.shape
    rows = jnp.arange(R)[:, None]  # (R,1)
    cols = jnp.arange(nb)[None, :]  # (1,nb)
    rows1 = rows[:, 0]
    cols1 = cols[0, :]

    def body(k, carry):
        P, Lp, d = carry
        dk = P[k, k]
        ok = jnp.abs(dk) > eig_tol
        inv = jnp.where(ok, 1.0 / jnp.where(ok, dk, 1.0), 0.0)
        col = jnp.where(rows1 > k, P[:, k] * inv, 0.0)  # skipped pivot ⇒ zero col
        Lp = Lp.at[:, k].set(col + (rows1 == k).astype(P.dtype))
        d = d.at[k].set(dk)
        head = jnp.where(cols1 > k, col[:nb], 0.0)  # L values at diag-block rows
        P = P - dk * col[:, None] * head[None, :]
        return P, Lp, d

    # zeros_like (not fresh zeros) keeps P's varying-manual-axes type so the
    # carry is vma-consistent under shard_map
    P, Lp, d = lax.fori_loop(
        0, nb, body, (P, jnp.zeros_like(P), jnp.zeros_like(P, shape=(nb,)))
    )
    return Lp, d


def _ldlt_factor_looped(A: jax.Array, eig_tol: float, nb: int) -> Factorization:
    """Compile-light blocked LDLᵀ for large N: a single ``lax.fori_loop``
    over uniform nb-wide panels (N padded to a multiple of nb), with the
    working matrix held in place (strict L below the diagonal, pivots on the
    diagonal).  Same pivot-skip semantics as the static-loop version; the
    trailing update is one masked (N, nb)x(nb, N) matmul per panel.

    The static-loop variant unrolls O(N/nb) panels into the graph — at
    N ≈ 1000 that cost ~5 min of XLA compile; this version's graph is one
    panel body."""
    N0 = A.shape[-1]
    dtype = A.dtype
    N = -(-N0 // nb) * nb
    if N != N0:
        # pad with identity so the extra pivots are 1 (ignored by caller)
        P = jnp.eye(N, dtype=dtype)
        A = P.at[:N0, :N0].set(A)
    rows = jnp.arange(N)

    def panel_body(k, M):
        j0 = k * nb

        def col_body(t, carry):
            M, j0 = carry
            j = j0 + t
            col = lax.dynamic_slice_in_dim(M, j, 1, axis=1)[:, 0]  # (N,)
            dj = col[j]
            ok = jnp.abs(dj) > eig_tol
            inv = jnp.where(ok, 1.0 / jnp.where(ok, dj, 1.0), 0.0)
            lcol = jnp.where(rows > j, col * inv, 0.0)
            # write strict L column + keep the pivot on the diagonal
            newcol = lcol + jnp.where(rows == j, dj, 0.0)
            M = lax.dynamic_update_slice_in_dim(M, newcol[:, None], j, axis=1)
            # rank-1 update of the remaining columns of this panel only:
            # columns j+1 .. j0+nb-1.  Use a full-width masked outer product
            # (columns outside the panel are updated later by the panel's
            # trailing matmul).
            colmask = (rows > j) & (rows < j0 + nb)
            M = M - dj * lcol[:, None] * jnp.where(colmask, lcol, 0.0)[None, :]
            return M, j0

        M, _ = lax.fori_loop(0, nb, col_body, (M, j0))
        # trailing update: B = strict-L rows below the panel
        panel = lax.dynamic_slice(M, (0, j0), (N, nb))  # (N, nb)
        j1 = j0 + nb
        B = jnp.where(rows[:, None] >= j1, panel, 0.0)
        dpan = jnp.diagonal(lax.dynamic_slice(M, (j0, j0), (nb, nb)))
        M = M - jnp.matmul(B, (B * dpan[None, :]).T, precision="highest")
        return M

    M = lax.fori_loop(0, N // nb, panel_body, A)
    d = jnp.diagonal(M)
    L = jnp.tril(M, -1) + jnp.eye(N, dtype=dtype)
    if N != N0:
        L = L[:N0, :N0]
        d = d[:N0]
    return Factorization(L, d)


def ldlt_factor(A: jax.Array, eig_tol: float, nb: int = 32) -> Factorization:
    """Unpivoted blocked LDLᵀ of a symmetric (N, N) matrix (lower part used).

    Returns unit-lower L and the raw pivot vector d.  Inertia of A = sign
    pattern of d (when no pivot was skipped).
    """
    N = A.shape[-1]
    dtype = A.dtype
    if N == 0:
        return Factorization(jnp.zeros((0, 0), dtype), jnp.zeros((0,), dtype))
    if N >= 256:
        return _ldlt_factor_looped(A, eig_tol, max(nb, 128))
    nb = max(1, min(nb, N))
    if nb >= N:
        # single panel covers the matrix — no block assembly.  (Also avoids
        # whole-array .at[0:N].set(), which stages a size-0 scatter-index
        # constant that breaks custom_vmap batching inside while_loops.)
        Lp, d = _panel_factor(A, eig_tol)
        return Factorization(Lp, d)
    M = A
    L = jnp.zeros_like(A)
    d = jnp.zeros((N,), dtype=dtype)
    for j0 in range(0, N, nb):  # static loop — N is a trace-time constant
        j1 = min(j0 + nb, N)
        w = j1 - j0
        Lp, dp = _panel_factor(M[j0:N, j0:j1], eig_tol)
        L = L.at[j0:N, j0:j1].set(Lp)
        d = d.at[j0:j1].set(dp)
        if j1 < N:
            Lsub = Lp[w:, :]  # (N-j1, w)
            M = M.at[j1:N, j1:N].add(
                -jnp.matmul(Lsub, (Lsub * dp[None, :]).T, precision="highest")
            )
    return Factorization(L, d)


def ldlt_solve(fac: Factorization, rhs: jax.Array, eig_tol: float) -> jax.Array:
    """Solve A x = rhs given A = L D Lᵀ (only valid when inertia succeeded).

    In float32 one step of iterative refinement is applied: a blocked
    ``triangular_solve`` may trade accuracy for speed in low precision (an
    earlier accelerator backend measured ~100× worse residuals than exact
    substitution at N ≈ 70, enough to flip downstream inertia/convergence
    decisions); the refinement recovers it for two extra triangular solves.
    float64 is left untouched so CPU parity trajectories stay bit-identical
    with the C++ backend."""
    L, d = fac
    ok = jnp.abs(d) > eig_tol
    dinv = jnp.where(ok, 1.0 / jnp.where(ok, d, 1.0), 0.0)

    def solve_once(b):
        y = solve_triangular(L, b, lower=True, unit_diagonal=True)
        y = y * dinv
        return solve_triangular(L.T, y, lower=False, unit_diagonal=True)

    x = solve_once(rhs)
    if jnp.dtype(L.dtype).itemsize < 8:
        # residual through the factorization: r = rhs - L D Lᵀ x
        r = rhs - jnp.matmul(L, d * jnp.matmul(L.T, x, precision="highest"), precision="highest")
        x = x + solve_once(r)
    return x


def eigh_factor(A: jax.Array, eig_tol: float) -> Factorization:
    """Symmetric eigendecomposition backend — exact inertia (MA57-robustness
    analog; reference success test at solver_types.jl:41 counts negative
    eigenvalues of the pivoted LDLᵀ)."""
    w, V = jnp.linalg.eigh(A)
    return Factorization(V, w)


def eigh_solve(fac: Factorization, rhs: jax.Array, eig_tol: float) -> jax.Array:
    V, w = fac
    ok = jnp.abs(w) > eig_tol
    winv = jnp.where(ok, 1.0 / jnp.where(ok, w, 1.0), 0.0)
    return V @ ((V.T @ rhs) * winv)


def inertia_success(vec: jax.Array, mat: jax.Array, nvar: int, eig_tol: float):
    """Reference success criterion (solver_types.jl:90-96): exactly ``nvar``
    pivots/eigenvalues above eig_tol and none within eig_tol of zero, plus a
    finite-ness guard so overflow during unpivoted elimination reads as
    failure (→ rho bump) instead of poisoning the step."""
    pos = jnp.sum(vec > eig_tol)
    zer = jnp.sum(jnp.abs(vec) <= eig_tol)
    finite = jnp.all(jnp.isfinite(vec)) & jnp.all(jnp.isfinite(mat))
    return (pos == nvar) & (zer == 0) & finite


def factorize(A, eig_tol, nvar, backend: str = "ldlt", nb: int = 32):
    """factor + inertia test.  backend ∈ {'ldlt', 'eigh'}."""
    if backend == "eigh":
        fac = eigh_factor(A, eig_tol)
    elif backend == "ldlt":
        fac = ldlt_factor(A, eig_tol, nb=nb)
    else:
        raise ValueError(f"unknown linsolve backend {backend!r}")
    success = inertia_success(fac.vec, fac.mat, nvar, eig_tol)
    return fac, success


def factor_solve(fac: Factorization, rhs, eig_tol, backend: str = "ldlt"):
    if backend == "eigh":
        return eigh_solve(fac, rhs, eig_tol)
    return ldlt_solve(fac, rhs, eig_tol)
