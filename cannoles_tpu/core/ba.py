"""Camera-Schur bundle-adjustment solver: direct landmark elimination.

The structured large-problem path (VERDICT/BASELINE "structured elimination"
item; capability analog of the reference's sparse-J handling,
``/root/reference/src/CaNNOLeS.jl:259-315``).  For a BA scene with C cameras
and P landmarks on a (C, P) visibility grid — full or partially observed via
a ``data["vis"]`` mask (BAL-style sparse scenes; the mask scales the
per-observation Jacobian blocks, so the algebra sees the true sparse
Jacobian while every contraction stays a dense einsum) — the condensed
Gauss-Newton system

    (rho I + JᵀJ + JcᵀJc/δ) z = b,    x = [cams (C,6); pts (P,3)]

has the classic arrowhead structure

    [U + Dc   W ] [zc]   [bc]        U: (C,6,6) block-diag camera Hessians
    [  Wᵀ     V ] [zp] = [bp],       V: (P,3,3) block-diag landmark Hessians
                                     W: (C,P,6,3) camera-landmark coupling
                                     Dc: gauge-constraint term (cameras only)

Eliminating the landmarks analytically — V is block-diagonal, its inverse is
P independent closed-form 3x3 adjugates (elementwise work) — leaves the reduced
camera system  S = U + Dc − Σₚ W·ₚ Vₚ⁻¹ W·ₚᵀ  of size (6C, 6C): a few
thousand at most, factorized directly with XLA's Cholesky.  Back-substitution
recovers zp.  The O(C²P) Schur product and the per-observation Jacobians are
plain batched einsums — dense matmuls do all the heavy lifting; **no (m, n)
Jacobian is ever materialized** (m = 2CP rows, 245 GB dense at the
100c/10k-pt benchmark scene).

"Factorization success" = positive-definiteness of every landmark block
(Sylvester minors) AND of the reduced camera system (Cholesky pivots) — the
same inertia criterion as the dense 'chol' backend, feeding the inherited
reference rho-bump ladder (CaNNOLeS.jl:1008-1052 schedule).

Everything else — the Orban-Siqueira outer loop, extrapolation + Armijo line
search through jvp/vjp products, the δ schedule, stopping rules, statuses —
is inherited unchanged from :class:`~cannoles_tpu.core.matfree.MatrixFreeSolver`;
only the inner linear solve is replaced (CG → direct Schur).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..params import Params
from ..problem import NLSProblem
from ..utils.linalg import norm_2
from .matfree import MatrixFreeSolver

__all__ = ["SchurBASolver", "inv3x3_sym", "ba_block_jacobi"]


def ba_block_jacobi(n_cams: int, n_pts: int, project: Optional[Callable] = None):
    """Structure-aware block-Jacobi preconditioner factory for the GENERIC
    matrix-free CG engine on BA problems (``MatrixFreeSolver(precond=...)``).

    M = blockdiag(U_c + ρI, V_p + ρI) with U/V the per-camera 6×6 and
    per-landmark 3×3 Gauss–Newton diagonal blocks — the exact diagonal of
    the BA arrowhead, where a scalar (Hutchinson) Jacobi estimate measurably
    fails (the conditioning is camera↔landmark coupling plus per-block depth
    scaling, which the block inverse captures and a noisy scalar diagonal
    does not).  Each application is a batched 3×3 adjugate inverse + a
    batched 6×6 Cholesky solve — pure VPU work, no (m, n) matrix.

    The factory is rebuilt per rho-ladder attempt; its cost (the per-
    observation A/B Jacobian blocks and two einsums) is ~a handful of CG
    iterations' worth of work.

    Assumes the BA layout ``x = [cams (C,6); pts (P,3)]`` with the residual
    a raveled (C, P, 2) reprojection grid of the given ``project`` model —
    validated against the problem dimensions at first application.  Partial
    visibility is supported via a ``data["vis"]`` (C, P) observation mask
    (models/ba_large.py ``visibility=``): masked observations contribute
    nothing to the blocks, matching the masked residual's true Jacobian.  A
    BA problem with a *different* residual layout would get a silently
    mismatched (though still SPD, hence CG-safe) preconditioner — hence the
    dimension check.
    """
    C, P = int(n_cams), int(n_pts)
    if project is None:
        from ..models.ba_large import project_point as project

    def factory(problem, x, data, rho, delta):
        if problem.nvar != 6 * C + 3 * P or problem.nequ != 2 * C * P:
            raise ValueError(
                f"ba_block_jacobi({C}, {P}) expects the BA layout "
                f"nvar=6C+3P={6*C+3*P}, nequ=2CP={2*C*P}; got "
                f"nvar={problem.nvar}, nequ={problem.nequ} — the residual "
                "must be the (possibly vis-masked) raveled (C, P, 2) "
                "reprojection grid"
            )
        cams = x[: 6 * C].reshape(C, 6)
        pts = x[6 * C :].reshape(P, 3)

        def jac_one(cam, pt):
            A = jax.jacfwd(lambda cc: project(cc, pt))(cam)  # (2, 6)
            B = jax.jacfwd(lambda pp: project(cam, pp))(pt)  # (2, 3)
            return A, B

        A, B = jax.vmap(lambda c: jax.vmap(lambda p: jac_one(c, p))(pts))(cams)
        vis = data.get("vis") if isinstance(data, dict) else None
        if vis is not None:
            A = A * vis[..., None, None].astype(A.dtype)
            B = B * vis[..., None, None].astype(B.dtype)
        dtype = x.dtype
        U = jnp.einsum("cpki,cpkj->cij", A, A, precision="highest") + rho * jnp.eye(
            6, dtype=dtype
        )
        V = jnp.einsum("cpki,cpkj->pij", B, B, precision="highest") + rho * jnp.eye(
            3, dtype=dtype
        )
        # landmark blocks: Jacobi-scaled closed-form inverses (same
        # conditioning treatment as SchurBASolver._solve_with_blocks)
        dV = jnp.diagonal(V, axis1=-2, axis2=-1)
        sV = jax.lax.rsqrt(jnp.maximum(dV, 1e-30))
        Vsinv, posV = inv3x3_sym(V * sV[..., :, None] * sV[..., None, :], 0.0)
        Vinv = Vsinv * sV[..., :, None] * sV[..., None, :]
        # camera blocks: batched 6x6 Cholesky (add a tiny floor so M is SPD
        # even when rho = 0 and a camera block is near-singular)
        dU = jnp.diagonal(U, axis1=-2, axis2=-1)
        floor = 1e-10 * jnp.maximum(jnp.max(dU), jnp.asarray(1.0, dtype))
        Lu = jnp.linalg.cholesky(U + floor * jnp.eye(6, dtype=dtype))
        ok_u = jnp.all(jnp.isfinite(Lu))

        def minv(r):
            rc = r[: 6 * C].reshape(C, 6)
            rp = r[6 * C :].reshape(P, 3)
            from jax.scipy.linalg import cho_solve

            zc = jax.vmap(lambda L, b: cho_solve((L, True), b))(Lu, rc)
            zc = jnp.where(ok_u, zc, rc)  # fall back to identity if broken
            # per-block identity fallback keeps M SPD at non-posdef blocks
            zp = jnp.where(
                posV[:, None], jnp.einsum("pij,pj->pi", Vinv, rp), rp
            )
            return jnp.concatenate([zc.reshape(-1), zp.reshape(-1)])

        return minv

    return factory


def inv3x3_sym(V: jax.Array, tol: float):
    """Closed-form inverse of symmetric (..., 3, 3) blocks via adjugates.

    Returns (Vinv, posdef) where posdef is the per-block Sylvester test
    (all three leading principal minors > tol-scaled bounds).  Singular
    blocks get a zeroed inverse (branch-free; the attempt is then failed)."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 1], V[..., 1, 2], V[..., 2, 2]
    cof00 = d * f - e * e
    cof01 = c * e - b * f
    cof02 = b * e - c * d
    det2 = a * d - b * b
    det3 = a * cof00 + b * cof01 + c * cof02
    posdef = (a > tol) & (det2 > tol * a) & (det3 > tol * det2)
    inv_det = jnp.where(posdef, 1.0 / jnp.where(posdef, det3, 1.0), 0.0)
    i00 = cof00
    i01 = cof01
    i02 = cof02
    i11 = a * f - c * c
    i12 = b * c - a * e
    i22 = a * d - b * b
    row0 = jnp.stack([i00, i01, i02], axis=-1)
    row1 = jnp.stack([i01, i11, i12], axis=-1)
    row2 = jnp.stack([i02, i12, i22], axis=-1)
    Vinv = jnp.stack([row0, row1, row2], axis=-2) * inv_det[..., None, None]
    return Vinv, posdef


class SchurBASolver(MatrixFreeSolver):
    """Gauss-Newton/LM bundle-adjustment solver with direct camera-Schur
    landmark elimination.

    Parameters
    ----------
    problem : the BA :class:`NLSProblem` (layout ``[cams (C,6); pts (P,3)]``,
        residual = raveled (C, P, 2) reprojection grid; build with
        :func:`cannoles_tpu.models.ba_large.large_bundle_adjustment`).
    n_cams, n_pts : grid dimensions C, P.
    project : per-observation projection ``(cam (6,), pt (3,)) -> (2,)``
        (default: the pinhole model of models/ba_large.py).  Equality
        constraints, if any, may touch ONLY the camera block (gauge fixing) —
        validated at construction.
    """

    def __init__(
        self,
        problem: NLSProblem,
        n_cams: int,
        n_pts: int,
        *,
        project: Optional[Callable] = None,
        method: str = "gauss_newton",
        frozen_cam_coords=None,
        params: Optional[Params] = None,
        dtype=None,
        **solver_kw,
    ):
        super().__init__(
            problem, method=method, params=params, dtype=dtype, **solver_kw
        )
        self.C, self.P = int(n_cams), int(n_pts)
        if problem.nvar != 6 * self.C + 3 * self.P:
            raise ValueError(
                f"nvar={problem.nvar} != 6*{n_cams} + 3*{n_pts} — not the BA layout"
            )
        if problem.nequ != 2 * self.C * self.P:
            raise ValueError(
                f"nequ={problem.nequ} != 2*C*P — residual must be the "
                "(possibly vis-masked) raveled (C, P, 2) grid"
            )
        if project is None:
            from ..models.ba_large import project_point as project
        self.project = project
        # frozen-gauge camera coordinates (models/ba_large.py gauge="fixed"):
        # the residual freezes these by projection, so their true Jacobian
        # columns are exactly zero — mask the analytically-built A blocks to
        # match (U gains pure rho diagonal there; the step is exactly zero)
        if frozen_cam_coords is not None:
            idx = np.asarray(frozen_cam_coords, dtype=np.int64)
            if idx.size and (idx.min() < 0 or idx.max() >= 6 * self.C):
                raise ValueError("frozen_cam_coords must index the camera block")
            mask = np.ones(6 * self.C, dtype=np.float64)
            mask[idx] = 0.0
            self._cam_mask = jnp.asarray(mask.reshape(self.C, 6))
        else:
            self._cam_mask = None
        if problem.ncon > 0:
            # gauge constraints must not touch landmarks (else the arrowhead
            # elimination is wrong); check the actual Jacobian once at x0
            Jc = np.asarray(problem.Jc(jnp.asarray(problem.x0), problem.data))
            if np.abs(Jc[:, 6 * self.C :]).max() > 0:
                raise ValueError(
                    "SchurBASolver requires constraints on the camera block "
                    "only (gauge fixing); found landmark dependence"
                )

    # ------------------------------------------------------------------
    def _blocks(self, x, data):
        """Per-observation Jacobian blocks and the assembled rho-free
        U₀, V₀, W — everything here is independent of the regularizer, so
        the ρ ladder reuses one computation across all its attempts (the
        A/B builds and the (C,P) einsums are the dominant per-iteration
        cost at production scale)."""
        C, P = self.C, self.P
        cams = x[: 6 * C].reshape(C, 6)
        pts = x[6 * C :].reshape(P, 3)
        proj = self.project

        def jac_one(cam, pt):
            A = jax.jacfwd(lambda cc: proj(cc, pt))(cam)  # (2, 6)
            B = jax.jacfwd(lambda pp: proj(cam, pp))(pt)  # (2, 3)
            return A, B

        A, B = jax.vmap(lambda c: jax.vmap(lambda p: jac_one(c, p))(pts))(cams)
        # A: (C, P, 2, 6); B: (C, P, 2, 3) — all contractions below are dense
        # partial visibility (models/ba_large.py visibility=): the residual
        # is vis ⊙ (proj − obs), so each observation's Jacobian rows carry
        # the same mask — scale A/B and every U/V/W block is exact for the
        # sparse scene while the contractions stay dense grid einsums
        vis = data.get("vis") if isinstance(data, dict) else None
        if vis is not None:
            A = A * vis[..., None, None].astype(A.dtype)
            B = B * vis[..., None, None].astype(B.dtype)
        if self._cam_mask is not None:
            A = A * self._cam_mask.astype(A.dtype)[:, None, None, :]
        U = jnp.einsum("cpki,cpkj->cij", A, A, precision="highest")
        V = jnp.einsum("cpki,cpkj->pij", B, B, precision="highest")
        W = jnp.einsum("cpki,cpkj->cpij", A, B, precision="highest")
        return U, V, W

    def _precompute(self, s):
        """Everything the ρ ladder can share across attempts: the Jacobian
        blocks, the rhs, and the constraint term."""
        pb = self.problem
        C, P = self.C, self.P
        x, data, delta = s.x, s.data, s.delta
        U0, V0, W = self._blocks(x, data)
        bx = s.dual + pb.jtprod_res(x, s.prim_r, data)
        if pb.ncon > 0:
            bx = bx + pb.jtprod_cons(x, s.cx, data) / delta
            Jc = pb.Jc(x, data)[:, : 6 * C]
            Dc = jnp.matmul(Jc.T, Jc, precision="highest") / delta
        else:
            Dc = None
        return U0, V0, W, bx, Dc

    def _newton_system(self, s):
        """Parent rho-ladder (matfree._newton_system) with the expensive
        rho-independent block build hoisted out of the retry loop."""
        pr = self.params
        dtype = self.dtype
        n = self.problem.nvar
        rho_old = s.rho_old
        pre = self._precompute(s)

        from .matfree import _RhoCarry

        # With frozen gauge coordinates (cam_mask) the masked camera columns
        # make the reduced camera system exactly singular at rho = 0 — pure
        # Gauss-Newton is provably rank-deficient there — so the rho = 0
        # attempt can never succeed and would waste one full O(C²P) Schur
        # assembly + factorization per outer iteration; start the ladder at
        # the first regularized rung instead.
        k_shift = 1 if self._cam_mask is not None else 0

        def cond(c):
            return (c.k == 0) | ((~c.success) & (c.rho <= pr.rho_max))

        def body(c):
            first_rho = jnp.where(
                rho_old == 0,
                jnp.asarray(pr.rho0, dtype),
                jnp.maximum(jnp.asarray(pr.rho_min, dtype), pr.kappa_dec * rho_old),
            )
            inc = jnp.where(rho_old == 0, pr.kappa_large_inc, pr.kappa_inc)
            keff = c.k + k_shift
            rho = jnp.where(
                keff == 0,
                jnp.zeros((), dtype),
                jnp.where(keff == 1, first_rho, c.rho * inc),
            )
            do = rho <= pr.rho_max

            def try_f(_):
                return self._solve_with_blocks(s, rho, pre)

            def skip_f(_):
                return c.sol, jnp.zeros((), dtype=bool), jnp.zeros((), jnp.int32)

            sol, success, k = lax.cond(do, try_f, skip_f, None)
            return _RhoCarry(
                c.k + 1, rho, sol, success, c.nfact + do.astype(jnp.int32), c.ncg + k
            )

        out = lax.while_loop(
            cond,
            body,
            _RhoCarry(
                jnp.zeros((), jnp.int32),
                jnp.zeros((), dtype),
                jnp.zeros((n,), dtype),
                jnp.zeros((), dtype=bool),
                jnp.zeros((), jnp.int32),
                jnp.zeros((), jnp.int32),
            ),
        )
        rho_old_new = jnp.where(
            out.rho == 0, rho_old, jnp.where(out.rho <= pr.rho_max, out.rho, rho_old)
        )
        return out.sol, out.success, out.rho, rho_old_new, out.nfact, out.ncg

    def _solve_condensed(self, s, rho):
        """Single-attempt API (tests / parent compatibility): precompute +
        one Schur solve."""
        return self._solve_with_blocks(s, rho, self._precompute(s))

    def _solve_with_blocks(self, s, rho, pre):
        """Direct Schur solve of (rho I + JᵀJ + JcᵀJc/δ) z = b at the current
        iterate given precomputed rho-free blocks.  Returns (zx, ok, 1)."""
        pb, pr = self.problem, self.params
        C, P = self.C, self.P
        x, data, delta = s.x, s.data, s.delta
        dtype = x.dtype
        if self.method == "lm":
            rho = rho + jnp.clip(s.damp, 1e-10, 1e8)

        U0, V0, W, bx, Dc = pre
        eye6 = jnp.eye(6, dtype=dtype)
        eye3 = jnp.eye(3, dtype=dtype)
        U = U0 + rho * eye6
        V = V0 + rho * eye3
        bc = bx[: 6 * C].reshape(C, 6)
        bp = bx[6 * C :].reshape(P, 3)

        # landmark elimination: P independent closed-form 3x3 inverses.
        # Jacobi-scale each block first (D^-1/2 V D^-1/2 has unit diagonal):
        # f32 BA Hessian blocks span ~8 orders of magnitude across depth
        # scales, and the adjugate inverse loses the small pivots without
        # scaling; the posdef minors test also becomes scale-relative.
        dV = jnp.diagonal(V, axis1=-2, axis2=-1)  # (P, 3)
        sV = jax.lax.rsqrt(jnp.maximum(dV, 1e-30))
        Vs = V * sV[..., :, None] * sV[..., None, :]
        Vsinv, posdef = inv3x3_sym(Vs, pr.eig_tol)
        Vinv = Vsinv * sV[..., :, None] * sV[..., None, :]
        X = jnp.einsum("cpij,pjk->cpik", W, Vinv)  # W V⁻¹, (C, P, 6, 3)

        # reduced camera system S = diag(U) + Dc − Σₚ X W ᵀ  (6C, 6C)
        T = jnp.einsum("cpik,dpjk->cidj", X, W, precision="highest")
        S = -T.reshape(6 * C, 6 * C)
        idx = jnp.arange(C)
        S = S.reshape(C, 6, C, 6).at[idx, :, idx, :].add(U).reshape(6 * C, 6 * C)
        if Dc is not None:
            S = S + Dc

        rc = (bc - jnp.einsum("cpij,pj->ci", X, bp)).reshape(6 * C)

        from jax.scipy.linalg import cho_solve

        # Jacobi-scaled camera system (Ceres-style): unit diagonal before
        # Cholesky keeps the f32 factorization honest across camera scales
        # and makes the pivot test relative
        dSd = jnp.diagonal(S)
        sS = jax.lax.rsqrt(jnp.maximum(dSd, 1e-30))
        Ss = S * sS[:, None] * sS[None, :]
        Ls = jnp.linalg.cholesky(Ss)
        dls = jnp.diagonal(Ls)
        okS = jnp.all(jnp.isfinite(Ls)) & jnp.all(dls * dls > pr.eig_tol)

        def schur_solve(bcv, bpv):
            """One arrowhead solve reusing Vinv / X / Ls."""
            rcv = (bcv - jnp.einsum("cpij,pj->ci", X, bpv)).reshape(6 * C)
            zcv = (sS * cho_solve((Ls, True), sS * rcv)).reshape(C, 6)
            wtz = jnp.einsum("cpij,ci->pj", W, zcv)
            zpv = jnp.einsum("pij,pj->pi", Vinv, bpv - wtz)
            return zcv, zpv

        def matvec(v):
            """The exact condensed operator (same as the parent's CG matvec)."""
            out = rho * v + pb.jtprod_res(x, pb.jprod_res(x, v, data), data)
            if pb.ncon > 0:
                out = out + pb.jtprod_cons(x, pb.jprod_cons(x, v, data), data) / delta
            return out

        zc, zp = schur_solve(bc, bp)
        zx = jnp.concatenate([zc.reshape(6 * C), zp.reshape(3 * P)])
        # one pass of operator-level iterative refinement: the closed-form
        # 3x3 adjugate inverses and the f32 einsum chain lose ~3-4 digits on
        # ill-conditioned scenes; the residual correction (2 jvp/vjp pairs +
        # one reused arrowhead back-solve) recovers them
        res = bx - matvec(zx)
        dzc, dzp = schur_solve(res[: 6 * C].reshape(C, 6), res[6 * C :].reshape(P, 3))
        zx = zx + jnp.concatenate([dzc.reshape(6 * C), dzp.reshape(3 * P)])
        zx = zx.astype(dtype)
        # backward-error gate (the dense backend's quality-gate analog): a
        # near-singular landmark block can pass the minors test yet yield an
        # exploding step that refinement cannot repair — demote such
        # attempts to failures so the rho ladder regularizes and retries.
        # Acceptance is the inexact-Newton forcing bound (eta = 0.1), not
        # the tight CG tolerance: at production scale the f32 Schur system's
        # conditioning makes cg_rtol-level residuals unattainable for ANY
        # solver, while an eta-inexact direction is still a provably useful
        # Newton step (Dembo–Eisenstat–Steihaug); garbage steps have
        # relres >~ 1 and are cleanly separated.
        res2 = bx - matvec(zx)
        nb2 = norm_2(bx)
        relres = norm_2(res2) / jnp.where(nb2 > 0, nb2, 1.0)
        eta = jnp.maximum(jnp.asarray(self.cg_rtol * 10, dtype), 0.1)
        ok = (
            jnp.all(posdef)
            & okS
            & jnp.all(jnp.isfinite(zx))
            & (relres <= eta)
        )
        return zx, ok, jnp.ones((), jnp.int32)
