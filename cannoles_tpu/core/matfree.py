"""Matrix-free Gauss–Newton solver for very large NLS problems.

The dense solver (:mod:`cannoles_tpu.core.solver`) carries the (m, n)
Jacobian in its state — the right call in the vmapped small-problem regime,
but an HBM wall once m·n floats stop fitting (m = 10⁷ residuals × n = 10⁵
parameters is a 4 TB Jacobian).  This module removes that wall: **no matrix
is ever materialized**.  Every contraction the Orban–Siqueira outer algorithm
needs is a jvp/vjp product (the `jprod_res`/`jtprod_res`/... surface of
:class:`~cannoles_tpu.problem.NLSProblem`, reference NLPModels
jprod!/jtprod! parity), and the regularized KKT system is solved by CG on the
doubly-condensed SPD system: eliminating the residual block (reference rows
/root/reference/src/CaNNOLeS.jl:304-306) *and* the multiplier block of

    [rho I + JᵀJ   Jcᵀ ]  [zx]   [bx]
    [Jc           -δ I ]  [zl] = [bc]

gives  (rho I + JᵀJ + JcᵀJc/δ) zx = bx + Jcᵀ bc/δ,  which is symmetric
positive definite whenever rho > 0 — so plain CG is the natural inner solver
and *CG convergence replaces the inertia test*: a stagnating CG (singular or
indefinite operator at rho = 0) reads as a failed factorization attempt and
feeds the reference's exact rho-bump schedule (CaNNOLeS.jl:1008-1052).

Gauss–Newton/LM only (zero residual-Hessian block, reference method
:Newton_noFHess / :LM): that is what keeps the operator SPD.  The outer
algorithm — extrapolation first, Armijo line search after, the δ schedule,
the 1%-decrease inner test, and the stopping rules — matches the dense
solver and the reference main loop (CaNNOLeS.jl:612-857).

Memory per iteration: a handful of n- and m-vectors.  Each CG iteration is
one jvp + one vjp through the residual (and constraints), i.e. ~4 residual
evaluations of FLOPs — all dense batched work when the residual is
itself batched (curve fits, reprojection errors, ...).

Scale-out: shard the per-residual `data` leaves over a mesh ('rows' axis);
every m-vector inherits the sharding through the residual evaluation and
every vjp contraction to n inserts one psum — the "annotate shardings, let
XLA place collectives" recipe, with no collective written by hand.
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..params import F_BLOWUP, MAX_DLAMBDA, Params
from ..problem import NLSProblem
from ..utils.linalg import check_nan_inf, norm_1, norm_2, norm_inf
from .solver import RunConfig, _dual_scaling
from .status import MSG, ExecutionStats, Status, get_status_code, status_name

__all__ = ["MatrixFreeSolver", "solve_matfree", "MFState"]


class MFState(NamedTuple):
    """Matrix-free solver state: only vectors, no (m, n) storage."""

    x: jax.Array  # (n,)
    lam: jax.Array  # (p,)
    r: jax.Array  # (m,)
    Fx: jax.Array  # (m,)
    cx: jax.Array  # (p,)
    fx: jax.Array
    dual: jax.Array  # (n,)
    prim_r: jax.Array  # (m,)  = Fx - r
    dx: jax.Array  # (n,)
    dr: jax.Array  # (m,)
    dlam: jax.Array  # (p,)
    normdual: jax.Array
    normprimal: jax.Array
    rho: jax.Array
    rho_old: jax.Array
    damp: jax.Array  # LM damping (applied to the CG operator when method='lm')
    delta: jax.Array
    eta: jax.Array
    epsk: jax.Array
    alpha: jax.Array
    epsF: jax.Array
    epstol: jax.Array
    epsc: jax.Array
    iter: jax.Array
    inner_iter: jax.Array
    neval_F: jax.Array
    neval_c: jax.Array
    nbk: jax.Array
    ncg: jax.Array  # total CG iterations (the nfact analog cost counter)
    nfact: jax.Array  # CG solve attempts (rho ladder trips)
    nlinsolve: jax.Array
    status: jax.Array
    broken: jax.Array
    msg: jax.Array
    first_order: jax.Array
    small_residual: jax.Array
    data: Any = None


class _CGCarry(NamedTuple):
    z: jax.Array
    res: jax.Array
    p: jax.Array
    gamma: jax.Array  # <res, M⁻¹res> (== ‖res‖² when unpreconditioned)
    res2: jax.Array  # ‖res‖² (the stopping quantity, preconditioner-free)
    k: jax.Array


def _cg(matvec: Callable, b: jax.Array, itmax: int, rtol: float, minv=None):
    """(Preconditioned) CG on an SPD operator; returns
    (z, relative residual, iters).

    ``minv``: optional SPD preconditioner application r ↦ M⁻¹r (Jacobi /
    block-Jacobi); None = plain CG.  Convergence is always judged on the TRUE
    residual 2-norm, so the stopping semantics — and the caller's
    "CG converged = factorization succeeded" inertia reading — are identical
    with and without preconditioning.

    Fixed-budget ``lax.while_loop`` — traces once, no host syncs; a
    non-converged or non-finite outcome is reported through the relative
    residual (the caller treats it as a failed factorization attempt)."""
    dtype = b.dtype
    nb = norm_2(b)
    tol2 = (rtol * nb) ** 2
    apply_m = (lambda r: r) if minv is None else minv

    def cond(c: _CGCarry):
        return (c.k < itmax) & (c.res2 > tol2) & jnp.isfinite(c.gamma)

    def body(c: _CGCarry):
        q = matvec(c.p)
        den = jnp.vdot(c.p, q)
        ok = den > 0
        alpha = jnp.where(ok, c.gamma / jnp.where(ok, den, 1.0), 0.0)
        z = c.z + alpha * c.p
        res = c.res - alpha * q
        y = apply_m(res)
        gamma_new = jnp.vdot(res, y)
        beta = jnp.where(c.gamma > 0, gamma_new / jnp.where(c.gamma > 0, c.gamma, 1.0), 0.0)
        p = y + beta * c.p
        # a non-positive-curvature direction = operator not SPD at this rho:
        # freeze with gamma = inf so the attempt reads as failed
        gamma_next = jnp.where(ok, gamma_new, jnp.asarray(jnp.inf, dtype))
        return _CGCarry(z, res, p, gamma_next, jnp.vdot(res, res), c.k + 1)

    y0 = apply_m(b)
    init = _CGCarry(
        jnp.zeros_like(b), b, y0, jnp.vdot(b, y0), jnp.vdot(b, b),
        jnp.zeros((), jnp.int32),
    )
    out = lax.while_loop(cond, body, init)
    denom = jnp.where(nb > 0, nb, 1.0)
    relres = jnp.sqrt(jnp.abs(out.res2)) / denom
    relres = jnp.where(jnp.isfinite(out.gamma), relres, jnp.asarray(jnp.inf, dtype))
    return out.z, relres, out.k


class _RhoCarry(NamedTuple):
    k: jax.Array
    rho: jax.Array
    sol: jax.Array
    success: jax.Array
    nfact: jax.Array
    ncg: jax.Array


class MatrixFreeSolver:
    """Gauss–Newton/LM matrix-free solver (one large problem per call).

    Options
    -------
    cg_maxiter : CG budget per attempt (default min(n + p, 500)).
    cg_rtol    : CG relative-residual target; non-convergence = failed
                 attempt → rho bump (default eps^0.45, ~3e-8 in f64).
    precond    : 'none' (default) | 'jacobi' | callable.  The reference
                 needs no preconditioner — its sparse LDLᵀ is a direct solve
                 (solver_types.jl) — but this engine's CG budget is the
                 entire per-step cost of the large regime, so a
                 preconditioner seam is first-class here:

                 * 'jacobi' equilibrates the smooth block rho + JᵀJ with a
                   diagonal estimated by ``precond_probes`` Hutchinson
                   probes (Bekas–Kokiopoulou–Saad: E[z ∘ Az] over Rademacher
                   z; each probe costs one operator application).  Measured
                   ≥10× total-CG cut on ill-COLUMN-SCALED fits — but it can
                   *hurt* structure-dominated operators (a 3c/12p BA scene
                   measurably stalls: the noisy scalar diagonal distorts a
                   spectrum whose conditioning is off-diagonal coupling, not
                   scaling), hence NOT the default.
                 * callable ``(problem, x, data, rho, delta) -> (r ↦ M⁻¹r)``
                   supplies a structure-aware preconditioner rebuilt at each
                   attempt — e.g. :func:`cannoles_tpu.core.ba.ba_block_jacobi`
                   (per-camera 6×6 / per-landmark 3×3 block-Jacobi).
    precond_probes : Hutchinson probes per 'jacobi' estimate (default 8).
    """

    def __init__(
        self,
        problem: NLSProblem,
        *,
        method: str = "gauss_newton",
        cg_maxiter: Optional[int] = None,
        cg_rtol: Optional[float] = None,
        precond="none",
        precond_probes: int = 8,
        use_initial_multiplier: bool = False,
        always_accept_extrapolation: bool = False,
        multiplier_refit: bool = False,
        params: Optional[Params] = None,
        dtype=None,
    ):
        if method not in ("gauss_newton", "lm", "Newton_noFHess", "LM"):
            raise ValueError(
                "matrix-free mode is Gauss–Newton/LM only (zero residual-"
                "Hessian block keeps the condensed operator SPD); got "
                f"method={method!r}"
            )
        # 'lm' here is REAL Levenberg damping: the CG operator gains a
        # clamp(damp)·I term with damp adapted by the Ared/Pred ratio — the
        # isotropic variant of the reference's commented-out LM diagonal
        # (/root/reference/src/CaNNOLeS.jl:922-940, `Λ = ones(nvar) *
        # max(1e-10, min(1e8, damp))`).  The dense solver keeps the
        # reference's shipped behavior (damping tracked but applied only with
        # lm_damping=True); here damping is always applied, otherwise
        # method='lm' would silently alias 'gauss_newton'.
        self.method = "lm" if method in ("lm", "LM") else "gauss_newton"
        self.problem = problem
        self.dtype = jnp.dtype(dtype) if dtype is not None else jnp.asarray(problem.x0).dtype
        if not jnp.issubdtype(self.dtype, jnp.floating):
            self.dtype = jnp.dtype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        self.params = params or Params.for_dtype(self.dtype)
        n, p = problem.nvar, problem.ncon
        self.cg_maxiter = int(cg_maxiter) if cg_maxiter is not None else min(n + p, 500)
        eps = float(jnp.finfo(self.dtype).eps)
        self.cg_rtol = float(cg_rtol) if cg_rtol is not None else eps**0.45
        if not callable(precond) and precond not in ("jacobi", "none"):
            raise ValueError(
                f"precond must be 'jacobi', 'none' or a callable, got {precond!r}"
            )
        self.precond = precond
        self.precond_probes = int(precond_probes)
        # reference kwargs (CaNNOLeS.jl:423-425), dense-solver parity
        self.use_initial_multiplier = bool(use_initial_multiplier)
        self.always_accept_extrapolation = bool(always_accept_extrapolation)
        # Per-outer-iteration CGLS multiplier refit (Armand 2012 estimator,
        # the same least-squares estimate the reference computes at init and
        # inside optimality_check_small_residual, CaNNOLeS.jl:507-518,
        # :866-897 — here applied every outer iteration).  Opt-in extension:
        # the aug-Lagrangian first-order update λ ← λ − c/δ converges the
        # dual only at rate ~c/δ per iteration, and on gauge-constrained BA
        # the measured consequence is a λ excursion that takes >100
        # iterations to walk back (RESULTS.md gauge study); the refit
        # replaces the walk with the optimal least-squares multiplier at
        # each accepted iterate (p extra CG iterations on Jc Jcᵀ per outer).
        self.multiplier_refit = bool(multiplier_refit)
        self._init_fn = jax.jit(self._init_state)
        self._outer_fn = jax.jit(self._outer_step)
        self._run_fn = jax.jit(self._run_compiled)

    # ---------------- operator pieces (all matrix-free) ----------------
    def _dual_at(self, x, r, lam, data):
        pb = self.problem
        g = pb.jtprod_res(x, r, data)
        if pb.ncon > 0:
            g = g - pb.jtprod_cons(x, lam, data)
        return g

    def _lam_cgls(self, x, b, data, itmax):
        """λ = argmin ‖Jc(x)ᵀ λ − b‖ by CGLS on operators (Armand 2012,
        reference CaNNOLeS.jl:507-518) — CG on Jc Jcᵀ λ = Jc b."""
        pb = self.problem

        def matvec(v):
            return pb.jprod_cons(x, pb.jtprod_cons(x, v, data), data)

        rhs = pb.jprod_cons(x, b, data)
        lam, _, _ = _cg(matvec, rhs, itmax, self.cg_rtol)
        return lam

    def _jacobi_minv(self, resvec, rho, n, dtype):
        """Diagonal (Jacobi) preconditioner for the SMOOTH block rho + J'J
        only: diag estimated by Hutchinson probes (E[z ∘ Az] over Rademacher
        z), clamped positive so M stays SPD even where the estimate's
        variance bites or a column is unused.

        The constraint term JcᵀJc/δ is deliberately EXCLUDED from M: it is a
        rank-p (huge, ~1/δ) perturbation whose spectral effect CG already
        neutralizes in ~p extra iterations (p well-separated outlier
        eigenvalues); folding its diagonal into M instead smears the 1/δ
        scale across the preconditioned spectrum and measurably stalls CG on
        constrained problems (observed: a 5000×16 + 1 equality fit goes from
        converging to max_eval when Jc'Jc/δ enters the diagonal)."""
        Z = jax.random.rademacher(
            jax.random.PRNGKey(0), (self.precond_probes, n), dtype=dtype
        )
        est = jnp.mean(jax.vmap(lambda z: z * resvec(z))(Z), axis=0)
        floor = 1e-10 * jnp.maximum(jnp.max(est), jnp.asarray(1.0, dtype))
        d = jnp.maximum(est, floor) + rho
        return lambda r: r / d

    def _solve_condensed(self, s: MFState, rho):
        """One (P)CG attempt on ((rho+λ_LM) I + JᵀJ + JcᵀJc/δ) zx =
        bx + Jcᵀbc/δ at the current iterate; returns (zx, converged, iters).
        λ_LM = clamp(damp) for method='lm', zero for Gauss–Newton."""
        pb = self.problem
        n = pb.nvar
        x, data, delta = s.x, s.data, s.delta
        if self.method == "lm":
            rho = rho + jnp.clip(s.damp, 1e-10, 1e8)

        def resvec(v):
            return pb.jtprod_res(x, pb.jprod_res(x, v, data), data)

        def matvec(v):
            out = rho * v + resvec(v)
            if pb.ncon > 0:
                out = out + pb.jtprod_cons(x, pb.jprod_cons(x, v, data), data) / delta
            return out

        bx = s.dual + pb.jtprod_res(x, s.prim_r, data)
        if pb.ncon > 0:
            bx = bx + pb.jtprod_cons(x, s.cx, data) / delta
        if callable(self.precond):
            minv = self.precond(pb, x, data, rho, delta)
        elif self.precond == "jacobi":
            minv = self._jacobi_minv(resvec, rho, n, bx.dtype)
        else:
            minv = None
        zx, relres, k = _cg(matvec, bx, self.cg_maxiter, self.cg_rtol, minv=minv)
        return zx, (relres <= self.cg_rtol) & jnp.all(jnp.isfinite(zx)), k

    def _newton_system(self, s: MFState):
        """The reference rho schedule (CaNNOLeS.jl:1008-1052) with "CG
        converged" standing in for "factorization succeeded with correct
        inertia"."""
        pr = self.params
        dtype = self.dtype
        n = self.problem.nvar
        rho_old = s.rho_old

        def cond(c: _RhoCarry):
            return (c.k == 0) | ((~c.success) & (c.rho <= pr.rho_max))

        def body(c: _RhoCarry):
            first_rho = jnp.where(
                rho_old == 0,
                jnp.asarray(pr.rho0, dtype),
                jnp.maximum(jnp.asarray(pr.rho_min, dtype), pr.kappa_dec * rho_old),
            )
            inc = jnp.where(rho_old == 0, pr.kappa_large_inc, pr.kappa_inc)
            rho = jnp.where(
                c.k == 0,
                jnp.zeros((), dtype),
                jnp.where(c.k == 1, first_rho, c.rho * inc),
            )
            do = rho <= pr.rho_max

            def try_f(_):
                return self._solve_condensed(s, rho)

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

    def _merit(self, Fx, cx, lam, eta):
        val = 0.5 * jnp.vdot(Fx, Fx)
        if self.problem.ncon > 0:
            val = val - jnp.vdot(lam, cx) + 0.5 * eta * jnp.vdot(cx, cx)
        return val

    # ---------------- init (reference CaNNOLeS.jl:447-557) ----------------
    def _init_state(self, x0, lam0, cfg: RunConfig, data=None) -> MFState:
        pb = self.problem
        n, m, p = pb.nvar, pb.nequ, pb.ncon
        dtype = self.dtype
        x = jnp.asarray(x0, dtype=dtype)
        lam = jnp.asarray(lam0, dtype=dtype)

        Fx = pb.F(x, data)
        broken = check_nan_inf(Fx)
        fx = 0.5 * jnp.vdot(Fx, Fx)
        cx = pb.c_shifted(x, data)
        r = Fx
        Jxtr = pb.jtprod_res(x, r, data)
        if p > 0 and not self.use_initial_multiplier:
            lam_ls = self._lam_cgls(x, Jxtr, data, itmax=min(n + p, 200))
            lam = jnp.where(norm_2(lam_ls) == 0, jnp.ones((p,), dtype=dtype), lam_ls)
        dual = Jxtr - (pb.jtprod_cons(x, lam, data) if p > 0 else 0.0)
        prim_r = Fx - r
        normdual = norm_inf(dual)
        normprimal = jnp.maximum(norm_inf(prim_r), norm_inf(cx) if p > 0 else 0.0)

        epsF = cfg.Fatol + cfg.Frtol * 2 * jnp.sqrt(fx)
        epstol = cfg.atol + cfg.rtol * normdual
        epsc = jnp.sqrt(epstol)
        small_residual = (2 * jnp.sqrt(fx) <= epsF) & (norm_2(cx) <= epsc)
        sd = _dual_scaling(lam, p, dtype)
        first_order = jnp.maximum(normdual / sd, normprimal) <= epstol

        s = MFState(
            x=x, lam=lam, r=r, Fx=Fx, cx=cx, fx=fx, dual=dual, prim_r=prim_r,
            dx=jnp.zeros((n,), dtype), dr=jnp.zeros((m,), dtype),
            dlam=jnp.zeros((p,), dtype),
            normdual=normdual, normprimal=normprimal,
            rho=jnp.zeros((), dtype), rho_old=jnp.zeros((), dtype),
            damp=jnp.ones((), dtype),
            delta=jnp.ones((), dtype),
            eta=jnp.asarray(1.0 if p > 0 else 0.0, dtype),
            epsk=jnp.asarray(1e3, dtype),
            alpha=jnp.zeros((), dtype),
            epsF=epsF, epstol=epstol, epsc=epsc,
            iter=jnp.zeros((), jnp.int32), inner_iter=jnp.zeros((), jnp.int32),
            neval_F=jnp.ones((), jnp.int32),
            neval_c=jnp.asarray(1 if p > 0 else 0, jnp.int32),
            nbk=jnp.zeros((), jnp.int32), ncg=jnp.zeros((), jnp.int32),
            nfact=jnp.zeros((), jnp.int32), nlinsolve=jnp.zeros((), jnp.int32),
            status=jnp.zeros((), jnp.int32), broken=broken,
            msg=jnp.zeros((), jnp.int32),
            first_order=first_order, small_residual=small_residual, data=data,
        )
        status = get_status_code(
            optimal=s.first_order, small_residual=s.small_residual, broken=s.broken,
            evals=s.neval_F + s.neval_c, max_eval=cfg.max_eval,
        )
        return s._replace(status=status)

    # ---------------- one outer iteration ----------------
    def _outer_step(self, s: MFState, cfg: RunConfig) -> MFState:
        pb, pr = self.problem, self.params
        n, m, p = pb.nvar, pb.nequ, pb.ncon
        dtype = self.dtype
        data = s.data

        combined = s.normdual + s.normprimal
        delta0 = jnp.maximum(
            jnp.asarray(pr.delta_min, dtype), jnp.minimum(cfg.delta_dec * s.delta, combined)
        )
        s = s._replace(
            delta=delta0,
            damp=jnp.ones((), dtype),
            inner_iter=jnp.zeros((), jnp.int32),
        )

        def solve_system(s: MFState) -> MFState:
            zx, success, rho, rho_old, nfacti, ncgi = self._newton_system(s)
            dx = -zx
            # recover eliminated blocks (condensed-path conventions,
            # core/solver.py solve_system): dr = prim_r + J dx;
            # zl = (Jc zx - bc)/δ with bc = cx, dλ = -zl
            dr = s.prim_r + pb.jprod_res(s.x, dx, data)
            if p > 0:
                dlam = -(pb.jprod_cons(s.x, zx, data) - s.cx) / s.delta
            else:
                dlam = s.dlam
            bad = check_nan_inf(dx)
            blowup = s.fx >= min(F_BLOWUP, float(jnp.finfo(dtype).max))
            broken = (rho > pr.rho_max) | (~success) | bad | blowup
            msg = jnp.where(
                rho > pr.rho_max, 1, jnp.where(~success, 2, jnp.where(bad, 3, jnp.where(blowup, 4, 0)))
            ).astype(jnp.int32)
            return s._replace(
                dx=dx, dr=dr, dlam=dlam, rho=rho, rho_old=rho_old,
                nfact=s.nfact + nfacti, ncg=s.ncg + ncgi,
                nlinsolve=s.nlinsolve + 1,
                broken=s.broken | broken, msg=jnp.where(s.msg == 0, msg, s.msg),
            )

        def trial_step(s: MFState):
            is_extrap = s.inner_iter == 0
            dx, dr = s.dx, s.dr
            epsk = jnp.where(
                is_extrap,
                jnp.maximum(jnp.minimum(jnp.asarray(1e3, dtype) * s.delta, 0.99 * s.epsk), 0.9 * s.epsk),
                s.epsk,
            )
            eta_ls = jnp.asarray(1.0, dtype) / s.delta if p > 0 else s.eta
            JxtFx = pb.jtprod_res(s.x, s.Fx, data)
            if p > 0:
                w = s.lam - s.cx / s.delta
                Dphi = jnp.vdot(JxtFx, dx) - jnp.vdot(dx, pb.jtprod_cons(s.x, w, data))
            else:
                Dphi = jnp.vdot(JxtFx, dx)
            not_descent = (Dphi >= 0) & (~is_extrap)
            phix = self._merit(s.Fx, s.cx, s.lam, eta_ls)
            gammaA = jnp.asarray(pr.gamma_A, dtype)
            eps2 = jnp.asarray(float(jnp.finfo(dtype).eps) ** 2, dtype)

            xt0 = s.x + dx
            Ft0 = pb.F(xt0, data)
            ct0 = pb.c_shifted(xt0, data)
            phit0 = self._merit(Ft0, ct0, s.lam, eta_ls)

            def ls_cond(c):
                alpha, xt, Ft, ct, phit, nbk, fail = c
                need = phit > phix + gammaA * alpha * Dphi
                return need & (~fail) & (~not_descent) & (~is_extrap)

            def ls_body(c):
                alpha, xt, Ft, ct, phit, nbk, fail = c
                alpha = alpha / 4
                xt = s.x + alpha * dx
                Ft = pb.F(xt, data)
                ct = pb.c_shifted(xt, data)
                phit = self._merit(Ft, ct, s.lam, eta_ls)
                return (alpha, xt, Ft, ct, phit, nbk + 1, alpha < eps2)

            alpha, xt, Ft, ct, phit, nbk, fail = lax.while_loop(
                ls_cond, ls_body,
                (jnp.ones((), dtype), xt0, Ft0, ct0, phit0,
                 jnp.zeros((), jnp.int32), jnp.zeros((), dtype=bool)),
            )

            ndl = norm_2(s.dlam)
            Mdl = jnp.asarray(MAX_DLAMBDA, dtype)
            dlam = jnp.where(
                is_extrap & (ndl > Mdl), s.dlam * (Mdl / jnp.where(ndl > 0, ndl, 1.0)), s.dlam
            )
            rt = jnp.where(is_extrap, s.r + dr, Ft)
            if p > 0:
                lamt = jnp.where(is_extrap, s.lam + dlam, s.lam - s.cx / s.delta)
            else:
                lamt = s.lam
            alpha_out = jnp.where(is_extrap, jnp.zeros((), dtype), alpha)
            eta = jnp.where(is_extrap, s.eta, eta_ls)
            nF_add = 1 + nbk
            nc_add = (1 + nbk) if p > 0 else jnp.zeros((), jnp.int32)
            ls_broken = not_descent | fail
            ls_msg = jnp.where(not_descent, 5, jnp.where(fail, 6, 0)).astype(jnp.int32)
            return (xt, rt, lamt, Ft, ct, alpha_out, eta, epsk, dlam,
                    nbk, nF_add, jnp.asarray(nc_add, jnp.int32), ls_broken, ls_msg)

        class Carry(NamedTuple):
            s: MFState
            ndh: jax.Array
            nph: jax.Array
            ch: jax.Array
            first: jax.Array
            tired: jax.Array

        def inner_cond(c: Carry):
            conv = (c.ch <= 0.99 * combined + c.s.epsk) | c.tired
            return (c.first | ~conv) & (~c.s.broken)

        def inner_body(c: Carry) -> Carry:
            s = c.s
            # post-extrapolation skip quirk (:627)
            do_solve = (s.inner_iter != 1) | self.always_accept_extrapolation
            s = lax.cond(do_solve, solve_system, lambda s: s, s)

            def when_broken(_):
                return Carry(s, c.ndh, c.nph, c.ch, jnp.zeros((), dtype=bool), c.tired)

            def when_ok(_):
                (xt, rt, lamt, Ft, ct, alpha, eta, epsk, dlam,
                 nbk_add, nF_add, nc_add, ls_broken, ls_msg) = trial_step(s)

                damp = s.damp
                if self.method == "lm":
                    # Ared/Pred ratio steers the applied Levenberg damping
                    # (reference CaNNOLeS.jl:705-713; one extra jvp per inner
                    # iteration)
                    nF2 = jnp.vdot(s.Fx, s.Fx)
                    Ared = nF2 - jnp.vdot(Ft, Ft)
                    step_a = jnp.where(alpha == 0, jnp.ones((), dtype), alpha)
                    pred_vec = s.Fx + step_a * pb.jprod_res(s.x, s.dx, data)
                    Pred = nF2 - jnp.vdot(pred_vec, pred_vec)
                    ratio = Ared / Pred
                    damp = jnp.where(
                        ratio > 0.75, damp / 10, jnp.where(ratio < 0.25, damp * 10, damp)
                    )

                prim_r_hat = Ft - rt
                dual_hat = self._dual_at(xt, rt, lamt, data)
                ndh = norm_inf(dual_hat)
                nph = jnp.maximum(norm_inf(prim_r_hat), norm_inf(ct) if p > 0 else 0.0)
                ch = ndh + nph
                good = (ch <= 0.99 * combined + epsk) & (~ls_broken)
                accept = (
                    (s.inner_iter > 0) | self.always_accept_extrapolation | good
                ) & (~ls_broken)

                x_n = jnp.where(accept, xt, s.x)
                r_n = jnp.where(accept, rt, s.r)
                Fx_n = jnp.where(accept, Ft, s.Fx)
                fx_n = jnp.where(accept, 0.5 * jnp.vdot(Ft, Ft), s.fx)
                cx_n = jnp.where(accept, ct, s.cx)
                lam_n = jnp.where(good, lamt, s.lam)
                dual_n = jnp.where(
                    good, dual_hat, self._dual_at(x_n, r_n, s.lam, data)
                )
                delta_n = s.delta
                if p > 0:
                    dec = (
                        (s.inner_iter > 0)
                        & (ndh <= 0.99 * s.normdual + epsk / 2)
                        & (nph > 0.99 * s.normprimal + epsk / 2)
                    )
                    delta_n = jnp.where(
                        dec, jnp.maximum(s.delta / 10, jnp.asarray(pr.delta_min, dtype)), s.delta
                    )
                inner_n = s.inner_iter + 1
                neF = s.neval_F + nF_add
                nec = s.neval_c + nc_add
                tired = ((neF + nec) > cfg.max_eval) | (inner_n > cfg.max_inner)
                s_n = s._replace(
                    x=x_n, r=r_n, Fx=Fx_n, fx=fx_n, cx=cx_n, lam=lam_n,
                    dual=dual_n, prim_r=jnp.where(accept, prim_r_hat, s.prim_r),
                    dlam=dlam, eta=eta, epsk=epsk, alpha=alpha, damp=damp,
                    delta=delta_n,
                    inner_iter=inner_n, neval_F=neF, neval_c=nec,
                    nbk=s.nbk + nbk_add, broken=s.broken | ls_broken,
                    msg=jnp.where(s.msg == 0, ls_msg, s.msg),
                )
                return Carry(s_n, ndh, nph, ch, jnp.zeros((), dtype=bool), tired)

            return lax.cond(s.broken, when_broken, when_ok, None)

        c = lax.while_loop(
            inner_cond,
            inner_body,
            Carry(
                s, s.normdual, s.normprimal, jnp.asarray(jnp.inf, dtype),
                jnp.ones((), dtype=bool), (s.neval_F + s.neval_c) > cfg.max_eval,
            ),
        )
        s = c.s._replace(normdual=c.ndh, normprimal=c.nph)

        if self.multiplier_refit and p > 0:
            lam_fit = self._lam_cgls(
                s.x, pb.jtprod_res(s.x, s.r, data), data, itmax=min(n + p, 200)
            )
            dual_fit = self._dual_at(s.x, s.r, lam_fit, data)
            nd_fit = norm_inf(dual_fit)
            # keep the refit only where it strictly improves the dual
            take = nd_fit < s.normdual
            s = s._replace(
                lam=jnp.where(take, lam_fit, s.lam),
                dual=jnp.where(take, dual_fit, s.dual),
                normdual=jnp.where(take, nd_fit, s.normdual),
            )

        sd = _dual_scaling(s.lam, p, dtype)
        first_order = jnp.maximum(s.normdual / sd, s.normprimal) <= s.epstol
        small_residual = (2 * jnp.sqrt(s.fx) <= s.epsF) & (norm_2(s.cx) <= s.epsc)

        def recheck(s):
            # small-residual optimality recheck (CaNNOLeS.jl:866-897),
            # operators instead of matrices
            r = s.Fx
            Jxtr = pb.jtprod_res(s.x, r, data)
            if p > 0:
                lam = self._lam_cgls(s.x, Jxtr, data, itmax=min(n + p, 200))
                dual = Jxtr - pb.jtprod_cons(s.x, lam, data)
            else:
                lam, dual = s.lam, Jxtr
            nd = norm_inf(dual)
            npr = norm_inf(s.cx) if p > 0 else jnp.zeros((), dtype)
            sd2 = _dual_scaling(lam, p, dtype)
            fo = jnp.maximum(nd / sd2, npr) <= s.epstol
            return s._replace(
                r=r, lam=lam, dual=dual, prim_r=s.Fx - r,
                normdual=nd, normprimal=npr, first_order=fo,
            )

        s = s._replace(first_order=first_order, small_residual=small_residual)
        s = lax.cond(small_residual & ~first_order, recheck, lambda s: s, s)

        iter_n = s.iter + 1
        status = get_status_code(
            optimal=s.first_order, small_residual=s.small_residual, broken=s.broken,
            evals=s.neval_F + s.neval_c, max_eval=cfg.max_eval,
            iter_=iter_n, max_iter=cfg.max_iter,
            stalled=(s.inner_iter > cfg.max_inner) & (cfg.max_inner >= 0),
        )
        return s._replace(iter=iter_n, status=status)

    def _run_compiled(self, x0, lam0, cfg: RunConfig, data=None) -> MFState:
        s = self._init_state(x0, lam0, cfg, data)
        return lax.while_loop(
            lambda s: s.status == Status.UNKNOWN,
            lambda s: self._outer_step(s, cfg),
            s,
        )

    def make_config(self, **kw) -> RunConfig:
        # same numeric-knob surface as the dense solver
        from .solver import CaNNOLeSSolver

        return CaNNOLeSSolver.make_config(self, **kw)

    def solve(
        self,
        x0=None,
        lam0=None,
        *,
        callback: Optional[Callable] = None,
        max_time: float = 300.0,
        verbose: int = 0,
        resume_from: Optional[MFState] = None,
        **numeric,
    ) -> ExecutionStats:
        pb = self.problem
        pb.validate_for_solve()
        t0 = time.time()
        x0 = pb.x0 if x0 is None else x0
        lam0 = pb.y0 if lam0 is None else lam0
        cfg = self.make_config(**numeric)
        stats = ExecutionStats()
        stats.status = "unknown"
        if resume_from is not None:
            # checkpoint/resume for the long-running engines: continue a
            # saved run — tolerances ride the state, so the stopping
            # criteria are preserved across sessions (dense-solver parity,
            # core/solver.py solve(resume_from=)).  Explicit tolerance
            # kwargs RE-TARGET from the current iterate (continuation).
            state = resume_from._replace(status=jnp.zeros((), jnp.int32))
            if {"atol", "rtol", "Fatol", "Frtol"} & numeric.keys():
                epstol = cfg.atol + cfg.rtol * state.normdual
                epsF = cfg.Fatol + cfg.Frtol * 2 * jnp.sqrt(state.fx)
                state = state._replace(
                    epstol=epstol, epsF=epsF, epsc=jnp.sqrt(epstol)
                )
        else:
            state = self._init_fn(x0, lam0, cfg, pb.data)
        self._sync(state, stats, time.time() - t0)
        if callback is not None:
            callback(pb, state, stats)
        while stats.status == "unknown":
            state = self._outer_fn(state, cfg)
            elapsed = time.time() - t0
            self._sync(state, stats, elapsed)
            if stats.status == "unknown" and elapsed > max_time:
                stats.status = status_name(Status.MAX_TIME)
            if verbose > 0 and stats.iter % max(verbose, 1) == 0:
                print(
                    f"iter={stats.iter:4d} f={stats.objective:.6e} "
                    f"‖∇L‖={stats.dual_feas:.2e} ‖c‖={stats.primal_feas:.2e} "
                    f"cg_iters={int(state.ncg)}"
                )
            if callback is not None:
                callback(pb, state, stats)
        stats.solver_specific.update(
            nbk=int(state.nbk), nfact=int(state.nfact), ncg=int(state.ncg),
            nlinsolve=int(state.nlinsolve), internal_msg=MSG[int(state.msg)],
            neval_residual=int(state.neval_F), neval_cons=int(state.neval_c),
        )
        self.last_state = state
        pb.counters.neval_residual += int(state.neval_F)
        pb.counters.neval_cons += int(state.neval_c)
        return stats

    def _sync(self, s: MFState, stats: ExecutionStats, elapsed: float):
        code = int(s.status)
        if stats.status != "user":
            stats.status = status_name(code)
        stats.iter = int(s.iter)
        stats.elapsed_time = elapsed
        stats.objective = float(s.fx)
        stats.dual_feas = float(s.normdual)
        stats.primal_feas = float(norm_2(s.cx))
        stats.solution = np.asarray(s.x)
        stats.multipliers = np.asarray(s.lam)


def solve_matfree(
    problem: NLSProblem,
    *,
    x=None,
    lam=None,
    method: str = "gauss_newton",
    cg_maxiter: Optional[int] = None,
    cg_rtol: Optional[float] = None,
    precond="none",
    callback=None,
    max_time: float = 300.0,
    verbose: int = 0,
    **numeric,
) -> ExecutionStats:
    """Solve one (typically very large) equality-constrained NLS problem with
    the matrix-free Gauss–Newton engine — no Jacobian is ever materialized.

    Same stopping rules, schedules and stats surface as :func:`cannoles`;
    the linear solver is CG on the SPD doubly-condensed KKT operator, with CG
    convergence standing in for the inertia test.  Use for m·n beyond HBM
    (the dense solver is faster below that)."""
    solver = MatrixFreeSolver(
        problem, method=method, cg_maxiter=cg_maxiter, cg_rtol=cg_rtol,
        precond=precond,
    )
    return solver.solve(
        x0=x, lam0=lam, callback=callback, max_time=max_time, verbose=verbose, **numeric
    )
