"""Constrained nonlinear least-squares solver — the Orban–Siqueira
regularization method as a jittable state machine for XLA devices.

This is a ground-up JAX restatement of the reference algorithm
(``/root/reference/src/CaNNOLeS.jl:418-864`` main loop, ``:1008-1052``
inertia-corrected Newton system, ``:1054-1112`` Armijo line search), built
for the XLA compilation model rather than translated:

* the mutable pre-allocated ``CaNNOLeSSolver`` workspace (reference
  ``:181-223``) becomes an immutable :class:`SolverState` pytree carried
  through ``lax.while_loop`` — "≤96 bytes allocated per solve" becomes
  "trace once, zero recompilation, zero host syncs in the hot path";
* the sparse COO KKT matrix (reference ``:281-315``) becomes a dense blocked
  KKT assembled from AD-computed blocks (dense matmul-friendly);
* MA57/LDLFactorizations + inertia (reference ``solver_types.jl``) become the
  blocked LDLᵀ / eigh backends of :mod:`cannoles_tpu.ops.ldlt`;
* per-instance control flow (rho bumps, backtracking counts, inner-loop
  lengths) is expressed as bounded while_loops with status lanes so the whole
  solver vmaps over instance batches.

Hot path: one inner iteration = 1 KKT assembly + (1+bumps) factorizations +
1-2 residual/constraint evaluations + 2 Jacobians.  Everything is dense and
static-shaped so XLA maps the O(N³) factorization and O(mn²) AD onto dense
device kernels.
"""

from __future__ import annotations

import time

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.cgls import cgls
from ..ops.ldlt import factor_solve, factorize, inertia_success
from ..params import F_BLOWUP, MAX_DLAMBDA, SMAX, Params
from ..problem import NLSProblem
from ..utils.linalg import check_nan_inf, norm_1, norm_2, norm_inf
from .status import MSG, ExecutionStats, Status, get_status_code, status_name


def _tree_select(pred, on_true, on_false):
    """Per-leaf jnp.where over two matching pytrees.

    Used instead of ``lax.cond`` on the compiled hot path: under vmap a cond
    lowers to select_n and executes both branches anyway, and vmap-of-cond
    inside shard_map trips jax 0.9's varying-manual-axes checker (it replays
    branch jaxprs without harmonizing vma).  The branchless form is
    vma-correct by construction and identical in cost under batching."""
    return jax.tree.map(lambda a, b: jnp.where(pred, a, b), on_true, on_false)

__all__ = [
    "CaNNOLeSSolver",
    "cannoles",
    "SolverState",
    "RunConfig",
    "AVAILABLE_METHODS",
    "AVAILABLE_LINSOLVE",
    "resolve_auto",
]

AVAILABLE_METHODS = ("newton", "lm", "gauss_newton", "newton_vanishing")
# aliases accepted for parity with the reference symbols (CaNNOLeS.jl:11)
_METHOD_ALIASES = {
    "Newton": "newton",
    "LM": "lm",
    "Newton_noFHess": "gauss_newton",
    "newton_nofhess": "gauss_newton",
    "Newton_vanishing": "newton_vanishing",
}
AVAILABLE_LINSOLVE = ("ldlt", "eigh", "pallas", "cpp", "chol")
_LINSOLVE_ALIASES = {"ldlfactorizations": "ldlt", "ma57": "eigh", "pallas_ldl": "pallas"}


def _check_available_method(method: str) -> str:
    method = _METHOD_ALIASES.get(method, method)
    if method not in AVAILABLE_METHODS:
        opts = ", ".join(f"`{m}`" for m in AVAILABLE_METHODS)
        raise ValueError(f"`method` must be one of these: {opts}")
    return method


def resolve_auto(problem, method: str, linsolve: str, kkt: str):
    """Resolve 'auto' linsolve/kkt to the measured-best configuration.

    The measurements behind each branch are in benchmarks/RESULTS.md:

    * ``kkt='auto'`` → 'condensed' when m ≫ n (m ≥ 4(n+p) and the full KKT
      is big enough for the O(N³) factorization to matter): eliminating the
      residual block turns an (n+m+p)³ factorization into (n+p)³ plus one
      matmul — the measured hot path for the large dense regime.
    * ``linsolve='auto'`` on a condensed Gauss–Newton/LM system → 'chol'
      (two-level Cholesky; SPD by construction), else 'ldlt' with the
      in-loop exact-inertia eigh retry (``robust_fallback``) — the
      two-backend seam of the reference (CaNNOLeS.jl:317-332).

    Returns ``(linsolve, kkt, robust_fallback)``.
    """
    method = _check_available_method(method)
    n, m, p = problem.nvar, problem.nequ, problem.ncon
    if kkt == "auto":
        kkt = "condensed" if (m >= 4 * (n + p) and n + m + p >= 64) else "full"
    auto = linsolve == "auto"
    if auto:
        if kkt == "condensed" and method in ("gauss_newton", "lm"):
            linsolve = "chol"
        else:
            linsolve = "ldlt"
    return linsolve, kkt, auto


class RunConfig(NamedTuple):
    """Traced numeric knobs — changing these does NOT recompile."""

    atol: jax.Array
    rtol: jax.Array
    Fatol: jax.Array
    Frtol: jax.Array
    delta_dec: jax.Array
    max_eval: jax.Array  # int32
    max_inner: jax.Array  # int32
    max_iter: jax.Array  # int32; -1 = unlimited (host-driven mode only)


class SolverState(NamedTuple):
    """The full solver state — one pytree, vmappable over instances."""

    x: jax.Array  # (n,)
    lam: jax.Array  # (p,)
    r: jax.Array  # (m,)
    Fx: jax.Array  # (m,)
    cx: jax.Array  # (p,)
    fx: jax.Array  # scalar ½‖F‖²
    JxT: jax.Array  # (n, m) — Jᵀ in its natural linearize layout (problem.Jt)
    Jcx: jax.Array  # (p, n)
    dual: jax.Array  # (n,)
    primal: jax.Array  # (m+p,)
    d: jax.Array  # (n+m+p,) current Newton step
    dlam: jax.Array  # (p,)
    normdual: jax.Array
    normprimal: jax.Array
    rho: jax.Array
    rho_old: jax.Array
    delta: jax.Array
    eta: jax.Array
    epsk: jax.Array
    alpha: jax.Array
    damp: jax.Array
    epsF: jax.Array
    epstol: jax.Array
    epsc: jax.Array
    iter: jax.Array  # int32
    inner_iter: jax.Array  # int32
    neval_F: jax.Array  # int32
    neval_c: jax.Array  # int32
    nbk: jax.Array  # int32
    nfact: jax.Array  # int32
    nlinsolve: jax.Array  # int32
    status: jax.Array  # int32
    broken: jax.Array  # bool
    msg: jax.Array  # int32
    first_order: jax.Array  # bool
    small_residual: jax.Array  # bool
    # problem-family data pytree (None for data-free problems); carried in the
    # state so a single compiled solver vmaps/shards over instance batches
    data: Any = None


class _InnerCarry(NamedTuple):
    s: SolverState
    normdualhat: jax.Array
    normprimalhat: jax.Array
    combined_hat: jax.Array
    first: jax.Array  # bool
    tired: jax.Array  # bool


class _RhoCarry(NamedTuple):
    k: jax.Array
    rho: jax.Array
    sol: jax.Array  # solution of W(rho) sol = rhs for the last attempt
    success: jax.Array
    nfact: jax.Array


def _dual_scaling(lam, ncon, dtype):
    """sd = max(smax, ‖λ‖₁/ncon)/smax (reference CaNNOLeS.jl:917-920)."""
    if ncon == 0:
        return jnp.ones((), dtype=dtype)
    smax = jnp.asarray(SMAX, dtype=dtype)
    return jnp.maximum(smax, norm_1(lam) / ncon) / smax


class CaNNOLeSSolver:
    """Pre-compiled solver for one problem structure (CaNNOLeSSolver analog,
    reference CaNNOLeS.jl:181-377): build once, solve many times with
    different initial points / numeric tolerances without recompiling."""

    def __init__(
        self,
        problem: NLSProblem,
        *,
        method: str = "newton",
        linsolve: str = "ldlt",
        use_initial_multiplier: bool = False,
        always_accept_extrapolation: bool = False,
        lm_damping: bool = False,
        multiplier_refit: bool = False,
        block_size: int = 32,
        kkt: str = "full",
        debug_print: bool = False,
        params: Optional[Params] = None,
        delta_min: Optional[float] = None,
        quality_gate: Optional[bool] = None,
        robust_fallback: bool = False,
        descent_rescue: bool = True,
        matmul_precision: Optional[str] = None,
        dtype=None,
    ):
        self.method = _check_available_method(method)
        linsolve = _LINSOLVE_ALIASES.get(linsolve, linsolve)
        if linsolve not in AVAILABLE_LINSOLVE:
            raise ValueError(f"Can't handle linsolve={linsolve!r}")
        self.linsolve = linsolve
        if kkt not in ("full", "condensed"):
            raise ValueError(f"kkt must be 'full' or 'condensed', got {kkt!r}")
        self.kkt = kkt
        if linsolve == "chol" and kkt != "condensed":
            raise ValueError(
                "linsolve='chol' requires kkt='condensed' (the full KKT system "
                "is indefinite in the residual block)"
            )
        self.problem = problem
        self.use_initial_multiplier = bool(use_initial_multiplier)
        self.always_accept_extrapolation = bool(always_accept_extrapolation)
        self.lm_damping = bool(lm_damping)
        # Per-outer-iteration CGLS multiplier refit (Armand 2012 estimator —
        # the same least-squares estimate the reference computes at init and
        # inside optimality_check_small_residual, CaNNOLeS.jl:507-518,
        # :866-897 — applied every outer iteration, kept only where it
        # strictly improves the dual norm).  The aug-Lagrangian first-order
        # update λ ← λ − c/δ converges the dual at rate ~c/δ and carries an
        # f32 noise floor ~eps/δmin on near-degenerate constraints (round-3
        # diagnosis); the refit replaces the walk with the optimal
        # least-squares multiplier.  Matches the matfree engines'
        # multiplier_refit (core/matfree.py) so every engine — including
        # batched vsolve — has the dual-floor escape hatch.
        self.multiplier_refit = bool(multiplier_refit)
        self.block_size = int(block_size)
        # backward-error gate on factorization attempts: default on only for
        # KKT sizes where fixed-order elimination has room to misjudge
        # inertia (measured breakdown at N=21); at tiny N the extra
        # reductions halve the fused-kernel batch throughput for no
        # robustness gain (every pivot is exercised directly).
        N = problem.nvar + problem.nequ + problem.ncon
        if kkt == "condensed":
            N = problem.nvar + problem.ncon
        self.quality_gate = (N >= 16) if quality_gate is None else bool(quality_gate)
        # in-loop exact-inertia retry at rho-ladder exhaustion (the
        # two-backend seam of the reference run per-iteration); meaningless
        # for the already-exact eigh backend
        self.robust_fallback = bool(robust_fallback) and linsolve != "eigh"
        # In-graph repair of non-descent directions (round-5): an unpivoted
        # f32 elimination can pass the pivot-sign inertia test at rho=0 yet
        # deliver a direction with Dϕ ≥ 0, which the reference turns into a
        # hard line-search error (CaNNOLeS.jl:1085).  Before breaking the
        # lane, re-solve the SAME assembled system with the backward-error
        # gate forced on, then (still non-descent) on exact-inertia eigh —
        # both as `enabled`-masked rho ladders that cost zero trips when no
        # lane is bad.  Removes the need for a host-side re-solve pass for
        # this failure mode; lanes that fail even eigh still break exactly
        # as the reference does.  Meaningless when the primary IS eigh.
        self.descent_rescue = bool(descent_rescue) and linsolve != "eigh"
        # Optional second (exact-inertia eigh) descent-rescue stage.
        # Measured OFF by default: on the B=65536 headline rung the gated
        # stage alone repairs every non-descent lane at +13 ms, while
        # staging the eigh ladder into the compiled iteration costs ~1.0 s
        # (batched tiny-N eigh lowers poorly, and the whole chunk pays
        # whenever one lane triggers).  Lanes the gate cannot fix still
        # break exactly as the reference does and are caught by the
        # host-side ``vsolve(rescue=True)`` eigh pass, which prices the
        # exotic tail per failed lane instead of per chunk-iteration.
        self._descent_rescue_eigh = False
        self.debug_print = bool(debug_print)
        self.last_state: Optional[SolverState] = None
        self.dtype = jnp.dtype(dtype) if dtype is not None else jnp.asarray(problem.x0).dtype
        if not jnp.issubdtype(self.dtype, jnp.floating):
            self.dtype = jnp.dtype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        if params is None:
            overrides = {} if delta_min is None else {"delta_min": float(delta_min)}
            # A floor above the default sqrt(eps) tames the aug-Lagrangian
            # multiplier update λ ← λ − c/δ on near-degenerate constrained
            # problems (e.g. HS27 solves with delta_min=1e-4 where the
            # reference schedule thrashes); default keeps reference parity.
            params = Params.for_dtype(self.dtype, **overrides)
        self.params = params
        if self.method in ("newton", "newton_vanishing") and not problem.has_residual_hessian:
            raise NotImplementedError(
                f"problem '{problem.name}' provides no residual Hessian; "
                "use method='gauss_newton' (reference :Newton_noFHess)"
            )
        # Matmul-precision seam.  ``matmul_precision=None`` leaves JAX's
        # default, which on an H100 runs float32 matmuls in TF32 (10-bit
        # mantissa; 'high' is the same there, only 'highest' is full f32);
        # the numerically critical contractions (JᵀJ condensation below,
        # quality-gate / refinement residuals) pin precision='highest'.
        #   None        -> default: TF32 where XLA picks it, f32 where it matters;
        #   'highest'   -> full f32 arithmetic in every matmul (parity/debug);
        #   'bfloat16' / 'tensorfloat32' -> commit every matmul, including the
        #                  condensation, to that arithmetic.
        # Accuracy envelope: benchmarks/bf16_envelope.py.
        if matmul_precision not in (None, "highest", "float32", "bfloat16", "tensorfloat32"):
            raise ValueError(f"unknown matmul_precision {matmul_precision!r}")
        self.matmul_precision = matmul_precision
        # The JᵀJ condensation is the conditioning-critical contraction.
        # Default (None) mode pins it to 'highest': on an H100 (400 W limit),
        # 256 batched BA scenes at N = 73 solved 256/256 either way, but the
        # worst scene landed 2.75 from its float64 KKT point with the TF32
        # condensation against 1.08 pinned (CPU float32: 0.45), at no
        # measurable time cost (12.98 vs 12.65 ms per batch; the 8192×1024
        # fit 21.4 vs 19.2 ms) — benchmarks/ldlt_kernel_study.py --e2e.
        # An EXPLICIT matmul_precision is a full commitment: the
        # condensation follows it.  The quality-gate residual is separate and
        # ALWAYS measured at 'highest' (see _gate_eps below).
        self._critical_precision = (
            "highest" if matmul_precision is None else matmul_precision
        )
        # The quality gate must stay honest in commit mode: the gate residual
        # matmul is O(N²) (never throughput-critical) so it is ALWAYS measured
        # at 'highest', and its tolerance scales with the unit roundoff of the
        # *committed arithmetic* — a backward-stable bf16 factorization leaves
        # an O(eps_bf16) residual that an f32-eps tolerance would misread as
        # failure, sending the rho ladder into spurious escalation.
        self._gate_eps = float(
            jnp.finfo(
                {
                    "bfloat16": jnp.bfloat16,
                    "tensorfloat32": jnp.float32,  # 10-bit mantissa ≈ 2^-10
                }.get(matmul_precision, self.dtype)
            ).eps
        )
        if matmul_precision == "tensorfloat32":
            self._gate_eps = 2.0**-10
        # Trial-point linearize-once: the α = 1 trial evaluation and the
        # trial-Jacobian refresh happen at the same point whenever the line
        # search does not backtrack (extrapolation never does, Armijo
        # usually doesn't), so sharing one jax.linearize saves a full
        # residual primal per inner iteration — measured ~0.2 ms of a
        # 1.4 ms iteration on the 8192×1024 rung (the primal is two
        # bandwidth-bound (m, n) matvec passes there).  Enabled only for
        # large Jacobians solved unbatched: under vmap the lax.cond
        # executes both branches, which would *double* the J build for
        # backtracking batches.
        self._reuse_trial_linearization = (
            problem.nequ * problem.nvar >= (1 << 20)
            and problem.jac_residual is None
        )
        # Scalar (real lax.cond) branching for the large-unbatched regime
        # was tried and MEASURED SLOWER than the branchless per-leaf selects
        # (2.92 vs 2.70 ms/solve on the 8192x1024 rung): XLA already elides
        # selects whose branches share buffers and fuses through them, while
        # real cond branches are fusion barriers.  Kept as a seam, default
        # off everywhere.
        self._scalar_mode = False
        # jitted entry points (compiled lazily on first call)
        self._init_fn = self._jit(self._init_state)
        self._outer_fn = self._jit(self._outer_step)
        self._run_fn = self._jit(self._run_compiled)
        self._batch_runners: dict = {}

    def _jit(self, fn, **jit_kw):
        """jit under the solver's matmul-precision default (trace-time
        config: explicit precision= args in the graph are unaffected)."""
        if self.matmul_precision is None:
            return jax.jit(fn, **jit_kw)
        prec = self.matmul_precision

        def wrapped(*args):
            with jax.default_matmul_precision(prec):
                return fn(*args)

        return jax.jit(wrapped, **jit_kw)

    def batch_runner(self, data_batched: bool, batch_shape=None, mesh=None):
        """Cached jitted batched runner: ``run(x0s, lam0s, cfg, datas)``.

        ``batch_shape = (B, chunk)`` enables sequential-chunk execution
        (straggler control + much smaller compile); None = one flat vmap.
        ``mesh``: a 1-D device mesh; the flat vmap then runs under
        ``shard_map`` over its axis, each device solving its own lanes.
        Cached per signature so repeated vsolve calls never re-trace."""
        key = (bool(data_batched), batch_shape, mesh)
        if key in self._batch_runners:
            return self._batch_runners[key]
        vrun = jax.vmap(
            self._run_compiled, in_axes=(0, 0, None, 0 if data_batched else None)
        )
        if mesh is not None:
            if batch_shape is not None:
                raise ValueError("chunked batch runs take no mesh")
            from jax.sharding import PartitionSpec as P

            lanes = P(mesh.axis_names[0])
            sharded = jax.shard_map(
                vrun,
                mesh=mesh,
                in_specs=(lanes, lanes, P(), lanes if data_batched else P()),
                out_specs=lanes,
                # the Pallas call's outputs carry no varying-axes type
                check_vma=False,
            )
            run = self._jit(sharded)
        elif batch_shape is None:
            run = self._jit(vrun)
        else:
            B, chunk = batch_shape
            nchunk = B // chunk

            def _split(a):
                return a.reshape((nchunk, chunk) + a.shape[1:])

            @self._jit
            def run(x0s, l0s, cfg, datas):
                xr, lr = _split(x0s), _split(l0s)
                dr = None if datas is None else jax.tree.map(_split, datas)

                def chunk_fn(args):
                    xc, lc, dc = args
                    return vrun(xc, lc, cfg, dc)

                states = lax.map(chunk_fn, (xr, lr, dr))
                return jax.tree.map(
                    lambda a: a.reshape((B,) + a.shape[2:]), states
                )

        self._batch_runners[key] = run
        return run

    def reset(self, problem: Optional[NLSProblem] = None) -> "CaNNOLeSSolver":
        """Re-solve support (reference SolverCore.reset!, CaNNOLeS.jl:379-400):
        with no argument this is a no-op (re-solving with a new x0 needs no
        reset — jitted functions are shape-keyed); with a problem of identical
        dimensions it returns a solver wired to the new problem."""
        if problem is None:
            return self
        if (problem.nvar, problem.nequ, problem.ncon) != (
            self.problem.nvar,
            self.problem.nequ,
            self.problem.ncon,
        ):
            raise ValueError("reset requires a problem with identical dimensions")
        return CaNNOLeSSolver(
            problem,
            method=self.method,
            linsolve=self.linsolve,
            use_initial_multiplier=self.use_initial_multiplier,
            always_accept_extrapolation=self.always_accept_extrapolation,
            lm_damping=self.lm_damping,
            multiplier_refit=self.multiplier_refit,
            block_size=self.block_size,
            kkt=self.kkt,
            params=self.params,
            quality_gate=self.quality_gate,
            robust_fallback=self.robust_fallback,
            descent_rescue=self.descent_rescue,
            matmul_precision=self.matmul_precision,
            dtype=self.dtype,
        )

    # ------------------------------------------------------------------
    # pieces
    # ------------------------------------------------------------------
    def _H_block(self, x, lam, r, Fx, JxT, damp, data):
        """Top-left KKT block: method-dependent residual Hessian minus the
        constraint-curvature term (reference prepare_newton_system!,
        CaNNOLeS.jl:947-981 + hessian_approx.jl)."""
        pb = self.problem
        n = pb.nvar
        dtype = x.dtype
        if self.method in ("newton", "newton_vanishing"):
            Hres = pb.hess_res(x, r, data)
            if self.method == "newton_vanishing":
                # documented semantics: drop the second-order term once
                # ‖F‖² ≤ 1e-8 (hessian_approx.jl:55-60).  NOTE the reference
                # ctor returns a plain Newton (hessian_approx.jl:37), making
                # the vanishing dispatch dead there; we implement the intent.
                Hres = jnp.where(jnp.vdot(Fx, Fx) > 1e-8, Hres, jnp.zeros_like(Hres))
        else:
            Hres = jnp.zeros((n, n), dtype=dtype)
        if pb.ncon > 0:
            Hres = Hres - pb.hess_cons(x, lam, data)
        if self.method == "lm" and self.lm_damping:
            # per-column LM scaling from the reference's TODO block
            # (CaNNOLeS.jl:922-940): Λ_j = clamp(damp)·‖Jx[:,j]‖²
            scale = jnp.clip(damp, 1e-10, 1e8)
            Hres = Hres + jnp.diag(scale * jnp.sum(JxT * JxT, axis=1))
        return Hres

    def _assemble_kkt(self, H, Jx, Jcx, delta):
        """Dense symmetric KKT  W = [H Jᵀ Jcᵀ; J -I 0; Jc 0 -δI]
        (reference structure comment CaNNOLeS.jl:282)."""
        pb = self.problem
        n, m, p = pb.nvar, pb.nequ, pb.ncon
        dtype = H.dtype
        # Block-concatenate instead of .at[].set scatters: under vmap the
        # scatter chain lowers to serialized full-array updates that XLA
        # cannot fuse.
        Im = -jnp.eye(m, dtype=dtype)
        if p == 0:
            return jnp.concatenate(
                [
                    jnp.concatenate([H, Jx.T], axis=1),
                    jnp.concatenate([Jx, Im], axis=1),
                ],
                axis=0,
            )
        Zmp = jnp.zeros((m, p), dtype=dtype)
        Ip = -delta * jnp.eye(p, dtype=dtype)
        return jnp.concatenate(
            [
                jnp.concatenate([H, Jx.T, Jcx.T], axis=1),
                jnp.concatenate([Jx, Im, Zmp], axis=1),
                jnp.concatenate([Jcx, Zmp.T, Ip], axis=1),
            ],
            axis=0,
        )

    def _assemble_condensed(self, H, JxT, Jcx, delta):
        """Schur-condensed KKT: eliminating the residual block dr through the
        -I block (reference rows at CaNNOLeS.jl:304-306) gives the
        (n+p)-square quasi-definite system

            K = [H + JᵀJ   Jcᵀ]      b = [rhs_x + Jᵀ rhs_r]
                [Jc        -δI ],         [rhs_c           ]

        with identical inertia decisions (In(W) = In(K) + (0, m, 0) by the
        Schur complement on the negative-definite -I block).  O((n+p)³)
        factorization instead of O((n+m+p)³) — the BASELINE north-star form,
        and the hot path for m ≫ n.  JᵀJ is one matmul."""
        pb = self.problem
        p = pb.ncon
        dtype = H.dtype
        # critical precision (default 'highest'; an H100 runs default-
        # precision f32 matmuls in TF32, which loosens J'J's conditioning);
        # an explicit matmul_precision overrides (see __init__)
        M = H + jnp.matmul(JxT, JxT.T, precision=self._critical_precision)
        if p == 0:
            return M
        # concat assembly, not scatters — see _assemble_kkt note (20x on the
        # batched BA rung, where this is 47% of the device budget)
        return jnp.concatenate(
            [
                jnp.concatenate([M, Jcx.T], axis=1),
                jnp.concatenate([Jcx, -delta * jnp.eye(p, dtype=dtype)], axis=1),
            ],
            axis=0,
        )

    def _solve_quality_ok(self, W, sol, rhs):
        """Backward-error gate on a factorization attempt.

        An unpivoted LDLᵀ can pass the pivot-sign inertia test yet deliver a
        numerically wrong direction on an ill-conditioned KKT matrix (the
        reference inherits the same hazard from LDLFactorizations' unpivoted
        elimination and surfaces it as a Dϕ ≥ 0 line-search abort).  Here a
        cheap O(N²) residual check demotes such attempts to *failures*, so the
        existing ρ-bump loop (CaNNOLeS.jl:1029-1047) regularizes and retries —
        turning a hard solver error into one more regularized factorization.
        Gate: ‖W·sol − rhs‖∞ ≤ N·eps^(3/4)·(‖rhs‖∞ + max|W|·‖sol‖₁), a loose
        multiple of the backward-stable bound, so accurate backends are never
        affected (verified by backend trajectory-parity tests).  ``eps`` is
        the unit roundoff of the committed arithmetic (``matmul_precision``),
        and the residual itself is always measured at 'highest' — see
        ``_gate_eps`` in ``__init__``."""
        N = W.shape[-1]
        tol = self._gate_eps**0.75 * N
        res = rhs - jnp.matmul(W, sol, precision="highest")
        scale = norm_inf(rhs) + jnp.max(jnp.abs(W)) * norm_1(sol)
        return norm_inf(res) <= tol * (scale + jnp.asarray(1e-30, W.dtype))

    def _attempt(self, W, rhs):
        sol, success = self._attempt_raw(W, rhs)
        if self.quality_gate:
            success = success & self._solve_quality_ok(W, sol, rhs)
        return sol, success

    def _attempt_raw(self, W, rhs):
        """One factorization attempt: returns (solution of W sol = rhs,
        inertia-success flag).  Backend seam: blocked jnp LDLᵀ / eigh /
        Pallas fused batched kernel (auto-selected under vmap)."""
        pr = self.params
        n = self.problem.nvar
        if self.linsolve == "pallas":
            from ..ops.pallas_ldlt import fused_ldlt_solve

            sol, d = fused_ldlt_solve(W, rhs, pr.eig_tol, nb=self.block_size)
            success = inertia_success(d, sol, n, pr.eig_tol)
            return sol, success
        if self.linsolve == "cpp":
            from ..ops.cpp_ldlt import cpp_ldlt_factor_solve

            return cpp_ldlt_factor_solve(W, rhs, n, pr.eig_tol)
        if self.linsolve == "chol":
            # Two-level Cholesky on the condensed quasi-definite system
            # K = [M Jcᵀ; Jc -δI]: In(K) = (n, p, 0) ⟺ M ≻ 0 (the Schur
            # block -δI - Jc M⁻¹Jcᵀ is then automatically negative
            # definite), so success == Cholesky(M) finite with pivots
            # above eig_tol — the same inertia criterion.  The n×n factor
            # is XLA's Cholesky (cuSOLVER on the GPU).
            from jax.scipy.linalg import cho_solve, solve_triangular as _st

            p = self.problem.ncon
            M = W[:n, :n]
            bx = rhs[:n]
            Lm = jnp.linalg.cholesky(M)
            dlm = jnp.diagonal(Lm)
            okM = jnp.all(jnp.isfinite(Lm)) & jnp.all(dlm * dlm > pr.eig_tol)
            M_solve = lambda b: cho_solve((Lm, True), b)  # noqa: E731
            M_fwd = lambda b: _st(Lm, b, lower=True)  # noqa: E731
            if p == 0:
                sol = M_solve(bx)
                return sol, okM & jnp.all(jnp.isfinite(sol))
            Jc = W[n:, :n]
            delta = -W[n, n]  # the (2,2) block is -δI (rho touches only x-diag)
            bc = rhs[n:]
            Z = M_fwd(Jc.T)  # solve L Z = Jcᵀ; (n, p) (+zero pad rows)
            S = delta * jnp.eye(p, dtype=W.dtype) + jnp.matmul(Z.T, Z, precision="highest")
            Ls = jnp.linalg.cholesky(S)
            okS = jnp.all(jnp.isfinite(Ls))
            Minv_bx = M_solve(bx)
            zl = cho_solve((Ls, True), Jc @ Minv_bx - bc)
            zx = M_solve(bx - Jc.T @ zl)
            sol = jnp.concatenate([zx, zl])
            return sol, okM & okS & jnp.all(jnp.isfinite(sol))
        fac, success = factorize(W, pr.eig_tol, n, self.linsolve, self.block_size)
        sol = factor_solve(fac, rhs, pr.eig_tol, self.linsolve)
        return sol, success

    def _rho_ladder(self, attempt, rhs, rho_old, enabled=None):
        """The reference's exact rho schedule (CaNNOLeS.jl:1008-1052) around
        one factorization seam: try rho=0; on inertia failure rho ← rho0
        (first time) or max(rho_min, κdec·rho_old); escalate by κlargeinc/
        κinc until success or rho > rho_max.

        ``enabled``: optional per-lane gate.  A vmapped while_loop OR-reduces
        its condition across lanes, so when no lane is enabled the whole loop
        exits after zero trips — used to make the eigh fallback ladder free
        on iterations where the primary backend succeeded everywhere."""
        pr = self.params
        dtype = rhs.dtype

        # The rho=0 attempt is folded into the retry loop (k == 0) so the
        # factorization is staged ONCE in the compiled graph — at large N
        # this halves XLA compile time of the Newton system.
        def cond(c: _RhoCarry):
            go = (c.k == 0) | ((~c.success) & (c.rho <= pr.rho_max))
            return go if enabled is None else enabled & go

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
            # Branchless: under vmap a lax.cond executes both branches anyway,
            # and vmap-of-cond trips a vma bug under shard_map (jax 0.9 asks
            # for check_vma=False); the masked form costs one extra attempt
            # only at rho-ladder exhaustion, which aborts the loop next trip.
            sol_t, suc_t = attempt(rho)
            sol = jnp.where(do, sol_t, c.sol)
            success = do & suc_t
            return _RhoCarry(c.k + 1, rho, sol, success, c.nfact + do.astype(jnp.int32))

        N = rhs.shape[0]
        return lax.while_loop(
            cond,
            body,
            # init carries derive from rhs (zeros_like) so their
            # varying-manual-axes type matches the body outputs under shard_map
            _RhoCarry(
                jnp.zeros((), jnp.int32),
                jnp.zeros_like(rhs, shape=()),
                jnp.zeros_like(rhs, shape=(N,)),
                jnp.zeros_like(rhs, shape=(), dtype=bool),
                jnp.zeros_like(rhs, shape=(), dtype=jnp.int32),
            ),
        )

    def _newton_system(self, W0, rhs, rho_old, bad_direction=None):
        """Inertia-corrected factorize-and-solve: the rho ladder around the
        primary backend, plus (robust_fallback) a second exact-inertia eigh
        ladder entered only at primary-ladder exhaustion — the in-loop
        two-backend seam of the reference (MA57 primary with an
        LDLFactorizations fallback, CaNNOLeS.jl:317-332), replacing the
        round-2 whole-solve restart: no second compiled program, no
        discarded iterates.

        ``bad_direction(d) -> bool``: optional per-lane predicate marking a
        *successful* solve whose step d is unusable (non-descent, Dϕ ≥ 0).
        With ``descent_rescue`` on, such lanes re-enter the ladder with the
        backward-error gate forced on, then on exact-inertia eigh — both
        ``enabled``-masked so they cost zero trips when no lane is bad."""
        pb, pr = self.problem, self.params
        n = pb.nvar
        diag_idx = jnp.arange(n)

        def attempt(rho):
            return self._attempt(W0.at[diag_idx, diag_idx].add(rho), rhs)

        def attempt_gated(rho):
            W = W0.at[diag_idx, diag_idx].add(rho)
            sol, suc = self._attempt_raw(W, rhs)
            return sol, suc & self._solve_quality_ok(W, sol, rhs)

        from ..ops.ldlt import eigh_factor, eigh_solve

        def attempt_eigh(rho):
            W = W0.at[diag_idx, diag_idx].add(rho)
            fac = eigh_factor(W, pr.eig_tol)
            sol = eigh_solve(fac, rhs, pr.eig_tol)
            return sol, inertia_success(fac.vec, fac.mat, n, pr.eig_tol)

        def merge(out, out2, need, take):
            # need: lanes that ran the retry ladder (counts its attempts);
            # take: lanes that adopt its result
            nfact_all = out.nfact + jnp.where(need, out2.nfact, 0)
            return _tree_select(take, out2, out)._replace(nfact=nfact_all)

        out = self._rho_ladder(attempt, rhs, rho_old)

        if self.robust_fallback:
            # Trigger whenever the primary needed ANY regularization: an
            # unpivoted elimination that misjudges inertia at rho=0 doesn't
            # fail its ladder — it spuriously *regularizes* (measured on
            # brown_almost_linear+linear: rho over-escalates until the step
            # stops being a descent direction).  The exact-inertia ladder is
            # ground truth, so wherever it ran and succeeded its answer is
            # preferred; the common rho=0 fast path stays untouched and the
            # gated loop costs zero trips when no lane regularized.
            need = (out.rho != 0) | (~out.success)
            out2 = self._rho_ladder(attempt_eigh, rhs, rho_old, enabled=need)
            out = merge(out, out2, need, need & (out2.success | (~out.success)))

        if bad_direction is not None and self.descent_rescue:
            bad = out.success & bad_direction(-out.sol)
            if not self.quality_gate:
                outg = self._rho_ladder(attempt_gated, rhs, rho_old, enabled=bad)
                out = merge(out, outg, bad,
                            bad & outg.success & (~bad_direction(-outg.sol)))
                bad = out.success & bad_direction(-out.sol)
            if self._descent_rescue_eigh:
                oute = self._rho_ladder(attempt_eigh, rhs, rho_old, enabled=bad)
                out = merge(out, oute, bad,
                            bad & oute.success & (~bad_direction(-oute.sol)))

        rho_old_new = jnp.where(
            out.rho == 0,
            rho_old,
            jnp.where(out.rho <= pr.rho_max, out.rho, rho_old),
        )
        step = jnp.where(out.success, -out.sol, jnp.zeros_like(out.sol))
        return step, out.success, out.rho, rho_old_new, out.nfact

    def _merit(self, Fx, cx, lam, eta):
        """Augmented-Lagrangian merit ϕ = ½‖F‖² − λᵀc + (η/2)‖c‖²
        (reference CaNNOLeS.jl:479-481)."""
        val = 0.5 * jnp.vdot(Fx, Fx)
        if self.problem.ncon > 0:
            val = val - jnp.vdot(lam, cx) + 0.5 * eta * jnp.vdot(cx, cx)
        return val

    def _small_res_recheck(self, s: SolverState) -> SolverState:
        """optimality_check_small_residual! (reference CaNNOLeS.jl:866-897):
        re-estimate λ by CGLS at the current point and recompute the KKT
        residuals."""
        pb = self.problem
        m = pb.nequ
        r = s.Fx
        Jxtr = s.JxT @ r
        if pb.ncon > 0:
            lam = cgls(s.Jcx.T, Jxtr)
            dual = Jxtr - s.Jcx.T @ lam
        else:
            lam = s.lam
            dual = Jxtr
        normdual = norm_inf(dual)
        primal = jnp.concatenate([jnp.zeros_like(s.x, shape=(m,)), s.cx])
        normprimal = norm_inf(s.cx)
        return s._replace(
            r=r, lam=lam, dual=dual, primal=primal, normdual=normdual, normprimal=normprimal
        )

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _init_state(self, x0, lam0, cfg: RunConfig, data=None) -> SolverState:
        pb = self.problem
        n, m, p = pb.nvar, pb.nequ, pb.ncon
        dtype = self.dtype
        x = jnp.asarray(x0, dtype=dtype)
        lam = jnp.asarray(lam0, dtype=dtype)

        # one linearization point: F and Jᵀ share the primal trace; Jᵀ is
        # carried in its natural (n, m) layout (see problem.Jt)
        Fx, JxT = pb.F_and_Jt(x, data)
        broken = check_nan_inf(Fx)  # reference errors here (CaNNOLeS.jl:485-487)
        fx = 0.5 * jnp.vdot(Fx, Fx)
        cx = pb.c_shifted(x, data)
        Jcx = pb.Jc(x, data)
        neval_F = jnp.full_like(x, 1, shape=(), dtype=jnp.int32)
        neval_c = jnp.full_like(x, 1 if p > 0 else 0, shape=(), dtype=jnp.int32)

        r = Fx
        Jxtr = JxT @ r

        if not self.use_initial_multiplier and p > 0:
            lam_ls = cgls(Jcx.T, Jxtr)  # Armand 2012 (CaNNOLeS.jl:513)
            lam = jnp.where(norm_2(lam_ls) == 0, jnp.ones((p,), dtype=dtype), lam_ls)

        dual = Jxtr - (Jcx.T @ lam if p > 0 else jnp.zeros_like(Jxtr))
        primal = jnp.concatenate([Fx - r, cx])
        normdual = norm_inf(dual)
        normprimal = norm_inf(primal)

        epsF = cfg.Fatol + cfg.Frtol * 2 * jnp.sqrt(fx)
        epstol = cfg.atol + cfg.rtol * normdual
        epsc = jnp.sqrt(epstol)

        small_residual = (2 * jnp.sqrt(fx) <= epsF) & (norm_2(cx) <= epsc)
        sd = _dual_scaling(lam, p, dtype)
        first_order = jnp.maximum(normdual / sd, normprimal) <= epstol

        s = SolverState(
            x=x,
            lam=lam,
            r=r,
            Fx=Fx,
            cx=cx,
            fx=fx,
            JxT=JxT,
            Jcx=Jcx,
            dual=dual,
            primal=primal,
            # constant-initialized fields derive from x via full_like so the
            # whole state carries x's varying-manual-axes type: under
            # shard_map every while_loop/cond over SolverState then has
            # vma-consistent carries/branches (fresh constants are unvarying
            # and would clash with body outputs mixed from varying data)
            d=jnp.zeros_like(x, shape=(n + m + p,)),
            dlam=jnp.zeros_like(x, shape=(p,)),
            normdual=normdual,
            normprimal=normprimal,
            rho=jnp.zeros_like(x, shape=()),
            rho_old=jnp.zeros_like(x, shape=()),
            delta=jnp.full_like(x, 1.0, shape=()),
            eta=jnp.full_like(x, 1.0 if p > 0 else 0.0, shape=()),
            epsk=jnp.full_like(x, 1e3, shape=()),
            alpha=jnp.zeros_like(x, shape=()),
            damp=jnp.full_like(x, 1.0, shape=()),
            epsF=epsF,
            epstol=epstol,
            epsc=epsc,
            iter=jnp.zeros_like(x, shape=(), dtype=jnp.int32),
            inner_iter=jnp.zeros_like(x, shape=(), dtype=jnp.int32),
            neval_F=neval_F,
            neval_c=neval_c,
            nbk=jnp.zeros_like(x, shape=(), dtype=jnp.int32),
            nfact=jnp.zeros_like(x, shape=(), dtype=jnp.int32),
            nlinsolve=jnp.zeros_like(x, shape=(), dtype=jnp.int32),
            status=jnp.zeros_like(x, shape=(), dtype=jnp.int32),
            broken=broken,
            msg=jnp.zeros_like(x, shape=(), dtype=jnp.int32),
            first_order=first_order,
            small_residual=small_residual,
            data=data,
        )

        # small-residual pre-check (CaNNOLeS.jl:541-557)
        def recheck(s):
            s2 = self._small_res_recheck(s)
            sd2 = _dual_scaling(s2.lam, p, dtype)
            fo = jnp.maximum(s2.normdual / sd2, s2.normprimal) <= s2.epstol
            return s2._replace(first_order=fo)

        s = _tree_select(small_residual & ~first_order, recheck(s), s)

        status = get_status_code(
            optimal=s.first_order,
            small_residual=s.small_residual,
            broken=s.broken,
            evals=s.neval_F + s.neval_c,
            max_eval=cfg.max_eval,
        )
        return s._replace(status=status)

    # ------------------------------------------------------------------
    # one outer iteration (reference while-!done body, CaNNOLeS.jl:612-857)
    # ------------------------------------------------------------------
    def _select_fn(self, pred, true_fn, false_fn, operand):
        """Branch (scalar mode) or branchless per-leaf select (batched)."""
        if self._scalar_mode:
            return lax.cond(pred, true_fn, false_fn, operand)
        return _tree_select(pred, true_fn(operand), false_fn(operand))

    def _outer_step(self, s: SolverState, cfg: RunConfig) -> SolverState:
        pb, pr = self.problem, self.params
        n, m, p = pb.nvar, pb.nequ, pb.ncon
        dtype = self.dtype
        data = s.data

        combined = s.normdual + s.normprimal
        delta0 = jnp.maximum(
            jnp.asarray(pr.delta_min, dtype), jnp.minimum(cfg.delta_dec * s.delta, combined)
        )
        # *_like resets keep the state's varying-manual-axes type (shard_map)
        s = s._replace(
            delta=delta0,
            damp=jnp.full_like(s.damp, 1.0),
            inner_iter=jnp.zeros_like(s.inner_iter),
        )

        # ---------------- inner loop ----------------
        def solve_system(s: SolverState) -> SolverState:
            H = self._H_block(s.x, s.lam, s.r, s.Fx, s.JxT, s.damp, s.data)
            if self.descent_rescue:
                # same slope as trial_step's Dϕ (reference CaNNOLeS.jl:1080);
                # d[:n] = dx in both the full and the condensed ordering.
                # Extrapolation iterations (inner_iter == 0) never require
                # descent, so they are never rescued.
                JxtFx = s.JxT @ s.Fx
                Jcw = s.Jcx.T @ (s.lam - s.cx / s.delta) if p > 0 else None

                def bad_direction(d):
                    Dphi = jnp.vdot(JxtFx, d[:n])
                    if Jcw is not None:
                        Dphi = Dphi - jnp.vdot(d[:n], Jcw)
                    return (Dphi >= 0) & (s.inner_iter != 0)
            else:
                bad_direction = None
            if self.kkt == "condensed":
                rhs_r = s.primal[:m]
                K0 = self._assemble_condensed(H, s.JxT, s.Jcx, s.delta)
                b = jnp.concatenate([s.dual + s.JxT @ rhs_r, s.primal[m:]])
                z, success, rho, rho_old, nfacti = self._newton_system(
                    K0, b, s.rho_old, bad_direction
                )
                dx = z[:n]
                # recover the eliminated residual step: row 2 of the full
                # system, J dx - dr = -rhs_r with d = -W⁻¹rhs conventions
                dr = rhs_r + dx @ s.JxT
                d = jnp.concatenate([dx, dr, z[n:]])
            else:
                W0 = self._assemble_kkt(H, s.JxT.T, s.Jcx, s.delta)
                rhs = jnp.concatenate([s.dual, s.primal])
                d, success, rho, rho_old, nfacti = self._newton_system(
                    W0, rhs, s.rho_old, bad_direction
                )
            bad_d = check_nan_inf(d)
            # clamp the 1e60 guard to the dtype range (in Float32 the
            # reference's T(1e60) is Inf — same semantics)
            blowup = s.fx >= min(F_BLOWUP, float(jnp.finfo(dtype).max))
            broken = (rho > pr.rho_max) | (~success) | bad_d | blowup
            msg = jnp.where(
                rho > pr.rho_max,
                1,
                jnp.where(~success, 2, jnp.where(bad_d, 3, jnp.where(blowup, 4, 0))),
            ).astype(jnp.int32)
            dlam = -d[n + m :]
            return s._replace(
                d=d,
                dlam=dlam,
                rho=rho,
                rho_old=rho_old,
                nfact=s.nfact + nfacti,
                nlinsolve=s.nlinsolve + 1,
                broken=s.broken | broken,
                msg=jnp.where(s.msg == 0, msg, s.msg),
            )

        def trial_step(s: SolverState):
            """Unified extrapolation / Armijo line-search step.

            The reference branches between a plain full-Newton extrapolation
            on the first inner iteration (CaNNOLeS.jl:659-670) and Armijo
            backtracking afterwards (:672-702, :1054-1112).  Both start from
            the SAME α=1 trial evaluation, so here they are one arithmetic
            path with per-lane masks: under vmap this executes ONE residual
            evaluation (+ per-lane backtracks) per inner iteration instead of
            both cond branches (3 evaluations).  Semantics are identical for
            scalar solves."""
            is_extrap = s.inner_iter == 0
            dx = s.d[:n]
            dr = s.d[n : n + m]

            # ϵk update happens on extrapolation iterations only (:660)
            epsk = jnp.where(
                is_extrap,
                jnp.maximum(
                    jnp.minimum(jnp.asarray(1e3, dtype) * s.delta, 0.99 * s.epsk),
                    0.9 * s.epsk,
                ),
                s.epsk,
            )

            # line-search slope / merit pieces (unused by extrapolation lanes)
            eta_ls = jnp.asarray(1.0, dtype) / s.delta if p > 0 else s.eta
            JxtFx = s.JxT @ s.Fx
            if p > 0:
                w = s.lam - s.cx / s.delta
                Dphi = jnp.vdot(JxtFx, dx) - jnp.vdot(dx, s.Jcx.T @ w)
            else:
                Dphi = jnp.vdot(JxtFx, dx)
            not_descent = (Dphi >= 0) & (~is_extrap)  # reference asserts (:1085)
            phix = self._merit(s.Fx, s.cx, s.lam, eta_ls)
            gammaA = jnp.asarray(pr.gamma_A, dtype)
            eps2 = jnp.asarray(float(jnp.finfo(dtype).eps) ** 2, dtype)

            # shared α = 1 trial evaluation (linearized once when the trial
            # Jacobian can reuse it — see _reuse_trial_linearization)
            xt0 = s.x + dx
            if self._reuse_trial_linearization:
                Ft0, fjvp0 = jax.linearize(lambda z: pb.F(z, data), xt0)
            else:
                Ft0, fjvp0 = pb.F(xt0, data), None
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
                fail = alpha < eps2  # reference errors "α too small" (:1106-1108)
                return (alpha, xt, Ft, ct, phit, nbk + 1, fail)

            alpha, xt, Ft, ct, phit, nbk, fail = lax.while_loop(
                ls_cond,
                ls_body,
                (jnp.ones((), dtype=dtype), xt0, Ft0, ct0, phit0,
                 jnp.zeros((), jnp.int32), jnp.zeros((), dtype=bool)),
            )

            # extrapolation lanes: rt = r + dr, λt = λ + clip(dλ) (:662-668)
            ndl = norm_2(s.dlam)
            Mdl = jnp.asarray(MAX_DLAMBDA, dtype)
            dlam = jnp.where(
                is_extrap & (ndl > Mdl),
                s.dlam * (Mdl / jnp.where(ndl > 0, ndl, 1.0)),
                s.dlam,
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
            return (
                xt, rt, lamt, Ft, ct, alpha_out, eta, epsk, dlam,
                nbk, nF_add, jnp.asarray(nc_add, jnp.int32), ls_broken, ls_msg,
                fjvp0,
            )

        def inner_cond(c: _InnerCarry):
            conv = (c.combined_hat <= 0.99 * combined + c.s.epsk) | c.tired
            return (c.first | ~conv) & (~c.s.broken)

        def inner_body(c: _InnerCarry) -> _InnerCarry:
            s = c.s
            # skip the solve right after a failed extrapolation (the
            # inner_iter == 1 quirk, CaNNOLeS.jl:627)
            do_solve = (s.inner_iter != 1) | self.always_accept_extrapolation
            s = self._select_fn(do_solve, solve_system, lambda s: s, s)

            def when_broken(_):
                return _InnerCarry(
                    s, c.normdualhat, c.normprimalhat, c.combined_hat,
                    jnp.zeros((), dtype=bool), c.tired,
                )

            def when_ok(_):
                (xt, rt, lamt, Ft, ct, alpha, eta, epsk, dlam,
                 nbk_add, nF_add, nc_add, ls_broken, ls_msg, fjvp0) = trial_step(s)

                damp = s.damp
                if self.method == "lm":
                    # Ared/Pred damping bookkeeping (CaNNOLeS.jl:705-713);
                    # only steers the KKT matrix when lm_damping is on.
                    nF2 = jnp.vdot(s.Fx, s.Fx)
                    Ared = nF2 - jnp.vdot(Ft, Ft)
                    step_a = jnp.where(alpha == 0, jnp.ones((), dtype), alpha)
                    pred_vec = s.Fx + step_a * (s.d[:n] @ s.JxT)
                    Pred = nF2 - jnp.vdot(pred_vec, pred_vec)
                    ratio = Ared / Pred
                    damp = jnp.where(ratio > 0.75, damp / 10, jnp.where(ratio < 0.25, damp * 10, damp))

                if fjvp0 is not None:
                    # no backtrack ⇒ xt is the linearization point: reuse
                    # its tangent map for the trial Jacobian (saves the
                    # jacfwd-internal primal); backtracked ⇒ fresh build
                    def _reuse(_):
                        from ..problem import _basis_like

                        return jax.vmap(fjvp0)(_basis_like(s.x, n))

                    JtT = lax.cond(nbk_add == 0, _reuse, lambda _: pb.Jt(xt, data), None)
                else:
                    JtT = pb.Jt(xt, data)
                Jct = pb.Jc(xt, data)
                Jxtr = JtT @ rt
                dual_hat = Jxtr - (Jct.T @ lamt if p > 0 else jnp.zeros_like(Jxtr))
                primal_hat = jnp.concatenate([Ft - rt, ct])
                ndh = norm_inf(dual_hat)
                nph = norm_inf(primal_hat)
                ch = ndh + nph

                good = (ch <= 0.99 * combined + epsk) & (~ls_broken)
                accept = ((s.inner_iter > 0) | self.always_accept_extrapolation | good) & (~ls_broken)

                x_n = jnp.where(accept, xt, s.x)
                r_n = jnp.where(accept, rt, s.r)
                Fx_n = jnp.where(accept, Ft, s.Fx)
                fx_n = jnp.where(accept, 0.5 * jnp.vdot(Ft, Ft), s.fx)
                cx_n = jnp.where(accept, ct, s.cx)
                if self._scalar_mode:
                    # avoid copying the (n, m) Jacobian leaf through a select
                    JxT_n = lax.cond(accept, lambda: JtT, lambda: s.JxT)
                else:
                    JxT_n = jnp.where(accept, JtT, s.JxT)
                Jcx_n = jnp.where(accept, Jct, s.Jcx)
                lam_n = jnp.where(good, lamt, s.lam)
                # on a rejected λ, recompute dual at the (possibly updated)
                # iterate with the old λ (CaNNOLeS.jl:750-756)
                dual_re = JxT_n @ r_n - (Jcx_n.T @ s.lam if p > 0 else jnp.zeros((n,), dtype))
                dual_n = jnp.where(good, dual_hat, dual_re)

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
                    x=x_n, r=r_n, Fx=Fx_n, fx=fx_n, cx=cx_n, JxT=JxT_n, Jcx=Jcx_n,
                    lam=lam_n, dual=dual_n, primal=primal_hat, dlam=dlam,
                    eta=eta, epsk=epsk, alpha=alpha, damp=damp, delta=delta_n,
                    inner_iter=inner_n, neval_F=neF, neval_c=nec,
                    nbk=s.nbk + nbk_add,
                    broken=s.broken | ls_broken,
                    msg=jnp.where(s.msg == 0, ls_msg, s.msg),
                )
                return _InnerCarry(s_n, ndh, nph, ch, jnp.zeros((), dtype=bool), tired)

            return self._select_fn(s.broken, when_broken, when_ok, None)

        init_carry = _InnerCarry(
            s,
            s.normdual,
            s.normprimal,
            jnp.full_like(s.fx, jnp.inf),
            jnp.full_like(s.broken, True),
            (s.neval_F + s.neval_c) > cfg.max_eval,
        )
        c = lax.while_loop(inner_cond, inner_body, init_carry)
        s = c.s._replace(normdual=c.normdualhat, normprimal=c.normprimalhat)

        if self.multiplier_refit and p > 0:
            # per-outer CGLS multiplier refit, kept only where it strictly
            # improves the dual (same recipe as core/matfree.py — the
            # measured escape from the λ ← λ − c/δ f32 dual floor); costs
            # one fixed-budget CGLS on the already-carried Jc per outer
            # iteration, fully vmappable.
            Jxtr_f = s.JxT @ s.r
            lam_fit = cgls(s.Jcx.T, Jxtr_f)
            dual_fit = Jxtr_f - s.Jcx.T @ lam_fit
            nd_fit = norm_inf(dual_fit)
            take = (nd_fit < s.normdual) & (~s.broken)
            s = s._replace(
                lam=jnp.where(take, lam_fit, s.lam),
                dual=jnp.where(take, dual_fit, s.dual),
                normdual=jnp.where(take, nd_fit, s.normdual),
            )

        # ---------------- outer bookkeeping (CaNNOLeS.jl:790-856) ----------------
        sd = _dual_scaling(s.lam, p, dtype)
        first_order = jnp.maximum(s.normdual / sd, s.normprimal) <= s.epstol
        small_residual = (2 * jnp.sqrt(s.fx) <= s.epsF) & (norm_2(s.cx) <= s.epsc)
        s = s._replace(first_order=first_order, small_residual=small_residual)

        def recheck(s):
            s2 = self._small_res_recheck(s)
            sd2 = _dual_scaling(s2.lam, p, dtype)
            fo = jnp.maximum(s2.normdual / sd2, s2.normprimal) <= s2.epstol
            return s2._replace(first_order=fo)

        s = self._select_fn(
            small_residual & ~first_order, recheck, lambda s: s, s
        )

        if self.debug_print:
            # in-compiled-loop log row (reference column set, CaNNOLeS.jl:590)
            jax.debug.print(
                "iter={i} f={f:.3e} ‖∇L‖={nd:.2e} ‖c‖={np:.2e} α={a:.2e} "
                "ρ={rho:.2e} δ={dl:.2e} in_it={ii} nbk={nbk}",
                i=s.iter + 1, f=s.fx, nd=s.normdual, np=s.normprimal,
                a=s.alpha, rho=s.rho, dl=s.delta, ii=s.inner_iter, nbk=s.nbk,
            )

        iter_n = s.iter + 1
        status = get_status_code(
            optimal=s.first_order,
            small_residual=s.small_residual,
            broken=s.broken,
            evals=s.neval_F + s.neval_c,
            max_eval=cfg.max_eval,
            iter_=iter_n,
            max_iter=cfg.max_iter,
            stalled=(s.inner_iter > cfg.max_inner) & (cfg.max_inner >= 0),
        )
        return s._replace(iter=iter_n, status=status)

    # ------------------------------------------------------------------
    # fully-compiled solve (for vmap/batching: no host in the loop)
    # ------------------------------------------------------------------
    def _run_compiled(self, x0, lam0, cfg: RunConfig, data=None) -> SolverState:
        s = self._init_state(x0, lam0, cfg, data)

        def cond(s):
            return s.status == Status.UNKNOWN

        def body(s):
            return self._outer_step(s, cfg)

        return lax.while_loop(cond, body, s)

    # ------------------------------------------------------------------
    # host-driven solve (callbacks, wall-clock limit, logging)
    # ------------------------------------------------------------------
    def make_config(
        self,
        *,
        atol=None,
        rtol=None,
        Fatol=None,
        Frtol=None,
        delta_dec=0.1,
        max_eval=100000,
        max_inner=10000,
        max_iter=-1,
    ) -> RunConfig:
        dtype = self.dtype
        eps = float(jnp.finfo(dtype).eps)
        sqeps = eps**0.5
        return RunConfig(
            atol=jnp.asarray(sqeps if atol is None else atol, dtype),
            rtol=jnp.asarray(sqeps if rtol is None else rtol, dtype),
            Fatol=jnp.asarray(sqeps if Fatol is None else Fatol, dtype),
            Frtol=jnp.asarray(eps if Frtol is None else Frtol, dtype),
            delta_dec=jnp.asarray(delta_dec, dtype),
            max_eval=jnp.asarray(max_eval, jnp.int32),
            max_inner=jnp.asarray(max_inner, jnp.int32),
            max_iter=jnp.asarray(max_iter, jnp.int32),
        )

    def solve(
        self,
        x0=None,
        lam0=None,
        *,
        callback: Optional[Callable] = None,
        max_time: float = 30.0,
        verbose: int = 0,
        stats: Optional[ExecutionStats] = None,
        resume_from: Optional[SolverState] = None,
        **numeric,
    ) -> ExecutionStats:
        """Host-driven solve: jitted outer steps, host-side wall-clock limit,
        callback + logging between outer iterations (reference solve!,
        CaNNOLeS.jl:418-864)."""
        pb = self.problem
        pb.validate_for_solve()
        t0 = time.time()
        if x0 is None:
            x0 = pb.x0
        if lam0 is None:
            lam0 = pb.y0
        cfg = self.make_config(**numeric)
        stats = stats or ExecutionStats()
        stats.status = "unknown"

        if resume_from is not None:
            # checkpoint/resume: continue a saved run — tolerances ride the
            # state, so stopping criteria are preserved across sessions.
            # Passing explicit tolerance kwargs RE-TARGETS the run from the
            # current iterate (continuation/refinement: ϵtol = atol +
            # rtol·‖∇L‖_current) — the mechanism behind two-phase solves
            # that first meet the reference's relative exit, then polish to
            # an absolute target (e.g. gauge-constrained BA, RESULTS.md).
            state = resume_from._replace(status=jnp.zeros((), jnp.int32))
            if {"atol", "rtol", "Fatol", "Frtol"} & numeric.keys():
                epstol = cfg.atol + cfg.rtol * state.normdual
                epsF = cfg.Fatol + cfg.Frtol * 2 * jnp.sqrt(state.fx)
                state = state._replace(
                    epstol=epstol, epsF=epsF, epsc=jnp.sqrt(epstol)
                )
        else:
            state = self._init_fn(x0, lam0, cfg, self.problem.data)
        if not getattr(self, "_outer_warm", False):
            # Exclude jit compilation from the max_time budget: the
            # reference's budget times the solve (CaNNOLeS.jl:123-125), and
            # a cold XLA compile of the outer step (minutes at large N) would
            # otherwise stamp max_time before one iteration ran.  One step is
            # executed and DISCARDED to populate the jit call cache — it is
            # a pure function so no host state changes; cost is one extra
            # compiled step (~ms).  (With debug_print=True the first
            # iteration's in-graph prints appear twice.)
            jax.block_until_ready(self._outer_fn(state, cfg).x)
            self._outer_warm = True
            t0 = time.time()
        self._sync_stats(state, stats, time.time() - t0)
        if verbose > 0:
            self._log_header()
            self._log_row(state, stats)
        if callback is not None:
            callback(pb, state, stats)
        done = stats.status != "unknown"

        while not done:
            state = self._outer_fn(state, cfg)
            elapsed = time.time() - t0
            self._sync_stats(state, stats, elapsed)
            if stats.status == "unknown" and elapsed > max_time:
                stats.status = status_name(Status.MAX_TIME)
            if verbose > 0 and stats.iter % max(verbose, 1) == 0:
                self._log_row(state, stats)
            if callback is not None:
                callback(pb, state, stats)
            done = stats.status != "unknown"

        self._finalize_stats(state, stats)
        self.last_state = state
        # accumulate onto the model-level counters (NLPModels parity)
        pb.counters.neval_residual += int(state.neval_F)
        pb.counters.neval_cons += int(state.neval_c)
        return stats

    def _sync_stats(self, s: SolverState, stats: ExecutionStats, elapsed: float):
        code = int(s.status)
        # don't clobber a host-set status (user/max_time)
        if stats.status in ("unknown", status_name(code)) or code != 0:
            if stats.status != "user":
                stats.status = status_name(code)
        stats.iter = int(s.iter)
        stats.elapsed_time = elapsed
        stats.objective = float(s.fx)
        stats.dual_feas = float(s.normdual)
        stats.primal_feas = float(norm_2(s.cx))
        stats.solution = np.asarray(s.x)
        stats.multipliers = np.asarray(s.lam)

    def _finalize_stats(self, s: SolverState, stats: ExecutionStats):
        stats.solver_specific.update(
            nbk=int(s.nbk),
            nfact=int(s.nfact),
            nlinsolve=int(s.nlinsolve),
            internal_msg=MSG[int(s.msg)],
            neval_residual=int(s.neval_F),
            neval_cons=int(s.neval_c),
        )

    def _log_header(self):
        cols = ["iter", "#F+c", "f(x)", "‖∇L‖", "‖Fx-r‖", "‖c(x)‖", "α", "η", "ρ", "δ", "in_it", "nbk"]
        print("  ".join(f"{c:>9s}" for c in cols))

    def _log_row(self, s: SolverState, stats: ExecutionStats):
        m = self.problem.nequ
        pf = float(norm_2(s.primal[:m]))
        cf = float(norm_2(s.primal[m:])) if self.problem.ncon > 0 else 0.0
        print(
            f"{int(s.iter):9d}  {int(s.neval_F + s.neval_c):9d}  {float(s.fx):9.2e}  "
            f"{float(s.normdual):9.2e}  {pf:9.2e}  {cf:9.2e}  {float(s.alpha):9.2e}  "
            f"{float(s.eta):9.2e}  {float(s.rho):9.2e}  {float(s.delta):9.2e}  "
            f"{int(s.inner_iter):9d}  {int(s.nbk):9d}"
        )


def cannoles(
    problem: NLSProblem,
    *,
    method: str = "newton",
    linsolve: str = "auto",
    kkt: str = "auto",
    x=None,
    lam=None,
    use_initial_multiplier: bool = False,
    always_accept_extrapolation: bool = False,
    multiplier_refit: bool = False,
    callback=None,
    max_time: float = 30.0,
    verbose: int = 0,
    **numeric,
) -> ExecutionStats:
    """Solve an equality-constrained nonlinear least-squares problem.

    ``min ½‖F(x)‖²  s.t. c(x) = 0`` — one-shot entry point (reference
    ``cannoles``, CaNNOLeS.jl:402-416; kwarg surface documented at
    CaNNOLeS.jl:116-132).

    Arguments
    ---------
    problem : NLSProblem (build with :func:`cannoles_tpu.nls_problem`).

    Keyword arguments
    -----------------
    x, lam : initial guess / initial Lagrange multiplier (default
        ``problem.x0`` / ``problem.y0``).
    use_initial_multiplier : if True use ``lam`` for the initial stopping
        tests instead of the CGLS least-squares estimate.
    method : 'newton' | 'lm' | 'gauss_newton' | 'newton_vanishing'
        (reference symbols accepted as aliases).
    linsolve : 'auto' (default, measured-best: 'chol' on a condensed
        Gauss–Newton/LM system, else 'ldlt'; plus an in-loop exact-inertia
        'eigh' retry ladder — the two-backend seam of the reference) |
        'ldlt' | 'eigh' | 'pallas' | 'cpp' | 'chol' (condensed only);
        'ma57'/'ldlfactorizations' aliases accepted.
    kkt : 'auto' (default: 'condensed' when m ≥ 4(n+p) and the KKT is large,
        see :func:`resolve_auto`) | 'full' ((n+m+p)² system) | 'condensed'
        ((n+p)² Schur form).
    max_iter, max_eval, max_time, max_inner : budgets (max_eval counts
        residual + constraint evaluations; max_time is wall clock,
        checked between outer iterations).
    atol, rtol : absolute/relative first-order tolerances
        (ϵtol = atol + rtol·‖∇L⁰‖; defaults √eps(dtype)).
    Fatol, Frtol : small-residual tolerances
        (stop when ‖F‖ ≤ Fatol + Frtol·‖F⁰‖ and ‖c‖ ≤ √ϵtol).
    verbose : print a log row every ``verbose`` outer iterations.
    always_accept_extrapolation : run even if the extrapolation step fails.
    multiplier_refit : re-estimate λ by CGLS (Armand 2012, the reference's
        init/small-residual estimator, CaNNOLeS.jl:507-518) after every outer
        iteration, kept only where it improves the dual norm.  Escapes the
        f32 dual floor of the λ ← λ − c/δ walk on near-degenerate
        constraints (e.g. gauge-constrained bundle adjustment).
    callback : ``callback(problem, state, stats)`` per outer iteration; set
        ``stats.status = 'user'`` to stop.

    Returns an :class:`ExecutionStats` (status, solution, multipliers,
    objective, dual/primal feasibility, counters in ``solver_specific``).
    """
    problem.validate_for_solve()
    # linsolve='auto': the two-backend seam of the reference (MA57 default
    # with an LDLFactorizations fallback, CaNNOLeS.jl:317-332) run in the
    # accelerator-economical direction — the fast unpivoted LDLᵀ on every attempt,
    # and *per KKT system* an exact-inertia eigh retry ladder entered only at
    # rho-ladder exhaustion (the MA57-robustness analog).  One solver
    # instance, one compiled program, no discarded iterates — unlike the
    # round-2 whole-solve restart.  kkt='auto' additionally selects the
    # condensed + Cholesky path for m ≫ n (see resolve_auto).
    linsolve, kkt, auto = resolve_auto(problem, method, linsolve, kkt)
    solver = CaNNOLeSSolver(
        problem,
        method=method,
        linsolve=linsolve,
        kkt=kkt,
        robust_fallback=auto,
        use_initial_multiplier=use_initial_multiplier,
        always_accept_extrapolation=always_accept_extrapolation,
        multiplier_refit=multiplier_refit,
    )
    return solver.solve(
        x0=x, lam0=lam, callback=callback, max_time=max_time, verbose=verbose, **numeric
    )
