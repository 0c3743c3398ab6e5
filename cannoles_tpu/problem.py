"""Problem protocol: equality-constrained nonlinear least squares.

Replacement for the NLPModels.jl API consumed by the reference
(``/root/reference/src/CaNNOLeS.jl:259-291, 467-498, 715-719, 952-976``):
instead of in-place callbacks + COO sparsity structures, the user supplies two
pure functions

    residual(x[, data]) -> (nequ,)   and   cons(x[, data]) -> (ncon,)

and every derivative the solver needs is obtained by JAX transforms:

  J(x)            = jax.jacfwd(residual)                 (dense (nequ, nvar))
  Jc(x)           = jax.jacfwd(cons)                     (dense (ncon, nvar))
  sum_i r_i H F_i = jax.hessian(x -> <residual(x), r>)   (weighted residual Hessian)
  sum_i y_i H c_i = jax.hessian(x -> <cons(x), y>)       (weighted constraint Hessian,
                                                          NLPModels hess_coord! with
                                                          obj_weight = 0)

Sparsity is deliberately dropped: the problems in the vmapped batch
regime are small-dense, and the large regime is handled by
row-block sharding + Schur reduction (see ``cannoles_tpu.parallel``), not by a
sparse factorization.

The optional ``data`` pytree parameterizes a problem *family*: a single
compiled solver can then be vmapped/sharded over thousands of instances that
share structure but differ in data (initial points, observations, ...), which
is the instance-batch parallelism axis of this build.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["NLSProblem", "nls_problem", "Counters"]


def _basis_like(x, n):
    """Identity tangent basis whose varying-manual-axes type matches ``x``.

    The basis must stay a LITERAL identity in the common case — XLA's
    simplifier elides dot(B, I) for linear-operator residuals, and adding
    ``0·x`` to force the vma type defeats that (measured: J build 0.053 →
    0.201 ms on an 8192×1024 residual).  Under shard_map, where ``x``
    carries varying manual axes, the basis is explicitly pcast to match
    (a fresh unvarying constant is rejected by linearize's tangent check).
    """
    basis = jnp.eye(n, dtype=x.dtype)
    vma = getattr(jax.typeof(x), "vma", None)
    if vma:
        basis = jax.lax.pcast(basis, tuple(vma), to="varying")
    return basis


class Counters:
    """Evaluation counters, mirroring NLPModels NLSCounters as used by the
    reference's `eval_fun` budget test (/root/reference/src/CaNNOLeS.jl:559)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.neval_residual = 0
        self.neval_cons = 0
        self.neval_jac_residual = 0
        self.neval_jac = 0
        self.neval_hess_residual = 0
        self.neval_hess = 0

    def eval_fun(self) -> int:
        # reference budget: neval_residual + neval_cons (CaNNOLeS.jl:123)
        return self.neval_residual + self.neval_cons


def _wants_data(fn: Callable) -> bool:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return len(sig.parameters) >= 2


@dataclasses.dataclass(frozen=True)
class NLSProblem:
    """min ½‖residual(x)‖²  s.t.  cons(x) = lcon  (= ucon), no bounds.

    Fields mirror the NLPModelMeta/NLSMeta surface the reference consumes;
    dims are static Python ints (jit specialization keys), arrays are JAX/numpy.
    """

    residual: Callable  # (x, data) -> (nequ,)
    nvar: int
    nequ: int
    x0: Any
    cons: Optional[Callable] = None  # (x, data) -> (ncon,)
    ncon: int = 0
    lcon: Any = None
    ucon: Any = None
    y0: Any = None
    lvar: Any = None
    uvar: Any = None
    data: Any = None
    name: str = "generic"
    minimize: bool = True
    # If False the problem declares it cannot provide second-order residual
    # information (analog of a model not implementing hess_coord_residual!,
    # reference test/noFHess-model.jl); method='newton' must then be rejected.
    has_residual_hessian: bool = True
    # Optional analytic overrides (else AD). Signatures f(x, data).
    jac_residual: Optional[Callable] = None
    hess_residual_weighted: Optional[Callable] = None  # (x, r, data) -> (n, n)
    jac_cons: Optional[Callable] = None
    hess_cons_weighted: Optional[Callable] = None  # (x, y, data) -> (n, n)
    # mutable evaluation counters (NLSCounters analog); the solver adds its
    # traced in-state counts here after each solve
    counters: Counters = dataclasses.field(default_factory=Counters, compare=False)

    # ---- validation (reference cannoles() guards, CaNNOLeS.jl:408-413) ----
    def validate_for_solve(self):
        if not self.minimize:
            raise ValueError("CaNNOLeS only works for minimization problem")
        if self.has_inequalities() or self.has_bounds():
            raise ValueError("Problem has inequalities, can't solve it")

    def has_bounds(self) -> bool:
        if self.lvar is None and self.uvar is None:
            return False
        lv = np.asarray(self.lvar) if self.lvar is not None else np.full(self.nvar, -np.inf)
        uv = np.asarray(self.uvar) if self.uvar is not None else np.full(self.nvar, np.inf)
        return bool(np.any(np.isfinite(lv)) or np.any(np.isfinite(uv)))

    def has_inequalities(self) -> bool:
        if self.ncon == 0:
            return False
        return bool(np.any(np.asarray(self.lcon) != np.asarray(self.ucon)))

    # ---- evaluation helpers (all pure; data closed in by the solver) ----
    def F(self, x, data=None):
        return self.residual(x, data)

    def c_shifted(self, x, data=None):
        """cons(x) - lcon, the equality residual (reference c!, CaNNOLeS.jl:469-477)."""
        if self.ncon == 0:
            return jnp.zeros((0,), dtype=x.dtype)
        return self.cons(x, data) - jnp.asarray(self.lcon, dtype=x.dtype)

    def J(self, x, data=None):
        """Dense (nequ, nvar) Jacobian.

        Built as ``linearize`` + vmapped tangent pushes rather than
        ``jax.jacfwd``: measured 3.6× faster on an 8192×1024 residual
        (0.053 vs 0.190 ms device-side) — jacfwd materializes a layout
        transpose moving the tangent batch axis, whereas the swapaxes here
        stays a lazy dimension permutation XLA folds into consumer dots,
        and XLA's simplifier can elide identity-basis matmuls entirely for
        linear-operator residuals."""
        if self.jac_residual is not None:
            return self.jac_residual(x, data)
        _, fjvp = jax.linearize(lambda z: self.residual(z, data), x)
        return jnp.swapaxes(jax.vmap(fjvp)(_basis_like(x, self.nvar)), 0, 1)

    def F_and_J(self, x, data=None):
        """Residual value AND Jacobian from one linearization point.

        The reference's hot loop evaluates F then refreshes J separately
        (CaNNOLeS.jl:715-719); ``jax.linearize`` shares one primal trace
        between the value and the n tangent pushes, so the residual is
        evaluated exactly once per (F, J) pair instead of twice (jacfwd
        evaluates and discards the primal)."""
        Fx, Jt = self.F_and_Jt(x, data)
        return Fx, jnp.swapaxes(Jt, -2, -1)

    def Jt(self, x, data=None):
        """Jᵀ in its NATURAL (nvar, nequ) layout — no transpose copy.

        ``vmap(linearize-tangent)(I)`` produces J's columns as rows; the
        dense solver carries this layout in its state (SolverState.JxT) so
        the per-iteration Jacobian refresh never pays the (m, n) physical
        relayout that ``jacfwd`` / a stored (m, n) J forces (measured
        ~0.15 ms per build at 8192×1024 — the dominant non-matmul cost of
        the large-rung inner iteration).  Every consumer is a dot, and
        XLA's dot_general contracts transposed operands natively."""
        if self.jac_residual is not None:
            return jnp.swapaxes(self.jac_residual(x, data), -2, -1)
        _, fjvp = jax.linearize(lambda z: self.residual(z, data), x)
        return jax.vmap(fjvp)(_basis_like(x, self.nvar))

    def F_and_Jt(self, x, data=None):
        """(F(x), Jᵀ in natural (nvar, nequ) layout) from one linearization
        point — see :meth:`F_and_J` and :meth:`Jt`."""
        if self.jac_residual is not None:
            return self.residual(x, data), jnp.swapaxes(
                self.jac_residual(x, data), -2, -1
            )
        Fx, fjvp = jax.linearize(lambda z: self.residual(z, data), x)
        return Fx, jax.vmap(fjvp)(_basis_like(x, self.nvar))

    def Jc(self, x, data=None):
        if self.ncon == 0:
            return jnp.zeros((0, self.nvar), dtype=x.dtype)
        if self.jac_cons is not None:
            return self.jac_cons(x, data)
        return jax.jacfwd(lambda z: self.cons(z, data))(x)

    def hess_res(self, x, r, data=None):
        """sum_i r_i * hessian(F_i)(x) — the exact second-order term
        (reference hess_coord_residual!, hessian_approx.jl:50-53)."""
        if not self.has_residual_hessian:
            raise NotImplementedError(
                f"problem '{self.name}' provides no residual Hessian; "
                "use method='gauss_newton' (reference :Newton_noFHess)"
            )
        if self.hess_residual_weighted is not None:
            return self.hess_residual_weighted(x, r, data)
        return jax.hessian(lambda z: jnp.vdot(self.residual(z, data), r))(x)

    def hess_cons(self, x, y, data=None):
        """sum_i y_i * hessian(c_i)(x) — NLPModels hess with obj_weight=0
        (reference CaNNOLeS.jl:971)."""
        if self.ncon == 0:
            return jnp.zeros((self.nvar, self.nvar), dtype=x.dtype)
        if self.hess_cons_weighted is not None:
            return self.hess_cons_weighted(x, y, data)
        return jax.hessian(lambda z: jnp.vdot(self.cons(z, data), y))(x)

    # ---- matrix-free products (NLPModels jprod/jtprod/hprod parity) ----
    # The reference's hand-coded fixture (test/mgh01con.jl:23-283) defines the
    # full matrix-free surface: jprod_residual!/jtprod_residual!,
    # hprod_residual!, jprod!/jtprod!, hprod!.  Here these are one
    # jvp/vjp/ nested-jvp each — no materialized Jacobian, O(nequ)/O(nvar)
    # memory — and are what the large-m matrix-free paths (CGLS, Schur
    # matvecs) consume.
    def jprod_res(self, x, v, data=None):
        """J(x) @ v via one forward-mode pass (jprod_residual!)."""
        return jax.jvp(lambda z: self.residual(z, data), (x,), (v,))[1]

    def jtprod_res(self, x, v, data=None):
        """J(x)ᵀ @ v via one reverse-mode pass (jtprod_residual!)."""
        _, pull = jax.vjp(lambda z: self.residual(z, data), x)
        return pull(v)[0]

    def jprod_cons(self, x, v, data=None):
        """Jc(x) @ v (jprod!)."""
        if self.ncon == 0:
            return jnp.zeros((0,), dtype=x.dtype)
        return jax.jvp(lambda z: self.cons(z, data), (x,), (v,))[1]

    def jtprod_cons(self, x, v, data=None):
        """Jc(x)ᵀ @ v (jtprod!)."""
        if self.ncon == 0:
            return jnp.zeros((self.nvar,), dtype=x.dtype)
        _, pull = jax.vjp(lambda z: self.cons(z, data), x)
        return pull(v)[0]

    def hprod_res(self, x, r, v, data=None):
        """(Σᵢ rᵢ ∇²Fᵢ(x)) @ v by forward-over-reverse (hprod_residual!)."""
        if not self.has_residual_hessian:
            raise NotImplementedError(
                f"problem '{self.name}' provides no residual Hessian; "
                "use method='gauss_newton' (reference :Newton_noFHess)"
            )
        g = jax.grad(lambda z: jnp.vdot(self.residual(z, data), r))
        return jax.jvp(g, (x,), (v,))[1]

    def hprod_cons(self, x, y, v, data=None):
        """(Σᵢ yᵢ ∇²cᵢ(x)) @ v — hprod! with obj_weight = 0."""
        if self.ncon == 0:
            return jnp.zeros((self.nvar,), dtype=x.dtype)
        g = jax.grad(lambda z: jnp.vdot(self.cons(z, data), y))
        return jax.jvp(g, (x,), (v,))[1]

    def hprod_lag(self, x, y, v, *, obj_weight=1.0, data=None):
        """Lagrangian-Hessian product ∇²ₓₓ(σ·½‖F‖² + yᵀc) @ v — the NLPModels
        hprod! contract (fixture test/mgh01con.jl hprod section).  The
        objective Hessian is the Gauss–Newton JᵀJv term plus the residual
        curvature Σ Fᵢ∇²Fᵢ v."""
        g = jax.grad(
            lambda z: obj_weight * 0.5 * jnp.vdot(self.residual(z, data), self.residual(z, data))
            + (jnp.vdot(self.cons(z, data), y) if self.ncon > 0 else 0.0)
        )
        return jax.jvp(g, (x,), (v,))[1]


def nls_problem(
    residual: Callable,
    x0,
    nequ: int,
    cons: Optional[Callable] = None,
    lcon=None,
    ucon=None,
    *,
    y0=None,
    lvar=None,
    uvar=None,
    data: Any = None,
    name: str = "generic",
    minimize: bool = True,
    has_residual_hessian: bool = True,
    **analytic,
) -> NLSProblem:
    """Build an :class:`NLSProblem` — the ADNLSModel analog.

    ``residual``/``cons`` may take one arg ``f(x)`` or two ``f(x, data)``.
    """
    x0 = jnp.asarray(x0)
    nvar = int(x0.shape[0])

    def _lift(fn):
        if fn is None:
            return None
        if _wants_data(fn):
            return fn
        return lambda x, data, _fn=fn: _fn(x)

    res = _lift(residual)
    con = _lift(cons)

    ncon = 0
    if con is not None:
        if lcon is None:
            raise ValueError("constrained problem requires lcon (and ucon)")
        lcon = jnp.atleast_1d(jnp.asarray(lcon))
        ucon = jnp.atleast_1d(jnp.asarray(ucon)) if ucon is not None else lcon
        ncon = int(lcon.shape[0])
    if y0 is None:
        y0 = jnp.zeros((ncon,), dtype=x0.dtype)
    else:
        y0 = jnp.asarray(y0)

    return NLSProblem(
        residual=res,
        nvar=nvar,
        nequ=int(nequ),
        x0=x0,
        cons=con,
        ncon=ncon,
        lcon=lcon,
        ucon=ucon,
        y0=y0,
        lvar=lvar,
        uvar=uvar,
        data=data,
        name=name,
        minimize=minimize,
        has_residual_hessian=has_residual_hessian,
        jac_residual=_lift(analytic.get("jac_residual")),
        hess_residual_weighted=analytic.get("hess_residual_weighted"),
        jac_cons=_lift(analytic.get("jac_cons")),
        hess_cons_weighted=analytic.get("hess_cons_weighted"),
    )
