"""Row-block model parallelism for one large NLS problem (BASELINE config 4).

The reference handles large residual counts through *sparsity* of J and a
sparse LDLᵀ (SURVEY.md §5 "long-context analog").  The answer here is
**row-block sharding + Schur reduction**:

* the residual dimension m is laid out over a device mesh axis ``'rows'``
  (per-residual data pytree leaves carry a leading m axis and are placed with
  ``NamedSharding(mesh, P('rows'))``);
* the solver runs its **condensed** KKT backend, whose only m-sized
  contractions are ``JᵀJ``, ``Jᵀ rhs_r`` and reductions like ``‖F‖²`` —
  XLA/GSPMD partitions the row dimension and inserts ``all-reduce``
  collectives for exactly those contractions (the "annotate shardings, let
  XLA insert collectives" recipe), so each device holds only its
  (m/n_devices, n) Jacobian block and the replicated (n+p)² condensed system;
* the factorization itself is tiny and replicated — the Schur reduction has
  already collapsed the m-dimension.

No hand-written collectives: the sharding annotation IS the parallelization.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.solver import CaNNOLeSSolver
from ..core.status import ExecutionStats, status_name
from ..problem import NLSProblem
from ..utils.linalg import norm_2

__all__ = ["make_row_mesh", "solve_row_sharded"]


def make_row_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), axis_names=("rows",))


def solve_row_sharded(
    problem: NLSProblem,
    mesh: Optional[Mesh] = None,
    *,
    x0=None,
    lam0=None,
    solver: Optional[CaNNOLeSSolver] = None,
    method: str = "gauss_newton",
    linsolve: str = "chol",
    max_iter: int = 200,
    **numeric,
) -> ExecutionStats:
    """Solve ONE large problem with its residual rows sharded over ``mesh``.

    ``problem.data`` leaves must carry the residual dimension m as their
    leading axis (e.g. observation times/targets); they are placed with
    ``P('rows')`` and every m-sized intermediate (F, r, J) inherits the
    sharding, while x, λ and the condensed KKT stay replicated.
    """
    problem.validate_for_solve()
    if problem.data is None:
        raise ValueError(
            "row-sharded solve needs per-residual `data` (leading axis = nequ) "
            "to define the row partition"
        )
    mesh = mesh or make_row_mesh()
    if solver is None:
        solver = CaNNOLeSSolver(problem, method=method, linsolve=linsolve, kkt="condensed")
    elif solver.kkt != "condensed":
        raise ValueError("row-sharded solve requires the condensed KKT backend")

    rows = NamedSharding(mesh, P("rows"))
    repl = NamedSharding(mesh, P())

    def _place(a):
        a = jnp.asarray(a)
        # shard only per-residual leaves (leading axis == nequ); scene-level
        # constants (gauge anchors, scalars) stay replicated
        sh = rows if (a.ndim >= 1 and a.shape[0] == problem.nequ) else repl
        return jax.device_put(a, sh)

    data = jax.tree.map(_place, problem.data)
    x0 = jax.device_put(
        jnp.asarray(problem.x0 if x0 is None else x0, dtype=solver.dtype), repl
    )
    lam0 = jax.device_put(
        jnp.asarray(problem.y0 if lam0 is None else lam0, dtype=solver.dtype), repl
    )
    cfg = solver.make_config(max_iter=max_iter, **numeric)

    state = solver._run_fn(x0, lam0, cfg, data)
    jax.block_until_ready(state.x)

    stats = ExecutionStats()
    stats.status = status_name(int(state.status))
    stats.iter = int(state.iter)
    stats.objective = float(state.fx)
    stats.dual_feas = float(state.normdual)
    stats.primal_feas = float(norm_2(state.cx))
    stats.solution = np.asarray(state.x)
    stats.multipliers = np.asarray(state.lam)
    stats.solver_specific.update(
        nfact=int(state.nfact), nlinsolve=int(state.nlinsolve), nbk=int(state.nbk)
    )
    return stats
