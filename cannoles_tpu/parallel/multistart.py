"""Batched multistart: turn instance-batch throughput into solve quality.

The reference is a serial solver — one start, one first-order point, and on
nonconvex batteries (Freudenstein–Roth, Wood, penalty, ...) that point is
often a local minimum.  Here a single compiled vmapped solve sweeps hundreds
of perturbed starts in one shot and returns the best feasible first-order
point — the batched answer to "the reference got stuck".
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.solver import CaNNOLeSSolver
from ..core.status import ExecutionStats, Status, status_name
from ..problem import NLSProblem
from .batch import BatchResult

__all__ = ["multistart"]


def multistart(
    problem: NLSProblem,
    n_starts: int = 64,
    scale: float = 1.0,
    *,
    solver: Optional[CaNNOLeSSolver] = None,
    method: str = "newton",
    linsolve: str = "ldlt",
    kkt: str = "full",
    seed: int = 0,
    max_iter: int = 100,
    include_x0: bool = True,
    **numeric,
) -> ExecutionStats:
    """Solve from ``n_starts`` perturbed initial points in one compiled
    batch; return stats at the best (lowest-objective, feasible, solved)
    lane.

    Perturbations are Gaussian with per-coordinate width
    ``scale * max(1, |x0|)`` around ``problem.x0`` (lane 0 keeps x0 itself
    when ``include_x0``).
    """
    problem.validate_for_solve()
    if solver is None:
        solver = CaNNOLeSSolver(problem, method=method, linsolve=linsolve, kkt=kkt)
    rng = np.random.default_rng(seed)
    x0 = np.asarray(problem.x0, dtype=float)
    width = scale * np.maximum(1.0, np.abs(x0))
    starts = x0[None, :] + rng.normal(size=(n_starts, x0.shape[0])) * width[None, :]
    if include_x0:
        starts[0] = x0
    x0s = jnp.asarray(starts, dtype=solver.dtype)
    lam0s = jnp.broadcast_to(
        jnp.asarray(problem.y0, dtype=solver.dtype), (n_starts, problem.ncon)
    )
    cfg = solver.make_config(max_iter=max_iter, **numeric)
    run = solver.batch_runner(data_batched=False)
    states = run(x0s, lam0s, cfg, problem.data)
    res = BatchResult(states=states)

    solved = res.solved_mask()
    obj = np.asarray(states.fx, dtype=float)
    # feasibility guard for constrained problems
    if problem.ncon > 0:
        feas = np.linalg.norm(np.asarray(states.cx), axis=1) <= np.sqrt(
            np.asarray(states.epstol)
        )
        solved = solved & feas
    score = np.where(solved, obj, np.inf)
    best = int(np.argmin(score))

    stats = ExecutionStats()
    if not solved.any():
        # no lane solved: report the best-dual lane's status
        best = int(np.argmin(np.asarray(states.normdual)))
        stats.status = status_name(int(np.asarray(states.status)[best]))
    else:
        stats.status = status_name(int(np.asarray(states.status)[best]))
    stats.solution = np.asarray(states.x[best])
    stats.multipliers = np.asarray(states.lam[best])
    stats.objective = float(states.fx[best])
    stats.dual_feas = float(states.normdual[best])
    stats.primal_feas = float(np.linalg.norm(np.asarray(states.cx[best])))
    stats.iter = int(states.iter[best])
    stats.solver_specific.update(
        n_starts=n_starts,
        n_solved=int(solved.sum()),
        best_lane=best,
        objectives=np.sort(obj[solved])[:8].tolist() if solved.any() else [],
    )
    return stats
