"""cannoles_tpu — constrained nonlinear least squares in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of CaNNOLeS.jl
(the Orban–Siqueira regularization method for  min ½‖F(x)‖²  s.t.  c(x)=0),
reference mounted read-only at /root/reference.

Quick start::

    import jax.numpy as jnp
    from cannoles_tpu import nls_problem, cannoles

    nls = nls_problem(lambda x: jnp.array([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
                      jnp.array([-1.2, 1.0]), 2)
    stats = cannoles(nls)
    print(stats.status, stats.solution)

Batched (the accelerator regime)::

    from cannoles_tpu import vsolve
    results = vsolve(nls, x0_batch)          # vmapped full solver
"""

from .core.solver import (
    AVAILABLE_LINSOLVE,
    AVAILABLE_METHODS,
    CaNNOLeSSolver,
    RunConfig,
    SolverState,
    cannoles,
)
from .core.status import ExecutionStats, Status, status_name
from .params import Params
from .problem import Counters, NLSProblem, nls_problem

__version__ = "0.1.0"

__all__ = [
    "cannoles",
    "CaNNOLeSSolver",
    "SolverState",
    "RunConfig",
    "ExecutionStats",
    "Status",
    "status_name",
    "Params",
    "NLSProblem",
    "nls_problem",
    "Counters",
    "AVAILABLE_METHODS",
    "AVAILABLE_LINSOLVE",
    "vsolve",
    "multistart",
    "solve_matfree",
    "MatrixFreeSolver",
    "SchurBASolver",
]


def __getattr__(name):
    # lazy imports to avoid cycles
    if name == "vsolve":
        from .parallel.batch import vsolve

        return vsolve
    if name == "multistart":
        from .parallel.multistart import multistart

        return multistart
    if name in ("solve_matfree", "MatrixFreeSolver"):
        from .core import matfree

        return getattr(matfree, name)
    if name == "SchurBASolver":
        from .core.ba import SchurBASolver

        return SchurBASolver
    raise AttributeError(name)
