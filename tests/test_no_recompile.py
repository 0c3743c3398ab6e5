"""No-recompilation test — the compiled-program analog of the reference's ≤96-bytes
allocation regression (test/runtests.jl:28-36, SURVEY.md §4 mapping (b)):
after the first solve, subsequent solves with new initial points / tolerances
must hit the jit cache (zero retraces)."""

import jax
import jax.numpy as jnp
import numpy as np

from cannoles_tpu import CaNNOLeSSolver, nls_problem


def _mgh01con():
    return nls_problem(
        lambda x: jnp.array([1 - x[0], 10 * (x[1] - x[0] ** 2)]),
        jnp.array([-1.2, 1.0]),
        2,
        lambda x: jnp.array([x[0] - 0.5]),
        [0.0],
        [0.0],
        name="MGH01CON",
    )


def test_no_recompilation_across_solves():
    nls = _mgh01con()
    solver = CaNNOLeSSolver(nls)
    solver.solve()  # warmup: trace + compile

    with jax.log_compiles(True):
        import logging

        records = []

        class H(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        logger = logging.getLogger("jax._src.dispatch")
        h = H()
        logger.addHandler(h)
        try:
            for x0 in (jnp.zeros(2), jnp.array([-1.2, 1.0]), jnp.array([3.0, -2.0])):
                stats = solver.solve(x0=x0, atol=1e-9, rtol=1e-9)
                assert stats.status in ("first_order", "small_residual")
        finally:
            logger.removeHandler(h)

    compiles = [r for r in records if "Compiling" in r]
    assert compiles == [], f"unexpected recompilation: {compiles}"


def test_resolve_matches_fresh_solver():
    nls = _mgh01con()
    solver = CaNNOLeSSolver(nls)
    s1 = solver.solve()
    s2 = solver.solve()  # second call, cached path
    assert s1.status == s2.status
    assert np.allclose(s1.solution, s2.solution)
    assert s1.iter == s2.iter
    assert s1.solver_specific["nfact"] == s2.solver_specific["nfact"]
