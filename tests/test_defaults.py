"""Measured-best defaults are the defaults (round-3 VERDICT item 2).

The measurements justifying each dispatch live in benchmarks/RESULTS.md:
the lanes-batched Pallas LDLᵀ kernel is 2.6× faster and far more f32-robust
than vmapped blocked-jnp inside vsolve; the condensed + two-level Cholesky
path is the measured winner for m ≫ n.  A user calling the documented API
with no backend kwarg must get those, not a slower fallback.
"""

import jax.numpy as jnp
import numpy as np

import cannoles_tpu.parallel.batch as batch_mod
from cannoles_tpu import CaNNOLeSSolver, nls_problem
from cannoles_tpu.core.solver import resolve_auto
from cannoles_tpu.ops.pallas_ldlt import KERNEL_MAX_N
from cannoles_tpu.parallel.batch import vsolve


def _small_family():
    return nls_problem(
        lambda x, d: jnp.array([x[0] - d[0], 10 * (x[1] - x[0] ** 2)]),
        jnp.array([-1.2, 1.0]),
        2,
        lambda x, d: jnp.array([x[0] + x[1] - d[1]]),
        [0.0],
        [0.0],
        data=jnp.ones((2,)),
        name="defaults_family",
    )


def test_resolve_auto_small_problem_full_ldlt():
    pb = _small_family()
    linsolve, kkt, robust = resolve_auto(pb, "newton", "auto", "auto")
    assert (linsolve, kkt, robust) == ("ldlt", "full", True)


def test_resolve_auto_large_gn_condensed_chol():
    m, n = 512, 16
    A = jnp.ones((m, n))
    pb = nls_problem(lambda x: A @ x - 1.0, jnp.zeros(n), m)
    linsolve, kkt, robust = resolve_auto(pb, "gauss_newton", "auto", "auto")
    assert (linsolve, kkt, robust) == ("chol", "condensed", True)
    # Newton's residual-Hessian block can be indefinite: no Cholesky
    linsolve, kkt, _ = resolve_auto(pb, "newton", "auto", "auto")
    assert (linsolve, kkt) == ("ldlt", "condensed")
    # explicit choices pass through untouched
    linsolve, kkt, robust = resolve_auto(pb, "gauss_newton", "eigh", "full")
    assert (linsolve, kkt, robust) == ("eigh", "full", False)


def test_vsolve_default_dispatches_pallas(monkeypatch):
    """vsolve(problem, x0s) with no backend kwarg must build the Pallas
    solver for small KKT systems — the BENCH-throughput configuration."""
    built = {}

    real = CaNNOLeSSolver

    def recording(problem, **kw):
        built.update(kw)
        return real(problem, **kw)

    monkeypatch.setattr(batch_mod, "CaNNOLeSSolver", recording)
    pb = _small_family()
    x0s = jnp.broadcast_to(jnp.array([-1.2, 1.0]), (4, 2))
    datas = jnp.ones((4, 2))
    res = vsolve(pb, x0s, data_batch=datas, max_iter=100)
    assert built["linsolve"] == "pallas"
    assert res.solved_mask().all(), res.summary()
    # lanes agree with the scalar solver's answer
    assert np.allclose(res.solution.sum(axis=1), 1.0, atol=1e-6)


def test_vsolve_default_beyond_pallas_cap_falls_back(monkeypatch):
    built = {}
    real = CaNNOLeSSolver

    def recording(problem, **kw):
        built.update(kw)

        class _Stub:  # don't actually compile a (KERNEL_MAX_N+)² solver
            dtype = jnp.float64

            def make_config(self, **kkw):
                raise _Done

        return _Stub()

    class _Done(Exception):
        pass

    monkeypatch.setattr(batch_mod, "CaNNOLeSSolver", recording)
    n = KERNEL_MAX_N + 8
    pb = nls_problem(lambda x: x - 1.0, jnp.zeros(n), n)
    try:
        vsolve(pb, jnp.zeros((2, n)))
    except _Done:
        pass
    assert built["linsolve"] == "ldlt"
