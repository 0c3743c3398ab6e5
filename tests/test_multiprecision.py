"""Multiprecision tests (reference test/runtests.jl:102-113): the whole
solver runs in float32 and float64 with eps-derived tolerances
max(1e-4, eps^0.25)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cannoles_tpu import CaNNOLeSSolver, nls_problem


def F_Rosen(x):
    return jnp.array([x[0] - 1, 10 * (x[1] - x[0] ** 2)])


def c_linear(x):
    return jnp.array([jnp.sum(x) - 1])


@pytest.mark.parametrize("linsolve", ["ldlt", "eigh"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_multiprecision(dtype, linsolve):
    x0 = jnp.array([-1.2, 1.0], dtype=dtype)
    nls = nls_problem(F_Rosen, x0, 2, c_linear, [0.0], [0.0])
    solver = CaNNOLeSSolver(nls, linsolve=linsolve, dtype=dtype)
    stats = solver.solve(x0=x0)
    eps = float(jnp.finfo(dtype).eps)
    tol = max(1e-4, eps**0.25)
    assert np.allclose(stats.solution, [0.6188, 0.3812], atol=tol), (
        stats.status, stats.solution)
    assert np.asarray(stats.solution).dtype == np.dtype(dtype)


@pytest.mark.parametrize("mp", ["highest", "bfloat16"])
def test_bf16_mixed_precision_mode(mp):
    """The supported bf16 story is mixed precision: f32 state with bf16
    passes on non-critical matmuls (matmul_precision knob; no-op arithmetic
    on CPU but the full trace-time plumbing is exercised).  Envelope on a
    GPU: benchmarks/bf16_envelope.py."""
    x0 = jnp.array([-1.2, 1.0], dtype=jnp.float32)
    nls = nls_problem(F_Rosen, x0, 2, c_linear, [0.0], [0.0])
    solver = CaNNOLeSSolver(nls, dtype=jnp.float32, matmul_precision=mp)
    stats = solver.solve(x0=x0)
    assert stats.status == "first_order"
    assert np.allclose(stats.solution, [0.6188, 0.3812], atol=1e-3)
    # batched runner under the same precision context
    from cannoles_tpu.parallel.batch import vsolve

    x0s = jnp.broadcast_to(x0, (4, 2))
    res = vsolve(nls, x0s, solver=solver, max_iter=100)
    assert res.solved_mask().all()


def test_bf16_solve_dtype_unsupported_is_documented():
    """bf16 as a solve dtype is numerically meaningless (8-bit mantissa makes
    the eps-derived tolerances accept garbage); pin the behavior so the
    documented position (params.py) stays true: the solve completes with
    finite output but cannot be trusted to locate the minimizer."""
    dt = jnp.bfloat16
    x0 = jnp.array([-1.2, 1.0], dtype=dt)
    nls = nls_problem(F_Rosen, x0, 2, c_linear, [0.0], [0.0])
    stats = CaNNOLeSSolver(nls, dtype=dt).solve(x0=x0)
    assert np.isfinite(np.asarray(stats.solution, np.float64)).all()
    assert np.asarray(stats.solution).dtype == np.dtype(dt)


def test_matmul_precision_validation():
    x0 = jnp.array([-1.2, 1.0], dtype=jnp.float32)
    nls = nls_problem(F_Rosen, x0, 2, c_linear, [0.0], [0.0])
    with pytest.raises(ValueError, match="matmul_precision"):
        CaNNOLeSSolver(nls, matmul_precision="fp8")
