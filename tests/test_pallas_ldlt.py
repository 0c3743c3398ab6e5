"""Batched LDLᵀ kernel (ops/pallas_ldlt.py) on the CPU: the Pallas
interpreter against the plain path and float64 numpy, skipped-pivot and
inertia semantics, the N-based choice of kernel, the lowering-platform
choice, and the shard_map batch runner on four virtual devices."""

import sys
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from cannoles_tpu import CaNNOLeSSolver
from cannoles_tpu.ops import pallas_ldlt as pk
from cannoles_tpu.ops.ldlt import ldlt_factor, ldlt_solve
from cannoles_tpu.parallel.batch import make_batch_mesh, vsolve

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

TOL = float(np.finfo(np.float32).eps)


def _plain(W, b):
    def one(Wi, bi):
        fac = ldlt_factor(Wi, TOL)
        return ldlt_solve(fac, bi, TOL), fac.vec

    return jax.vmap(one)(W, b)


def _kernel(W, b):
    return jax.jit(lambda W, b: pk.batched_ldlt_solve_pallas(W, b, TOL))(W, b)


@pytest.mark.parametrize(
    "N,B", [(1, 3), (2, 129), (5, 37), (8, 33), (16, 9), (33, 3), (73, 5), (96, 2)]
)
def test_kernel_matches_plain_and_float64(N, B):
    """Interpret-mode kernel at batch sizes that are not multiples of the
    block: same pivots as the plain path and float64 numpy, backward-stable
    solution."""
    _, TB = pk.kernel_block(N)
    assert B % TB != 0 or TB == 1
    W, b, n = cs.kkt_batch(np.random.default_rng(N), B, N)
    x, d = _kernel(jnp.asarray(W), jnp.asarray(b))
    xr, dr = _plain(jnp.asarray(W), jnp.asarray(b))
    assert x.shape == (B, N) and d.shape == (B, N)
    np.testing.assert_allclose(np.asarray(d), np.asarray(dr), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(d), cs.ldlt_pivots_f64(W, TOL), rtol=1e-4, atol=1e-5)
    assert (np.asarray(d)[:, :n] > 0).all() and (np.asarray(d)[:, n:] < 0).all()
    assert cs.backward_error(W, x, b).max() < 1e-6
    np.testing.assert_allclose(np.asarray(x), np.asarray(xr), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("where", ["first", "middle"])
def test_kernel_skips_zero_pivot_like_plain(where):
    """A zero pivot is recorded raw and skipped (its L column zeroed) so the
    factorization finishes finite — the plain path's semantics."""
    N, B = 12, 6
    W, b, _ = cs.kkt_batch(np.random.default_rng(1), B, N)
    k = 0 if where == "first" else N // 2
    W[2, k, :] = 0.0
    W[2, :, k] = 0.0
    x, d = _kernel(jnp.asarray(W), jnp.asarray(b))
    xr, dr = _plain(jnp.asarray(W), jnp.asarray(b))
    d, dr = np.asarray(d), np.asarray(dr)
    assert d[2, k] == 0.0 and dr[2, k] == 0.0
    skipped = (np.abs(d) <= TOL).any(axis=1)
    assert np.array_equal(np.nonzero(skipped)[0], [2])
    assert np.isfinite(np.asarray(x)).all()
    np.testing.assert_allclose(np.asarray(x), np.asarray(xr), rtol=1e-3, atol=1e-4)


def test_kernel_reports_wrong_inertia():
    """A negative pivot in the (1,1) block shows up in d, so the solver's
    inertia test fails exactly as with the plain path."""
    from cannoles_tpu.ops.ldlt import inertia_success

    N, B = 9, 4
    W, b, n = cs.kkt_batch(np.random.default_rng(2), B, N)
    W[1, :n, :n] -= 20.0 * np.eye(n, dtype=W.dtype)
    x, d = _kernel(jnp.asarray(W), jnp.asarray(b))
    ok = jax.vmap(lambda di, xi: inertia_success(di, xi, n, TOL))(d, x)
    assert list(np.asarray(ok)) == [True, False, True, True]


@pytest.mark.parametrize("N", [pk.KERNEL_MAX_N, pk.KERNEL_MAX_N + 1])
def test_vmap_rule_chooses_kernel_by_n(monkeypatch, N):
    """Under vmap, N ≤ KERNEL_MAX_N goes to the kernel entry and larger N to
    the vmapped plain path."""
    called = []
    monkeypatch.setattr(
        pk, "batched_ldlt_solve_pallas",
        lambda W, r, t: (called.append(W.shape) or jnp.zeros_like(r), jnp.ones_like(r)),
    )
    W = jnp.broadcast_to(jnp.eye(N), (2, N, N))
    x, _ = jax.vmap(lambda Wi, ri: pk.fused_ldlt_solve(Wi, ri, TOL, nb=23))(W, jnp.ones((2, N)))
    assert bool(called) == pk.use_kernel(N) == (N <= pk.KERNEL_MAX_N)
    if not called:
        np.testing.assert_allclose(np.asarray(x), 1.0)


@pytest.mark.parametrize("N", [5, 73])
def test_kernel_block_shapes(N):
    Np, TB = pk.kernel_block(N)
    assert Np >= N and Np & (Np - 1) == 0 and TB & (TB - 1) == 0
    assert TB * Np * Np <= 2048 or TB == 1


def test_lowering_platform_choice():
    """Interpreter HLO on CPU, the Triton custom call when lowered for CUDA,
    and an error for any other platform."""
    f = jax.jit(lambda W, b: pk.batched_ldlt_solve_pallas(W, b, TOL))
    args = (jnp.zeros((4, 5, 5), jnp.float32), jnp.zeros((4, 5), jnp.float32))
    cpu = f.trace(*args).lower(lowering_platforms=("cpu",)).as_text()
    cuda = f.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" not in cpu
    assert "__gpu$xla.gpu.triton" in cuda
    with pytest.raises(NotImplementedError):
        f.trace(*args).lower(lowering_platforms=("rocm",))


def test_sharded_vsolve_matches_one_device():
    """vsolve(mesh=...) on four virtual devices: shard_map runs the kernel
    per shard, no all-gather, lanes equal to the one-device solve."""
    import bench

    pb = bench.build_problem(jnp.float32)
    B = 32
    x0s, datas = (jnp.asarray(a, jnp.float32) for a in bench.ladder_inputs(B))
    s = CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full", dtype=jnp.float32)
    mesh = make_batch_mesh(jax.devices()[:4])
    one = vsolve(pb, x0s, data_batch=datas, solver=s, max_iter=50)
    four = vsolve(pb, x0s, data_batch=datas, solver=s, max_iter=50, mesh=mesh)
    assert four.states.x.sharding.device_set == set(jax.devices()[:4])
    np.testing.assert_array_equal(four.solution, one.solution)
    np.testing.assert_array_equal(four.status, one.status)
    sh = NamedSharding(mesh, P("batch"))
    txt = s.batch_runner(True, None, mesh).lower(
        jax.device_put(x0s, sh), jax.device_put(jnp.zeros((B, 1), jnp.float32), sh),
        s.make_config(max_iter=50), jax.device_put(datas, sh),
    ).compile().as_text()
    assert "all-gather" not in txt


@pytest.mark.gpu
def test_kernel_compiles_to_triton_on_gpu(gpu):
    """On a card: the batched kernel lowers to a Triton custom call, compiles
    and agrees with both references (chip_smoke.py phase 1)."""
    row = cs.phase_kernel(73, 256)
    assert row["worst_bwd_err"] <= cs.KERNEL_BWD_TOL
