"""Batched vmapped solves + mesh sharding (BASELINE configs 3/5; new
capability, no reference analog — SURVEY.md §2.3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cannoles_tpu import CaNNOLeSSolver, cannoles, nls_problem
from cannoles_tpu.parallel.batch import make_batch_mesh, vsolve


def _family():
    def residual(x, d):
        return jnp.array([x[0] - d[0], 10 * (x[1] - x[0] ** 2)])

    def cons(x, d):
        return jnp.array([x[0] + x[1] - d[1]])

    return nls_problem(
        residual,
        jnp.array([-1.2, 1.0]),
        2,
        cons,
        [0.0],
        [0.0],
        data=jnp.zeros((2,)),
        name="family",
    )


def test_vsolve_matches_scalar_solve():
    pb = _family()
    B = 4
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.normal(scale=0.2, size=(B, 2)) + np.array([-1.2, 1.0]))
    datas = jnp.asarray(np.stack([np.ones(B), np.ones(B)], axis=1) + 0.1 * rng.normal(size=(B, 2)))

    res = vsolve(pb, x0s, data_batch=datas, max_iter=100)
    assert res.solved_mask().all(), res.summary()

    # lane 0 must match a scalar solve of the same instance
    import dataclasses

    pb0 = dataclasses.replace(pb, data=datas[0])
    stats0 = cannoles(pb0, x=x0s[0])
    assert np.allclose(res.solution[0], stats0.solution, atol=1e-8), (
        res.solution[0], stats0.solution)
    assert int(res.iterations[0]) == stats0.iter


def test_vsolve_diverging_lane_does_not_kill_batch():
    """One pathological instance must not prevent the others from solving
    (the reference would raise; SURVEY.md §5 failure handling)."""
    def residual(x, d):
        # d[0]=1 lane is fine; huge d[0] makes an ill-scaled instance
        return jnp.array([d[0] * (x[0] - 1), 10 * (x[1] - x[0] ** 2)])

    pb = nls_problem(residual, jnp.array([-1.2, 1.0]), 2, data=jnp.ones((1,)), name="mix")
    datas = jnp.array([[1.0], [1.0], [1e30], [1.0]])
    x0s = jnp.broadcast_to(jnp.array([-1.2, 1.0]), (4, 2))
    res = vsolve(pb, x0s, data_batch=datas, max_iter=50)
    ok = res.solved_mask()
    assert ok[0] and ok[1] and ok[3]
    assert np.isfinite(res.solution[[0, 1, 3]]).all()


def test_vsolve_sharded_over_mesh():
    pb = _family()
    mesh = make_batch_mesh()  # 8 virtual CPU devices from conftest
    B = 16
    rng = np.random.default_rng(1)
    x0s = jnp.asarray(rng.normal(scale=0.2, size=(B, 2)) + np.array([-1.2, 1.0]))
    datas = jnp.ones((B, 2))
    res = vsolve(pb, x0s, data_batch=datas, mesh=mesh, max_iter=100)
    assert res.solved_mask().all(), res.summary()
    # every lane must land on a first-order point satisfying the constraint
    # (the problem has two basins; different x0 → possibly different basin)
    assert np.allclose(res.solution.sum(axis=1), 1.0, atol=1e-6)


def test_vsolve_chunk_fallback_warns():
    pb = _family()
    x0s = jnp.broadcast_to(jnp.array([-1.2, 1.0]), (6, 2))
    datas = jnp.ones((6, 2))
    with pytest.warns(UserWarning, match="chunk_size=4 ignored"):
        res = vsolve(pb, x0s, data_batch=datas, max_iter=100, chunk_size=4)
    assert res.solved_mask().all()


def test_vsolve_max_time_budget():
    """Wall-clock budget inside batched solves (reference max_time semantics,
    CaNNOLeS.jl:123-125): a tiny budget on a chunked batch must return
    promptly with honest per-lane max_time statuses for undispatched chunks."""
    import time as _time

    from cannoles_tpu.core.status import Status

    pb = _family()
    B, chunk = 16, 4
    rng = np.random.default_rng(2)
    x0s = jnp.asarray(rng.normal(scale=0.2, size=(B, 2)) + np.array([-1.2, 1.0]))
    datas = jnp.ones((B, 2))

    # warm the compile outside the timed run (budget is for solve time)
    vsolve(pb, x0s[:chunk], data_batch=datas[:chunk], max_iter=100, max_time=10.0,
           chunk_size=chunk)

    t0 = _time.time()
    res = vsolve(pb, x0s, data_batch=datas, max_iter=100, max_time=0.0, chunk_size=chunk)
    elapsed = _time.time() - t0
    st = res.status
    # first chunk always dispatches; the deadline (0 s) then expires, so the
    # remaining lanes must be honest max_time statuses, not fake solves
    assert res.solved_mask()[:chunk].all()
    assert (st[chunk:] == Status.MAX_TIME).all(), st
    assert elapsed < 30.0  # prompt return (one chunk solve + init evals)
    # budget generous enough -> everything solves, no max_time lanes
    res2 = vsolve(pb, x0s, data_batch=datas, max_iter=100, max_time=60.0, chunk_size=chunk)
    assert res2.solved_mask().all(), res2.summary()


def test_graft_entry_compiles():
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", pathlib.Path(__file__).parent.parent / "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    xs, status, fx = jax.tree.map(jax.block_until_ready, out)
    assert xs.shape[0] == args[0].shape[0]
    mod.dryrun_multichip(8)


def test_vsolve_chunk_equal_to_batch_no_warning():
    """chunk_size == B asks for exactly one chunk — the flat vmap is that;
    no spurious 'not a positive multiple' warning (round-3 advisor item)."""
    import warnings as _warnings

    pb = _family()
    x0s = jnp.broadcast_to(jnp.array([-1.2, 1.0]), (4, 2))
    datas = jnp.ones((4, 2))
    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        res = vsolve(pb, x0s, data_batch=datas, max_iter=100, chunk_size=4)
    assert res.solved_mask().all()


def test_scaling_bench_inserts_single_device_baseline():
    """Efficiency must be normalized to a true 1-device run even when the
    caller passes device_counts starting above 1 (round-3 VERDICT weak #8)."""
    from cannoles_tpu.parallel.multihost import scaling_bench

    pb = _family()
    B = 8
    rng = np.random.default_rng(3)
    x0s = rng.normal(scale=0.2, size=(B, 2)) + np.array([-1.2, 1.0])
    datas = jnp.ones((B, 2))
    rows = scaling_bench(
        pb, x0s, data_batch=datas, device_counts=[2, 4], max_iter=50, reps=1,
        kkt="full", method="newton",
    )
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert all(r["baseline_devices"] == 1 for r in rows)
    assert rows[0]["efficiency"] == pytest.approx(1.0)


def test_vsolve_rescue_merge_path():
    """rescue=True: unsolved lanes are re-solved gate-on and merged; solved
    lanes are untouched; a structurally broken lane stays honestly broken."""
    def residual(x, d):
        return jnp.array([d[0] * (x[0] - 1), 10 * (x[1] - x[0] ** 2)])

    pb = nls_problem(residual, jnp.array([-1.2, 1.0]), 2, data=jnp.ones((1,)), name="mix")
    datas = jnp.array([[1.0], [1.0], [1e30], [1.0]])
    x0s = jnp.broadcast_to(jnp.array([-1.2, 1.0]), (4, 2))
    res0 = vsolve(pb, x0s, data_batch=datas, max_iter=50)
    res1 = vsolve(pb, x0s, data_batch=datas, max_iter=50, rescue=True)
    assert res1.solved_mask().tolist() == [True, True, False, True]
    assert np.array_equal(res0.solution[[0, 1, 3]], res1.solution[[0, 1, 3]])
