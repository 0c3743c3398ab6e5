"""Round-5 fixes: dense-engine multiplier refit (dual-floor escape parity
with the matfree engines), vsolve dispatch gaps (kkt='auto' routing, rescue
under deadline dispatch, rescue with an already-gated solver), and the
checkpoint Jx→JxT migration."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cannoles_tpu import CaNNOLeSSolver, nls_problem
from cannoles_tpu.parallel import batch as batch_mod
from cannoles_tpu.parallel.batch import vsolve


def _ba_scene_f32():
    from cannoles_tpu.models.ba_large import large_bundle_adjustment

    return large_bundle_adjustment(3, 12, noise=0.0, seed=0, dtype=jnp.float32)


def test_dense_multiplier_refit_escapes_stale_dual():
    """The dense engine's per-outer CGLS multiplier refit (round-5 port of
    core/matfree.py's multiplier_refit) must rescue a stale warm-start
    multiplier that the bare λ ← λ − c/δ walk cannot: with c(x) ≈ 0 the
    walk moves λ at rate ~c/δ per iteration, so a wrong λ0 costs dozens of
    outer iterations (measured 33 vs 9 on this f32 gauge-constrained BA
    scene) — at a fixed budget the un-refit solver floors at max_iter while
    the refit one reaches first_order."""
    pb, _ = _ba_scene_f32()
    lam0 = jnp.asarray(np.r_[300.0 * np.ones(6), -200.0], dtype=jnp.float32)
    tol = dict(atol=1e-5, rtol=0.0, Fatol=0.0, Frtol=0.0, max_iter=16)
    out = {}
    for refit in (False, True):
        s = CaNNOLeSSolver(
            pb, method="lm", kkt="condensed", linsolve="chol",
            multiplier_refit=refit, use_initial_multiplier=True,
            dtype=jnp.float32,
        )
        out[refit] = s.solve(lam0=lam0, max_time=600.0, **tol)
    assert out[True].status == "first_order", out[True].status
    assert out[False].status != "first_order", (
        "the no-refit run converged within the budget — the floor scenario "
        f"no longer reproduces (status={out[False].status})"
    )


def test_dense_refit_never_degrades():
    """The refit is kept only where it strictly improves the dual norm, so
    on a problem that converges fine without it the trajectory end point
    must be just as good (guard against the refit fighting the aug-Lag
    update)."""
    pb, x_true = _ba_scene_f32()
    for refit in (False, True):
        st = CaNNOLeSSolver(
            pb, method="lm", kkt="condensed", linsolve="chol",
            multiplier_refit=refit, dtype=jnp.float32,
        ).solve(max_time=600.0, atol=1e-5, rtol=0.0, max_iter=60)
        assert st.status in ("first_order", "small_residual"), st.status


def _tall_family():
    """m ≫ n family: m = 62, n = 2 → resolve_auto picks the condensed form."""
    A = jnp.asarray(np.random.default_rng(0).normal(size=(62, 2)))
    y = A @ jnp.asarray([1.0, -2.0])

    def residual(x, d):
        return A @ x - y

    return nls_problem(residual, jnp.zeros(2), 62, name="tall")


def test_vsolve_kkt_auto_routes_condensed():
    """vsolve's default solver construction must route kkt through the same
    measured-best policy as cannoles() (round-4 finding: it hardcoded
    kkt='full', so batched m ≫ n families never got the condensed path)."""
    pb = _tall_family()
    x0s = jnp.zeros((4, 2))
    res = vsolve(pb, x0s, method="gauss_newton", max_iter=50)
    assert res.solver is not None
    assert res.solver.kkt == "condensed", res.solver.kkt
    assert res.solved_mask().all(), res.summary()
    # explicit kkt is honored
    res2 = vsolve(pb, x0s, method="gauss_newton", kkt="full", max_iter=50)
    assert res2.solver.kkt == "full"
    assert res2.solved_mask().all()


def test_vsolve_rescue_honored_under_deadline(monkeypatch):
    """rescue=True must not be silently dropped under max_time deadline
    dispatch (round-4 finding): when budget remains after dispatch, the
    rescue pass runs on dispatched-but-failed lanes."""
    pb = _tall_family()
    x0s = jnp.zeros((4, 2))
    calls = {}
    orig = batch_mod._rescue_unsolved

    def spy(solver, result, x0, lam0, data, cfg, **kw):
        calls["kw"] = kw
        return orig(solver, result, x0, lam0, data, cfg, **kw)

    monkeypatch.setattr(batch_mod, "_rescue_unsolved", spy)
    res = vsolve(pb, x0s, method="gauss_newton", max_time=600.0, rescue=True, max_iter=50)
    assert "kw" in calls, "rescue pass never invoked under deadline dispatch"
    assert calls["kw"].get("eligible") is not None
    assert res.solved_mask().all()


def test_vsolve_rescue_gated_solver_still_runs_eigh(monkeypatch):
    """With a solver that already runs quality-gated, rescue=True must skip
    only the redundant stage 1 and still offer the eigh stage (round-4
    advisor finding: it was a silent no-op)."""
    pb = _tall_family()
    solver = CaNNOLeSSolver(pb, method="gauss_newton", kkt="full", quality_gate=True)
    x0s = jnp.zeros((4, 2))
    calls = {}
    orig = batch_mod._rescue_unsolved

    def spy(s, result, x0, lam0, data, cfg, **kw):
        calls["kw"] = kw
        return orig(s, result, x0, lam0, data, cfg, **kw)

    monkeypatch.setattr(batch_mod, "_rescue_unsolved", spy)
    res = vsolve(pb, x0s, solver=solver, rescue=True, max_iter=50)
    assert "kw" in calls, "rescue silently skipped for a gated solver"
    assert calls["kw"].get("skip_stage1") is True
    assert res.solved_mask().all()


def test_checkpoint_jx_migration(tmp_path):
    """Pre-round-4 checkpoints stored the dense Jacobian as Jx (m, n);
    load_state must migrate them to JxT (n, m) instead of failing with an
    opaque TypeError (round-4 advisor finding)."""
    import json

    from cannoles_tpu.utils.checkpoint import load_state, save_state

    pb = _tall_family()
    s = CaNNOLeSSolver(pb, method="gauss_newton", kkt="full")
    cfg = s.make_config()
    state = s._init_fn(pb.x0, pb.y0, cfg, pb.data)
    path = tmp_path / "new.npz"
    save_state(path, state)

    # rewrite the file as an old-format checkpoint: JxT (n, m) → Jx (m, n)
    with np.load(path, allow_pickle=False) as z:
        leaves = {k: z[k] for k in z.files}
    meta = json.loads(str(leaves.pop("__meta__")))
    meta["fields"] = ["Jx" if f == "JxT" else f for f in meta["fields"]]
    leaves["Jx"] = np.swapaxes(leaves.pop("JxT"), -2, -1)
    old_path = tmp_path / "old.npz"
    np.savez(old_path, __meta__=json.dumps(meta), **leaves)

    loaded = load_state(old_path)
    assert np.array_equal(np.asarray(loaded.JxT), np.asarray(state.JxT))
    # and the migrated state resumes cleanly
    st = s.solve(resume_from=loaded, max_time=60.0)
    assert st.status in ("first_order", "small_residual"), st.status


def test_descent_rescue_repairs_nondescent_lanes_in_graph():
    """In-graph descent rescue (round 5): an unpivoted f32 LDLᵀ can pass the
    pivot-sign inertia test at ρ=0 yet deliver a non-descent direction
    (Dϕ ≥ 0), which the reference turns into a hard line-search error
    (CaNNOLeS.jl:1085) and which previously required the host-side
    ``vsolve(rescue=True)`` re-solve.  ``descent_rescue`` (default on)
    re-enters the ρ ladder with the backward-error gate forced on for
    exactly those lanes, inside the compiled program.  The bench family at
    f32 with the headline seed reproduces the failure deterministically."""

    def residual(x, d):
        return jnp.array([x[0] - d[0], 10 * (x[1] - x[0] ** 2) - d[1]])

    def cons(x, d):
        return jnp.array([x[0] + x[1] - d[2]])

    dtype = jnp.float32
    pb = nls_problem(
        residual, jnp.array([-1.2, 1.0], dtype=dtype), 2, cons, [0.0], [0.0],
        data=jnp.zeros((3,), dtype=dtype), name="descent_rescue_family",
    )
    B = 4096
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.normal(scale=0.5, size=(B, 2)) + [-1.2, 1.0], dtype=dtype)
    datas = jnp.asarray(
        np.stack(
            [1 + 0.2 * rng.normal(size=B), 0.1 * rng.normal(size=B),
             1 + 0.2 * rng.normal(size=B)], axis=1,
        ),
        dtype=dtype,
    )

    def run(dr):
        s = CaNNOLeSSolver(
            pb, method="lm", linsolve="ldlt", kkt="full", dtype=dtype,
            quality_gate=False, descent_rescue=dr,
        )
        return vsolve(pb, x0s, data_batch=datas, solver=s, max_iter=50)

    r_off = run(False)
    bad = ~r_off.solved_mask()
    # the failure mode this feature targets must actually occur (msg 5 =
    # "Dϕ ≥ 0"); otherwise the test is vacuous
    assert bad.any() and np.all(np.asarray(r_off.states.msg)[bad] == 5)

    r_on = run(True)
    assert int(r_on.summary()["solved"]) == B
    # untouched lanes keep identical iterates: the rescue is surgical
    good = ~bad
    np.testing.assert_array_equal(
        np.asarray(r_on.states.x)[good], np.asarray(r_off.states.x)[good]
    )


def test_descent_rescue_neutral_on_f64_trajectories():
    """With healthy f64 factorizations the rescue ladders never trigger:
    the full solve trajectory is bit-identical with the feature on or off
    (it only stages zero-trip while_loops)."""
    pb = nls_problem(
        lambda x: jnp.array([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
        jnp.array([-1.2, 1.0]), 2,
        lambda x: jnp.array([x[0] + x[1] - 1.0]), [0.0], [0.0],
        name="rosenbrock_eq",
    )
    outs = []
    for dr in (False, True):
        s = CaNNOLeSSolver(pb, method="newton", linsolve="ldlt", descent_rescue=dr)
        st = s.solve()
        outs.append((st.status, np.asarray(st.solution), st.iter))
    assert outs[0][0] == outs[1][0] == "first_order"
    assert outs[0][2] == outs[1][2]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_max_time_budget_excludes_first_compile(monkeypatch):
    """solve() excludes jit compilation from the max_time budget (round 5):
    a cold XLA compile of the outer step can exceed max_time by itself and
    must not stamp max_time before one iteration has run.  Simulated by
    jumping the wall clock +100 s during the warmup (= compile slot) call:
    the solve must still converge under max_time=30."""
    import time as _time

    import cannoles_tpu.core.solver as solver_mod

    pb = nls_problem(
        lambda x: jnp.array([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
        jnp.array([-1.2, 1.0]), 2, name="clockjump",
    )
    s = CaNNOLeSSolver(pb)
    real_time = _time.time
    pending = {"jump": 100.0}
    orig_outer = s._outer_fn

    def outer_with_clock_jump(st, cfg):
        out = orig_outer(st, cfg)
        if pending["jump"]:
            shift = pending.pop("jump", 0.0) or 0.0
            pending["jump"] = 0.0
            monkeypatch.setattr(solver_mod.time, "time", lambda: real_time() + shift)
        return out

    monkeypatch.setattr(s, "_outer_fn", outer_with_clock_jump)
    st = s.solve(max_time=30.0)
    assert st.status == "first_order", (
        "compile-slot wall time leaked into the max_time budget: "
        f"{st.status}"
    )


def test_rescue_budget_stage_resolves_capped_stragglers():
    """Straggler mitigation (round 5): ``vsolve(max_eval=<small>,
    rescue=True)`` is the batch straggler policy — a vmapped chunk runs in
    lockstep to its slowest lane, so the fast pass may cap the eval budget
    (lanes exceeding it exit ``max_eval``) and the rescue's budget stage 0
    re-solves exactly those lanes on the PRIMARY solver with the reference
    budgets.  Routing matters: re-solving budget-stalled lanes through the
    gated stage can hit the backward-error gate's batch-shape knife edge
    and punt convergent lanes onto the slow eigh tail."""

    def residual(x, d):
        return jnp.array([x[0] - d[0], 10 * (x[1] - x[0] ** 2) - d[1]])

    def cons(x, d):
        return jnp.array([x[0] + x[1] - d[2]])

    dtype = jnp.float32
    pb = nls_problem(
        residual, jnp.array([-1.2, 1.0], dtype=dtype), 2, cons, [0.0], [0.0],
        data=jnp.zeros((3,), dtype=dtype), name="straggler_family",
    )
    B = 512
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.normal(scale=0.5, size=(B, 2)) + [-1.2, 1.0], dtype=dtype)
    datas = jnp.asarray(
        np.stack(
            [1 + 0.2 * rng.normal(size=B), 0.1 * rng.normal(size=B),
             1 + 0.2 * rng.normal(size=B)], axis=1,
        ),
        dtype=dtype,
    )
    solver = CaNNOLeSSolver(pb, method="lm", linsolve="ldlt", kkt="full", dtype=dtype)

    capped = vsolve(pb, x0s, data_batch=datas, solver=solver, max_iter=50, max_eval=6)
    n_budget = int((np.asarray(capped.states.status) == 5).sum())  # max_eval
    assert n_budget > 0, "cap must actually bind for this test to mean anything"

    rescued = vsolve(
        pb, x0s, data_batch=datas, solver=solver, max_iter=50, max_eval=6,
        rescue=True,
    )
    st = np.asarray(rescued.states.status)
    assert int((st == 5).sum()) == 0, "budget-capped lanes must be re-solved"
    # the rescue must reach the same solve set as a fully uncapped run
    full = vsolve(pb, x0s, data_batch=datas, solver=solver, max_iter=50)
    assert rescued.summary()["solved"] >= full.summary()["solved"]
