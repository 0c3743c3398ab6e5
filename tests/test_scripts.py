"""Smoke tests for the repo-root scripts and benchmark runners — guards the
surfaces the round driver exercises (``bench.py`` JSON line, the
``__graft_entry__`` entry points, battery collection) against bit-rot."""

import importlib.util
import pathlib
import sys

import jax
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_tiny_config_runs():
    bench = _load("bench_mod", ROOT / "bench.py")
    import jax.numpy as jnp

    problem = bench.build_problem(jnp.float32)
    value, summary, dt, res = bench.run_config(problem, "ldlt", 8, None, jnp.float32, reps=1)
    assert res.solution.shape == (8, 2)
    assert value > 0 and dt > 0
    assert summary["solved"] >= 6  # tiny perturbations of a benign family


def test_full_battery_collect():
    fb = _load("full_battery_mod", ROOT / "benchmarks" / "full_battery.py")
    items = fb.collect()
    names = [name for (_, name, _, _) in items]
    assert len(items) >= 90
    assert len(set(names)) == len(names), "duplicate battery entries"
    fams = {fam for (fam, _, _, _) in items}
    assert fams == {"mgh", "mgh_ext", "mgh_con", "hs", "lvcon"}
    # every entry must at least construct
    for _, name, make, _ in items[:: len(items) // 10]:
        pb = make()
        assert pb.nvar > 0, name


def test_graft_entry_single_device():
    ge = _load("graft_entry_mod", ROOT / "__graft_entry__.py")
    fn, args = ge.entry()
    x, status, fx = jax.jit(fn)(*args)
    jax.block_until_ready(x)
    assert x.shape == (8, 2) and status.shape == (8,)
    assert np.isfinite(np.asarray(fx)).all()


def test_graft_entry_multichip_dryrun():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    ge = _load("graft_entry_mod2", ROOT / "__graft_entry__.py")
    ge.dryrun_multichip(8)
