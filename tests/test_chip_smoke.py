"""chip_smoke.py on the CPU: its phase functions at tiny sizes (the kernel
in interpret mode), and its refusal to run without a GPU or without the
rest of the repository."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from cannoles_tpu.ops.pallas_ldlt import KERNEL_MAX_N  # noqa: E402


@pytest.mark.parametrize("N,B", [(5, 40), (73, 4)])
def test_phase_kernel_tiny(N, B):
    row = cs.phase_kernel(N, B)
    assert row["worst_bwd_err"] <= cs.KERNEL_BWD_TOL
    assert row["skipped_lanes"] == min(4, B // 2)


def test_phase_kernel_rejects_non_kernel_size():
    with pytest.raises(cs.SmokeFailure):
        cs.phase_kernel(KERNEL_MAX_N + 1, 2)


def test_phase_ladder_tiny():
    row = cs.phase_ladder(B=128, chunk=64, sample=32)
    assert row["solved"] == "128/128"
    assert row["worst_dx_vs_f64"] <= row["worst_dx_tol"]


def test_phase_ba_tiny():
    row = cs.phase_ba(4, 3, 16)
    assert row["N"] == 73 and row["linsolve"] == "pallas" and row["solved"] == "4/4"


def test_phase_large_tiny():
    row = cs.phase_large(256, 16)
    assert (row["linsolve"], row["kkt"], row["status"]) == ("chol", "condensed", "first_order")


def test_four_card_phases_on_virtual_devices():
    devs = jax.devices()[:4]
    row = cs.phase_four_ladder(devs, B_per_card=64, chunk=64)
    assert row["device_set"] == sorted(d.id for d in devs)
    assert [s[1] for s in row["shards"]] == [(64, 2)] * 4
    assert row["dx_vs_one_card"] <= cs.SHARD_X_TOL
    row = cs.phase_four_large(devs, 256, 16)
    assert all(len(ids) == 4 for ids, _ in row["data_placement"].values())


def test_check_raises():
    cs.check(np.True_, "fine")
    with pytest.raises(cs.SmokeFailure, match="broken"):
        cs.check(False, "broken")


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("flag", [[], ["--four"]])
def test_refuses_without_gpu(flag):
    p = _run([str(ROOT / "chip_smoke.py"), *flag], ROOT)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_refuses_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = _run(["chip_smoke.py"], tmp_path)
    assert p.returncode != 0
    assert not any(line.startswith("{") and json.loads(line).get("ok")
                   for line in p.stdout.splitlines() if line.strip())
