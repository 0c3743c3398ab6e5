#!/usr/bin/env python
"""Batched LDLᵀ factor + solve on the GPU: the Triton kernel
(``ops/pallas_ldlt.py``) against XLA's vmapped plain path (``ops/ldlt.py``).

For each (N, B) cell: compile time and ``memory_analysis()`` of the kernel,
its worst relative backward error and pivot-sign agreement with the plain
path, and the median device time of both (host clock around
``block_until_ready``, after a warm-up call).  ``--warps`` re-times the
kernel at other warp counts per program.

``--e2e`` instead times the two batched cells of ``chip_smoke.py`` end to
end with each backend, in the order kernel, plain, plain, kernel: the
ladder (``bench.run_config``, N = 5, B = 65,536, chunk 16,384) and the
256-scene bundle adjustment (condensed N = 73).  It also solves the
bundle adjustment and the 8192×1024 fit with the JᵀJ condensation at the
default precision and pinned to 'highest'.

    python benchmarks/ldlt_kernel_study.py [--cells 5:65536,73:256] [--warps 4,8,16]
    python benchmarks/ldlt_kernel_study.py --e2e
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import backward_error, kkt_batch  # noqa: E402


def median_time(f, *args, reps=20):
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    from cannoles_tpu.ops import pallas_ldlt as pk
    from cannoles_tpu.ops.ldlt import ldlt_factor, ldlt_solve

    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="5:65536,73:256,128:256")
    ap.add_argument("--warps", default="")
    ap.add_argument("--e2e", action="store_true")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    if args.e2e:
        return end_to_end(card)
    tol = 1e-7

    def one(W, b):
        fac = ldlt_factor(W, tol, nb=32)
        return ldlt_solve(fac, b, tol), fac.vec

    plain = jax.jit(jax.vmap(one))
    kern = jax.jit(lambda W, b: pk.batched_ldlt_solve_pallas(W, b, tol))
    rng = np.random.default_rng(0)
    for cell in args.cells.split(","):
        N, B = (int(v) for v in cell.split(":"))
        W, b, n = kkt_batch(rng, B, N)
        Wd, bd = jnp.asarray(W), jnp.asarray(b)
        t0 = time.perf_counter()
        lowered = kern.lower(Wd, bd)
        compiled = lowered.compile()
        t_compile = time.perf_counter() - t0
        assert "__gpu$xla.gpu.triton" in compiled.as_text(), "no Triton call"
        x, d = compiled(Wd, bd)
        xr, dr = plain(Wd, bd)
        row = {
            "N": N, "B": B, "block": pk.kernel_block(N),
            "compile_s": round(t_compile, 3),
            "mem": str(compiled.memory_analysis()),
            "bwd_err_kernel": float(backward_error(W, x, b).max()),
            "bwd_err_plain": float(backward_error(W, xr, b).max()),
            "inertia_equal": bool((np.sign(np.asarray(d)) == np.sign(np.asarray(dr))).all()),
            "inertia_expected": bool((np.asarray(d)[:, :n] > 0).all() and (np.asarray(d)[:, n:] < 0).all()),
            "kernel_ms": median_time(compiled, Wd, bd) * 1e3,
            "plain_ms": median_time(plain, Wd, bd) * 1e3,
            "card": card,
        }
        for w in [int(v) for v in args.warps.split(",") if v]:
            row.setdefault("warps_ms", {})[w] = _time_warps(pk, Wd, bd, N, w, tol)
        print(json.dumps(row), flush=True)


def _time_warps(pk, Wd, bd, N, warps, tol):
    """Kernel time with ``warps`` warps per program (same block otherwise)."""
    real = pk._NUM_WARPS
    pk._NUM_WARPS = warps
    pk._build_call.cache_clear()
    try:
        f = jax.jit(lambda W, b: pk.batched_ldlt_solve_pallas(W, b, tol))
        return median_time(f, Wd, bd) * 1e3
    finally:
        pk._NUM_WARPS = real
        pk._build_call.cache_clear()


def end_to_end(card):
    import bench
    import chip_smoke
    from cannoles_tpu import CaNNOLeSSolver
    from cannoles_tpu.core.solver import resolve_auto
    from cannoles_tpu.models.families import bundle_adjustment_batch
    from cannoles_tpu.parallel.batch import vsolve

    chip_smoke._setup_jax()
    f32 = jnp.float32
    ladder = bench.build_problem(f32)
    pb, x0s, datas, _ = bundle_adjustment_batch(256, 3, 16, dtype=f32)

    def ba_solver(linsolve, critical=None):
        s = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve=linsolve, dtype=f32)
        if critical is not None:
            s._critical_precision = critical
        return s

    def ba_time(solver, reps=3):
        t0 = time.perf_counter()
        res = vsolve(pb, x0s, data_batch=datas, solver=solver, max_iter=40)
        jax.block_until_ready(res.states.x)
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(reps):
            res = vsolve(pb, x0s, data_batch=datas, solver=solver, max_iter=40)
            jax.block_until_ready(res.states.x)
        return res, setup, (time.perf_counter() - t0) / reps

    for linsolve in ("pallas", "ldlt", "ldlt", "pallas"):
        t0 = time.perf_counter()
        _, summ, dt, _ = bench.run_config(ladder, linsolve, 65536, 16384, f32)
        print(json.dumps({"cell": "ladder", "linsolve": linsolve, "run_s": dt,
                          "setup_plus_runs_s": time.perf_counter() - t0,
                          "solved": summ["solved"], "card": card}), flush=True)
    for linsolve in ("pallas", "ldlt", "ldlt", "pallas"):
        res, setup, dt = ba_time(ba_solver(linsolve))
        print(json.dumps({"cell": "ba", "linsolve": linsolve, "run_s": dt, "setup_s": setup,
                          "solved": int(res.solved_mask().sum()), "card": card}), flush=True)

    pb64, x0s64, datas64, _ = bundle_adjustment_batch(256, 3, 16, dtype=jnp.float64)
    for critical in ("high", "highest"):
        res, setup, dt = ba_time(ba_solver("pallas", critical), reps=1)
        row = {"cell": "ba_precision", "condensation": critical, "run_s": dt,
               "solved": int(res.solved_mask().sum()), "card": card}
        row.update(chip_smoke.host_check(
            pb64, pb, res.solution, res.multipliers, x0s64, datas64,
            dict(method="gauss_newton", kkt="condensed", max_iter=40)))
        print(json.dumps(row), flush=True)

    big, xtrue = bench.build_large_problem(dtype=f32)
    linsolve, kkt, robust = resolve_auto(big, "gauss_newton", "auto", "auto")
    for critical in ("high", "highest"):
        s = CaNNOLeSSolver(big, method="gauss_newton", linsolve=linsolve, kkt=kkt,
                           robust_fallback=robust)
        s._critical_precision = critical
        st = s.solve(max_time=900.0)
        t0 = time.perf_counter()
        st = s.solve(max_time=900.0)
        print(json.dumps({"cell": "large_precision", "condensation": critical,
                          "status": st.status, "iter": st.iter,
                          "x_err": float(np.abs(np.asarray(st.solution) - np.asarray(xtrue)).max()),
                          "run_s": time.perf_counter() - t0, "card": card}), flush=True)


if __name__ == "__main__":
    main()
