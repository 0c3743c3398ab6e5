#!/usr/bin/env python
"""Headline benchmark: batched LM instances/s per card + compute-representative
rungs (batched bundle adjustment, one large dense NLS) with a FLOP-model
utilization estimate.

Target from BASELINE.json: >= 1000 batched LM constrained-NLS instances/s per
chip (the reference is a single-CPU solver with no published numbers —
BASELINE.md).  vs_baseline = value / 1000.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
"extra" names the device (JAX platform, device kind, count, and the card's
name and power limit from nvidia-smi) and carries the compute-bound rungs:

* ``ba_scenes_per_s`` / ``ba_solved`` / ``ba_mfu_pct`` — 256 independent
  gauge-constrained bundle-adjustment scenes (66 params, 96 reprojection
  residuals, 7 equality constraints; condensed KKT N=73) in one compiled
  vsolve with the batched LDLᵀ kernel.
* ``large_ms_per_solve`` / ``large_mfu_pct`` — one 8192x1024 dense NLS,
  Gauss-Newton + condensed Schur + two-level Cholesky (BASELINE config 4).

Utilization model (documented lower bound, not a profiler number): counts
only the provable dense-algebra FLOPs actually executed, read from the
solver's own counters — Jacobian builds (n JVPs ~ 2x residual cost each),
J'J condensation (2mn^2), factorizations ((2/3)N^3 per attempt from nfact) —
divided by device-side time and the card's peak (``_PEAK_BF16``, keyed by
``device_kind``; an unknown device is an error).  Device-side time comes from
in-graph repetition differencing (``device_time_per_rep``), which removes
the fixed per-dispatch host cost.  Elementwise work, triangular solves and
residual evaluations are excluded from the FLOP count, so true utilization
is strictly higher.

Rungs run under a wall-clock budget (env BENCH_BUDGET, default 450 s) with a
persistent compilation cache (``$JAX_COMPILATION_CACHE_DIR``, else
``.jax_cache/`` beside this file); "extra" carries warmup (compile) and
total wall-clock so compile regressions are visible in the record.  A rung
that fails makes the run exit non-zero after printing what completed.
"""

import json
import os
import pathlib
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# Persistent compilation cache, keyed on program + topology: a warm cache
# makes later runs pure measurement.
_CACHE = os.environ.get(
    "JAX_COMPILATION_CACHE_DIR",
    str(pathlib.Path(__file__).resolve().parent / ".jax_cache"),
)
jax.config.update("jax_compilation_cache_dir", _CACHE)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# Dense bf16 tensor-core peak FLOP/s per card by device_kind: NVIDIA H100
# SXM data sheet, no sparsity, at the full 700 W power limit.
_PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def _peak_flops() -> float:
    kind = jax.devices()[0].device_kind
    if kind not in _PEAK_BF16:
        raise KeyError(f"no peak FLOP/s on record for device kind {kind!r}")
    return _PEAK_BF16[kind]


def card_name():
    """``name, power.limit`` of the first card, from nvidia-smi."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def flop_model(*, n, m, p, kkt, nlinsolve, nfact, residual_flops):
    """Provable LOWER-BOUND dense-algebra FLOPs of one solve, from the
    solver's own counters.

    nlinsolve = KKT systems solved (1 Jacobian + 1 condensation each),
    nfact     = factorization attempts (rho-bump retries included).
    residual_flops = FLOPs of ONE residual evaluation F(x) (problem model).
    Jacobian build via jacfwd = n JVPs billed at exactly 1x residual cost
    each — exact for linear/elementwise-dominated residuals, an undercount
    for transcendental-heavy ones.  The constraint Jacobian, elementwise
    work, triangular solves and line-search evaluations are all excluded,
    so the resulting MFU is a floor, never an estimate.
    """
    N = (n + p) if kkt == "condensed" else (n + m + p)
    per_solve = n * residual_flops         # one (m, n) Jacobian build
    if kkt == "condensed":
        per_solve += 2 * m * n * n         # J'J condensation matmul
    per_fact = (2.0 / 3.0) * N**3          # LDL^T / Cholesky elimination
    return nlinsolve * per_solve + nfact * per_fact


def build_problem(dtype):
    from cannoles_tpu import nls_problem

    def residual(x, d):
        return jnp.array([x[0] - d[0], 10 * (x[1] - x[0] ** 2) - d[1]])

    def cons(x, d):
        return jnp.array([x[0] + x[1] - d[2]])

    return nls_problem(
        residual,
        jnp.array([-1.2, 1.0], dtype=dtype),
        2,
        cons,
        [0.0],
        [0.0],
        data=jnp.zeros((3,), dtype=dtype),
        name="bench_lm_family",
    )


def ladder_inputs(B, seed=0):
    """Seeded starting points (B, 2) and per-lane data (B, 3) of the ladder
    family, as float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    x0s = rng.normal(scale=0.5, size=(B, 2)) + [-1.2, 1.0]
    datas = np.stack(
        [1 + 0.2 * rng.normal(size=B), 0.1 * rng.normal(size=B), 1 + 0.2 * rng.normal(size=B)],
        axis=1,
    )
    return x0s, datas


def ladder_cap(B):
    """The ladder's straggler cap: ``max_eval=48`` from 16,384 lanes up."""
    return {} if B < 16384 else {"max_eval": 48}


def run_config(problem, linsolve, B, chunk, dtype, reps=3):
    """One ladder rung.  The timed runs INCLUDE the host-side rescue pass,
    so the reported rate is the full cost of reaching the reported solved
    count — not a pre-rescue rate paired with a post-rescue count.  The
    rare f32 Dϕ ≥ 0 line-search aborts (bad unpivoted factorizations that
    pass the pivot-sign inertia test) are repaired in-graph by the solver's
    ``descent_rescue``, so the rescue re-solves only the lanes the straggler
    cap stopped.  Returns ``(instances/s, summary with the pre-rescue
    failure breakdown, seconds per timed run, the final BatchResult)``."""
    from cannoles_tpu import CaNNOLeSSolver
    from cannoles_tpu.core.status import MSG, status_name
    from cannoles_tpu.parallel.batch import vsolve

    solver = CaNNOLeSSolver(problem, method="lm", linsolve=linsolve, kkt="full", dtype=dtype)
    x0s, datas = (jnp.asarray(a, dtype=dtype) for a in ladder_inputs(B))

    # Straggler cap: a vmapped chunk runs in lockstep to its slowest lane,
    # and rare pathological lanes burn 100s–1000s of inner iterations
    # (stragglers, not throughput, set the chunk wall).  max_eval=48 bounds
    # the fast pass (the p99 lane needs 18 evals); capped lanes exit
    # `max_eval` and the rescue's budget stage re-solves them as a small
    # gathered subset at the reference budgets.  Small batches skip the cap:
    # the rescue's fixed dispatch cost outweighs the straggler saving there.
    cap = ladder_cap(B)

    def once(rescue):
        r = vsolve(
            problem, x0s, data_batch=datas, solver=solver, max_iter=50,
            chunk_size=chunk, rescue=rescue, **cap,
        )
        jax.block_until_ready(r.states.x)
        return r

    # compile + warmup, and capture the pre-rescue failure breakdown
    pre = once(False)
    bad = ~pre.solved_mask()
    breakdown = {}
    if bad.any():
        st = np.asarray(pre.states.status)[bad]
        ms = np.asarray(pre.states.msg)[bad]
        for s, m in zip(st, ms):
            key = status_name(int(s)) + (f":{MSG[int(m)]}" if int(m) else "")
            breakdown[key] = breakdown.get(key, 0) + 1
    res = once(True)  # warm the rescue-pass compiled shapes
    t0 = time.perf_counter()
    for _ in range(reps):
        res = once(True)  # timed region INCLUDES the rescue pass
    dt = (time.perf_counter() - t0) / reps
    summ = res.summary()
    summ["breakdown_pre_rescue"] = breakdown
    return B / dt, summ, dt, res


def device_time_per_rep(make_fn, *args, R1=2, R2=32, tries=4):
    """Device-side seconds per repetition via in-graph repetition
    differencing: chain R reps inside one jit with a strict data dependency
    and return (t(R2) − t(R1)) / (R2 − R1), so the fixed per-dispatch host
    cost cancels; the scalar fetch is the barrier."""
    f1, f2 = make_fn(R1), make_fn(R2)
    for f in (f1, f2):
        float(f(*args))  # compile + warm
    def t(f):
        t0 = time.perf_counter()
        float(f(*args))
        return time.perf_counter() - t0
    t1 = min(t(f1) for _ in range(tries))
    t2 = min(t(f2) for _ in range(tries))
    return max((t2 - t1) / (R2 - R1), 1e-9)


def run_ba_rung(reps=3):
    """Batched bundle adjustment: the compute-representative constrained rung
    (condensed KKT N=73, batched LDLᵀ kernel)."""
    from jax import lax

    from cannoles_tpu import CaNNOLeSSolver
    from cannoles_tpu.models.families import bundle_adjustment_batch
    from cannoles_tpu.parallel.batch import vsolve

    dtype = jnp.float32
    B, n_cams, n_pts = 256, 3, 16
    pb, x0s, datas, _ = bundle_adjustment_batch(B, n_cams, n_pts, dtype=dtype)
    solver = CaNNOLeSSolver(
        pb, method="gauss_newton", kkt="condensed", linsolve="pallas", dtype=dtype
    )

    def once():
        r = vsolve(pb, x0s, data_batch=datas, solver=solver, max_iter=40)
        jax.block_until_ready(r.states.x)
        return r

    res = once()
    t0 = time.perf_counter()
    for _ in range(reps):
        res = once()
    dt = (time.perf_counter() - t0) / reps

    # device-side batch time (dispatch-free)
    cfg = solver.make_config(max_iter=40)
    vrun = jax.vmap(solver._run_compiled, in_axes=(0, 0, None, 0))
    lam0s = jnp.zeros((B, pb.ncon), dtype)

    def mk(R):
        @jax.jit
        def f(x0s):
            def body(i, acc):
                st = vrun(x0s + acc * 1e-9, lam0s, cfg, datas)
                return acc + st.x[0, 0]
            return lax.fori_loop(0, R, body, jnp.zeros((), dtype))
        return f

    dt_dev = device_time_per_rep(mk, x0s, R1=1, R2=13)

    n, m, p = pb.nvar, pb.nequ, pb.ncon
    # BA residual: per reprojection ~60 flops (Rodrigues + projection)
    res_flops = 60 * m
    total = float(
        sum(
            flop_model(
                n=n, m=m, p=p, kkt="condensed",
                nlinsolve=int(nl), nfact=int(nf), residual_flops=res_flops,
            )
            for nl, nf in zip(np.asarray(res.states.nlinsolve), np.asarray(res.states.nfact))
        )
    )
    mfu = total / dt_dev / _peak_flops() * 100
    summ = res.summary()
    return B / dt, B / dt_dev, f"{summ['solved']}/{B}", mfu, dt


def build_large_problem(m=8192, n=1024, dtype=jnp.float32, seed=0):
    """One large dense NLS ``F(x) = B1 x + 0.1 sin(B2 x) - y`` with a known
    zero-residual solution: returns ``(problem, x_true)``.  Every data leaf
    has the residual dimension m leading, so it row-shards as it stands."""
    from cannoles_tpu import nls_problem

    rng = np.random.default_rng(seed)
    B1 = jnp.asarray(rng.normal(size=(m, n)) / np.sqrt(n), dtype=dtype)
    B2 = jnp.asarray(rng.normal(size=(m, n)) / np.sqrt(n), dtype=dtype)
    xtrue = jnp.asarray(rng.normal(size=n), dtype=dtype)

    def model(x, d):
        return d["B1"] @ x + 0.1 * jnp.sin(d["B2"] @ x)

    data = {"B1": B1, "B2": B2}
    data["y"] = model(xtrue, data)
    pb = nls_problem(
        lambda x, d: model(x, d) - d["y"], jnp.zeros(n, dtype), m, data=data,
        name=f"bench_large_{m}x{n}",
    )
    return pb, xtrue


def run_large_rung():
    """One large dense NLS (8192x1024), Gauss-Newton + condensed + two-level
    Cholesky (BASELINE config 4)."""
    from jax import lax

    from cannoles_tpu import CaNNOLeSSolver

    dtype = jnp.float32
    pb, xtrue = build_large_problem(dtype=dtype)
    m, n = pb.nequ, pb.nvar

    s = CaNNOLeSSolver(
        pb, method="gauss_newton", kkt="condensed", linsolve="chol",
        block_size=256, dtype=dtype,
    )
    cfg = s.make_config(max_iter=30)
    st = s._run_fn(pb.x0, pb.y0, cfg, pb.data)
    jax.block_until_ready(st.x)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        st = s._run_fn(pb.x0, pb.y0, cfg, pb.data)
        jax.block_until_ready(st.x)
    dt = (time.perf_counter() - t0) / reps

    # device-side per-solve (dispatch-free); also the explicit-bf16 commit
    # mode (condensation + gate follow the chosen precision)
    def mk_chain(solver, config):
        def make(R):
            def f(x0):
                def body(i, acc):
                    stt = solver._run_compiled(x0 + acc * 1e-9, pb.y0, config, pb.data)
                    return acc + stt.x[0]
                return lax.fori_loop(0, R, body, jnp.zeros((), dtype))
            return solver._jit(f)
        return make

    dt_dev = device_time_per_rep(mk_chain(s, cfg), pb.x0)
    s16 = CaNNOLeSSolver(
        pb, method="gauss_newton", kkt="condensed", linsolve="chol",
        dtype=dtype, matmul_precision="bfloat16", quality_gate=False,
    )
    dt_bf16 = device_time_per_rep(mk_chain(s16, s16.make_config(max_iter=30)), pb.x0)

    # residual = 2 dense matvecs (+ sin): ~4mn flops
    total = flop_model(
        n=n, m=m, p=0, kkt="condensed",
        nlinsolve=int(st.nlinsolve), nfact=int(st.nfact), residual_flops=4 * m * n,
    )
    mfu = total / dt_dev / _peak_flops() * 100
    err = float(jnp.max(jnp.abs(st.x - xtrue)))
    return dt * 1e3, dt_dev * 1e3, dt_bf16 * 1e3, mfu, int(st.status), err


def main():
    dtype = jnp.float32
    problem = build_problem(dtype)
    budget = float(os.environ.get("BENCH_BUDGET", 450))
    t0 = time.time()

    # (linsolve, B, chunk): the batched-kernel ladder; the vmapped plain
    # `ldlt` backend joins it with BENCH_LDLT=1 for comparison.
    ladder = [
        ("pallas", 4096, None),
        ("pallas", 32768, 4096),
        ("pallas", 65536, 4096),
        ("pallas", 65536, 16384),
    ]
    if os.environ.get("BENCH_LDLT"):
        ladder.insert(0, ("ldlt", 2048, None))
    if os.environ.get("BENCH_B"):
        ladder = [("pallas", int(os.environ["BENCH_B"]),
                   int(os.environ.get("BENCH_CHUNK", 0)) or None)]

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench.py measures a GPU; JAX found " + jax.devices()[0].platform)
    _peak_flops()  # an unknown device is an error before any rung runs
    best = None
    best_summ = None
    failed = []
    warmup_total = 0.0
    for linsolve, B, chunk in ladder:
        elapsed = time.time() - t0
        if best is not None and elapsed > budget * 0.6:
            break
        try:
            tw = time.time()
            value, summ, dt, _ = run_config(problem, linsolve, B, chunk, dtype)
            warmup = time.time() - tw - 3 * dt  # compile + first run
            warmup_total += warmup
        except Exception as e:  # noqa: BLE001 — report, then fail the run
            failed.append(f"config {linsolve}/B={B}/chunk={chunk}: {e}")
            print(f"# config {linsolve}/B={B}/chunk={chunk} failed: {e}", file=sys.stderr)
            continue
        frac = summ["solved"] / B
        print(
            f"# {linsolve} B={B} chunk={chunk}: {value:.0f} inst/s "
            f"solved={summ['solved']}/{B} (pre-rescue failures: "
            f"{summ['breakdown_pre_rescue'] or 'none'}) t={dt:.4f}s "
            f"warmup={warmup:.0f}s (elapsed {time.time()-t0:.0f}s)",
            file=sys.stderr,
        )
        if frac < 0.99:
            # solved-rate gate: a config that can't solve 99% even after
            # the gate-on rescue does not get to claim the headline
            print(
                f"# {linsolve} B={B}: solved rate {frac:.4f} < 0.99 — "
                "excluded from headline", file=sys.stderr,
            )
            continue
        if best is None or value > best:
            best = value
            best_summ = summ

    dev = jax.devices()[0]
    extra = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices()), "card": card_name()}}
    if time.time() - t0 < budget * 0.8:
        try:
            sps, sps_dev, solved, mfu, dt = run_ba_rung()
            extra.update(
                ba_scenes_per_s=round(sps, 1),
                ba_scenes_per_s_device=round(sps_dev, 1),
                ba_solved=solved,
                ba_mfu_pct=round(mfu, 3),
            )
            print(
                f"# BA rung: {sps:.0f} scenes/s wall, {sps_dev:.0f} device "
                f"solved={solved} mfu={mfu:.3f}% t={dt:.4f}s "
                f"(elapsed {time.time()-t0:.0f}s)",
                file=sys.stderr,
            )
        except Exception as e:  # noqa: BLE001 — report, then fail the run
            failed.append(f"BA rung: {e}")
            print(f"# BA rung failed: {e}", file=sys.stderr)
    if time.time() - t0 < budget * 0.9:
        try:
            ms, ms_dev, ms_bf16, mfu, status, err = run_large_rung()
            extra.update(
                large_ms_per_solve=round(ms, 2),
                large_ms_device=round(ms_dev, 2),
                large_ms_device_bf16=round(ms_bf16, 2),
                large_mfu_pct=round(mfu, 1),
            )
            print(
                f"# large rung: {ms:.1f} ms/solve wall, {ms_dev:.2f} device, "
                f"{ms_bf16:.2f} bf16-commit; mfu={mfu:.1f}% status={status} "
                f"err={err:.2e} (elapsed {time.time()-t0:.0f}s)",
                file=sys.stderr,
            )
        except Exception as e:  # noqa: BLE001 — report, then fail the run
            failed.append(f"large rung: {e}")
            print(f"# large rung failed: {e}", file=sys.stderr)
    extra["warmup_s"] = round(warmup_total, 1)
    extra["total_s"] = round(time.time() - t0, 1)
    if best_summ is not None:
        extra["headline_solved"] = f"{best_summ['solved']}"
        if best_summ["breakdown_pre_rescue"]:
            extra["headline_failures_pre_rescue"] = best_summ["breakdown_pre_rescue"]

    if failed:
        extra["failed"] = failed
    value = 0.0 if best is None else best
    print(
        json.dumps(
            {
                "metric": "batched_lm_instances_per_s_per_chip",
                "value": round(value, 1),
                "unit": "instances/s",
                "vs_baseline": round(value / 1000.0, 3),
                "extra": extra,
            }
        )
    )
    return 1 if failed or best is None else 0


if __name__ == "__main__":
    sys.exit(main())
