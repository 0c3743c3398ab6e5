#!/usr/bin/env python
"""End-to-end smoke run of the solver on an NVIDIA GPU.

    python chip_smoke.py          # one card: phases 0-4
    python chip_smoke.py --four   # four cards: the sharded ladder and the
                                  # row-sharded large fit, each against one card

Everything runs in this one process.  Each phase prints one JSON line; any
failed check raises, so the process exits non-zero and the last line is not
printed.  Without a GPU the script stops at phase 0.  Times on the phase
lines are set-up (compile + first run) and run seconds of this smoke run,
not benchmark results.

Phases (one card):
  0. device: the JAX devices, the card's name and power limit, JAX version
     and XLA_FLAGS;
  1. kernel: the batched LDLᵀ kernel against the vmapped plain path on the
     card and a float64 numpy LDLᵀ on the host, on seeded quasi-definite KKT
     batches with planted zero pivots;
  2. ladder: the bench ladder family through ``vsolve`` (B = 65,536, chunk
     16,384, the bench's cap and rescue), a seeded lane sample checked with
     ``utils/kkt.py`` and against float64 solves on the host CPU;
  3. ba: 256 bundle-adjustment scenes through ``vsolve`` (condensed N = 73,
     ``linsolve='auto'``), every scene checked the same way;
     in phases 1-3 the program lowered for CUDA must call the Triton kernel;
  4. large: the bench's 8192×1024 fit through ``cannoles`` with
     ``linsolve``/``kkt`` left at 'auto'.
"""

import argparse
import json
import os
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# Tolerances, each with its reason.
# Relative backward error of a float32 factor + solve: a backward-stable
# solve sits near N·eps ≈ 1e-5 at N = 128 in the worst case, ~1e-7 typically.
KERNEL_BWD_TOL = 1e-5
# Device float32 solutions against the float64 KKT point nearest to each
# (see host_check): the median distance at most MEDIAN_X_FACTOR times that
# of the same lanes solved in float32 on the host CPU, the worst at most
# WORST_X_FACTOR times the CPU's worst, each plus X_TOL_FLOOR.  Two float32
# runs stop at different points within the solver's relative stopping
# tolerance, and the worst lane of 256 is the tail of that spread (measured
# on the CPU backend: 0.09 against 0.0125 between two batchings of the
# same ladder lanes), hence the wider factor for the worst lane.
MEDIAN_X_FACTOR = 2.0
WORST_X_FACTOR = 10.0
X_TOL_FLOOR = 1e-4
# Solver-independent KKT check of a float32 solution, in float64: scaled
# stationarity and feasibility over (1 + stationarity at the start), a
# ~30x margin over the f32 rtol √eps ≈ 3.5e-4.
KKT_REL_TOL = 1e-2
# Large fit: the zero-residual solution is recovered to float32 working
# accuracy of an 8192×1024 Gauss–Newton solve.
LARGE_X_TOL = 1e-3
# Sharded against one card: same lanes, same program per lane.
SHARD_X_TOL = 1e-5


# Custom-call target of a Pallas kernel compiled through Triton.
TRITON_CALL = "__gpu$xla.gpu.triton"


class SmokeFailure(AssertionError):
    pass


def check(ok, what):
    if not bool(ok):
        raise SmokeFailure(what)


def emit(row):
    print(json.dumps(row, default=str), flush=True)


def _setup_jax():
    """JAX as the bench configures it (importing ``bench`` sets the
    compile cache), plus float64: the references run on the host CPU in
    this process, and every device computation below names float32."""
    import jax

    import bench  # noqa: F401

    jax.config.update("jax_enable_x64", True)
    return jax


# --------------------------------------------------------------------------
# phase 1: kernel against references
# --------------------------------------------------------------------------
def kkt_batch(rng, B, N, dtype=np.float32):
    """Seeded quasi-definite KKT batch [[H, Jᵀ], [J, -δI]] with H ≻ 0;
    returns (W, rhs, n) with n the size of the positive block."""
    n = max(1, (2 * N) // 3)
    p = N - n
    G = rng.normal(size=(B, n, n)).astype(dtype)
    W = np.zeros((B, N, N), dtype)
    W[:, :n, :n] = G @ G.transpose(0, 2, 1) / n + np.eye(n, dtype=dtype)
    if p:
        J = rng.normal(size=(B, p, n)).astype(dtype)
        W[:, n:, :n] = J
        W[:, :n, n:] = J.transpose(0, 2, 1)
        W[:, n:, n:] = -0.5 * np.eye(p, dtype=dtype)
    return W, rng.normal(size=(B, N)).astype(dtype), n


def plant_zero_pivots(W, lanes):
    """Zero row and column k of the given lanes (k = 0 and k = N // 2
    alternately): that pivot is then exactly 0 in every precision."""
    N = W.shape[-1]
    for j, b in enumerate(lanes):
        k = 0 if j % 2 == 0 else N // 2
        W[b, k, :] = 0.0
        W[b, :, k] = 0.0
    return W


def ldlt_pivots_f64(W, tol):
    """Unpivoted LDLᵀ pivots in float64 with the kernel's skip rule."""
    A = np.asarray(W, np.float64).copy()
    B, N, _ = A.shape
    d = np.zeros((B, N))
    for k in range(N):
        dk = A[:, k, k].copy()
        d[:, k] = dk
        ok = np.abs(dk) > tol
        inv = np.where(ok, 1.0 / np.where(ok, dk, 1.0), 0.0)
        col = A[:, k + 1:, k] * inv[:, None]
        A[:, k + 1:, k + 1:] -= dk[:, None, None] * col[:, :, None] * col[:, None, :]
    return d


def backward_error(W, x, b):
    """‖Wx − b‖∞ / (‖W‖∞‖x‖∞ + ‖b‖∞) per lane, in float64."""
    W, x, b = (np.asarray(a, np.float64) for a in (W, x, b))
    r = np.abs(np.einsum("bij,bj->bi", W, x) - b).max(1)
    return r / (np.abs(W).sum(2).max(1) * np.abs(x).max(1) + np.abs(b).max(1))


def _pivot_class(d, tol):
    d = np.asarray(d, np.float64)
    return np.where(np.abs(d) <= tol, 0, np.sign(d)).astype(np.int8)


def phase_kernel(N, B, *, seed=0):
    """Batched kernel at (N, B) against the plain path and float64 numpy."""
    import jax
    import jax.numpy as jnp

    from cannoles_tpu.ops import pallas_ldlt
    from cannoles_tpu.ops.ldlt import ldlt_factor, ldlt_solve
    from cannoles_tpu.params import Params

    check(pallas_ldlt.use_kernel(N), f"N={N} is not a kernel size")
    tol = Params.for_dtype(jnp.float32).eig_tol
    rng = np.random.default_rng(seed)
    W, b, n = kkt_batch(rng, B, N)
    planted = rng.choice(B, size=min(4, B // 2), replace=False)
    W = plant_zero_pivots(W, planted)
    Wd, bd = jnp.asarray(W), jnp.asarray(b)

    kern = jax.jit(lambda W, b: pallas_ldlt.batched_ldlt_solve_pallas(W, b, tol))
    cuda = kern.trace(Wd, bd).lower(lowering_platforms=("cuda",)).as_text()
    check(TRITON_CALL in cuda, f"N={N}: no Triton custom call in the kernel lowered for CUDA")
    t0 = time.perf_counter()
    compiled = kern.lower(Wd, bd).compile()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, d = jax.block_until_ready(compiled(Wd, bd))
    t_run = time.perf_counter() - t0

    def one(Wi, bi):
        fac = ldlt_factor(Wi, tol)
        return ldlt_solve(fac, bi, tol), fac.vec

    xr, dr = jax.jit(jax.vmap(one))(Wd, bd)
    d64 = ldlt_pivots_f64(W, tol)

    cls = _pivot_class(d, tol)
    check((cls == _pivot_class(dr, tol)).all(), f"N={N}: pivot signs differ from the plain path")
    check((cls == _pivot_class(d64, tol)).all(), f"N={N}: pivot signs differ from float64")
    skipped = (cls == 0).any(axis=1)
    check(np.array_equal(np.nonzero(skipped)[0], np.sort(planted)),
          f"N={N}: skipped-pivot lanes {np.nonzero(skipped)[0]} != planted {np.sort(planted)}")
    clean = ~skipped
    check((cls[clean, :n] > 0).all() and (cls[clean, n:] < 0).all(),
          f"N={N}: inertia of a clean lane is not ({n}, {N - n}, 0)")
    err = backward_error(W[clean], np.asarray(x)[clean], b[clean])
    err_plain = backward_error(W[clean], np.asarray(xr)[clean], b[clean])
    check(np.isfinite(np.asarray(x)).all(), f"N={N}: non-finite solution")
    check(err.max() <= KERNEL_BWD_TOL, f"N={N}: backward error {err.max():.3e} > {KERNEL_BWD_TOL}")
    return {
        "N": N, "B": B, "block": pallas_ldlt.kernel_block(N),
        "worst_bwd_err": float(err.max()), "plain_worst_bwd_err": float(err_plain.max()),
        "tol": KERNEL_BWD_TOL, "skipped_lanes": int(skipped.sum()),
        "setup_s": round(t_compile, 3), "run_s": round(t_run, 4),
        "memory": str(compiled.memory_analysis()),
    }


# --------------------------------------------------------------------------
# phases 2 and 3: batched solves, sampled against float64 on the host CPU
# --------------------------------------------------------------------------
def check_kernel_in_program(solver, x0s, datas, batch_shape=None):
    """The batched program ``vsolve`` runs for these inputs, lowered for
    CUDA, calls the Triton kernel."""
    import jax

    spec = lambda a: jax.ShapeDtypeStruct(np.shape(a), a.dtype)  # noqa: E731
    lam0 = jax.ShapeDtypeStruct((np.shape(x0s)[0], solver.problem.ncon), solver.dtype)
    txt = (solver.batch_runner(True, batch_shape)
           .trace(spec(x0s), lam0, solver.make_config(), jax.tree.map(spec, datas))
           .lower(lowering_platforms=("cuda",)).as_text())
    check(TRITON_CALL in txt, f"{solver.problem.name}: no Triton custom call in the batched program")


def host_check(problem64, problem32, x, lam, x0, data, solve_kw):
    """Checks of float32 device solutions on the host CPU:

    * ``utils/kkt.py`` residuals at (x, λ) in float64, relative to the
      stationarity at the start x0 — the solver's own stopping rule is
      relative (atol + rtol·‖∇L(x0)‖ with rtol = √eps_f32 ≈ 3.5e-4);
    * distance to a float64 solve of the same lane started at the device
      solution, i.e. to the KKT point nearest the device answer (started at
      x0, a nonconvex lane may legitimately reach another local minimum);
    * the same distance for the same lanes solved in float32 on the host
      CPU with the plain LDLᵀ (``solve_kw``, as on the device): the float32
      stopping rule alone leaves BA scenes up to ~0.4 from their float64
      KKT point, so the bar is that the card is no less accurate than the
      CPU at float32 (see MEDIAN_X_FACTOR).
    """
    import jax

    from cannoles_tpu.parallel.batch import vsolve
    from cannoles_tpu.utils.kkt import kkt_residuals

    as64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    x, lam, x0, data = as64((x, lam, x0, data))
    ref_kw = {k: v for k, v in solve_kw.items() if k in ("method", "kkt")}
    with jax.default_device(jax.devices("cpu")[0]):
        kkt = jax.jit(jax.vmap(lambda xi, li, di: kkt_residuals(problem64, xi, li, data=di)))
        r = kkt(x, lam, data)
        r0 = kkt(x0, np.zeros_like(lam), data)

        def dist_to_f64(xs, ls):
            ref = vsolve(problem64, xs, ls, data_batch=data, linsolve="ldlt", max_iter=100, **ref_kw)
            check(ref.solved_mask().all(), f"float64 reference failed: {ref.summary()}")
            return np.abs(xs - ref.solution).max(axis=1)

        cpu32 = vsolve(problem32, np.asarray(x0, np.float32),
                       data_batch=jax.tree.map(lambda a: np.asarray(a, np.float32), data),
                       linsolve="ldlt", **solve_kw)
        dx = dist_to_f64(x, lam)
        dx_cpu = dist_to_f64(*as64((cpu32.solution, cpu32.multipliers)))
    scale = 1.0 + np.asarray(r0.scaled_stationarity)
    stat = float(np.max(np.asarray(r.scaled_stationarity) / scale))
    feas = float(np.max(np.asarray(r.feasibility) / scale))
    check(stat <= KKT_REL_TOL and feas <= KKT_REL_TOL,
          f"KKT check: stationarity {stat:.3e}, feasibility {feas:.3e} "
          f"(relative to 1 + start stationarity) > {KKT_REL_TOL}")
    tol_worst = WORST_X_FACTOR * dx_cpu.max() + X_TOL_FLOOR
    tol_median = MEDIAN_X_FACTOR * np.median(dx_cpu) + X_TOL_FLOOR
    check(dx.max() <= tol_worst, f"worst |x - x_ref|inf {dx.max():.3e} > {tol_worst:.3e}")
    check(np.median(dx) <= tol_median, f"median |x - x_ref|inf {np.median(dx):.3e} > {tol_median:.3e}")
    return {"kkt_rel_stationarity": stat, "kkt_rel_feasibility": feas, "kkt_tol": KKT_REL_TOL,
            "worst_dx_vs_f64": float(dx.max()), "worst_dx_tol": float(tol_worst),
            "median_dx_vs_f64": float(np.median(dx)), "median_dx_tol": float(tol_median),
            "cpu_f32_worst_dx": float(dx_cpu.max()), "cpu_f32_median_dx": float(np.median(dx_cpu))}


def phase_ladder(B=65536, chunk=16384, sample=256, seed=0):
    import jax.numpy as jnp

    import bench

    dtype = jnp.float32
    problem = bench.build_problem(dtype)
    t0 = time.perf_counter()
    _, summ, dt, res = bench.run_config(problem, "pallas", B, chunk, dtype)
    t_total = time.perf_counter() - t0
    check(res.solver.linsolve == "pallas", "ladder did not run the kernel backend")
    check(summ["solved"] == B, f"ladder solved {summ['solved']}/{B}: {summ}")
    x0s, datas = bench.ladder_inputs(B)
    check_kernel_in_program(res.solver, x0s.astype(np.float32), datas.astype(np.float32), (B, chunk))

    idx = np.sort(np.random.default_rng(seed).choice(B, size=min(sample, B), replace=False))
    row = {"B": B, "chunk": chunk, "solved": f"{summ['solved']}/{B}",
           "pre_rescue_failures": summ["breakdown_pre_rescue"], "sample": int(idx.size)}
    row.update(host_check(
        bench.build_problem(jnp.float64), problem, res.solution[idx], res.multipliers[idx],
        x0s[idx], datas[idx],
        dict(method="lm", kkt="full", max_iter=50, rescue=True, **bench.ladder_cap(B)),
    ))
    row.update(setup_s=round(t_total - 3 * dt, 3), run_s=round(dt, 4))
    return row


def phase_ba(n_scenes=256, n_cams=3, n_pts=16):
    import jax
    import jax.numpy as jnp

    from cannoles_tpu.models.families import bundle_adjustment_batch
    from cannoles_tpu.parallel.batch import vsolve

    pb, x0s, datas, _ = bundle_adjustment_batch(n_scenes, n_cams, n_pts, dtype=jnp.float32)
    kw = dict(method="gauss_newton", kkt="condensed", max_iter=40)
    t0 = time.perf_counter()
    res = vsolve(pb, x0s, data_batch=datas, **kw)
    jax.block_until_ready(res.states.x)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = vsolve(pb, x0s, data_batch=datas, solver=res.solver, max_iter=40)
    jax.block_until_ready(res.states.x)
    t_run = time.perf_counter() - t0
    N = pb.nvar + pb.ncon
    check(res.solver.linsolve == "pallas", f"auto picked {res.solver.linsolve!r} at N={N}")
    check_kernel_in_program(res.solver, x0s, datas)
    solved = int(res.solved_mask().sum())
    check(solved == n_scenes, f"BA solved {solved}/{n_scenes}: {res.summary()}")

    pb64, x0s64, datas64, _ = bundle_adjustment_batch(n_scenes, n_cams, n_pts, dtype=jnp.float64)
    row = {"scenes": n_scenes, "N": N, "linsolve": res.solver.linsolve,
           "solved": f"{solved}/{n_scenes}", "mean_nfact": float(np.mean(np.asarray(res.states.nfact)))}
    row.update(host_check(pb64, pb, res.solution, res.multipliers, x0s64, datas64, kw))
    row.update(setup_s=round(t_setup, 3), run_s=round(t_run, 4))
    return row


def phase_large(m=8192, n=1024):
    import jax.numpy as jnp

    import bench
    from cannoles_tpu import cannoles
    from cannoles_tpu.core.solver import resolve_auto

    pb, xtrue = bench.build_large_problem(m, n, dtype=jnp.float32)
    linsolve, kkt, _ = resolve_auto(pb, "gauss_newton", "auto", "auto")
    check((linsolve, kkt) == ("chol", "condensed"), f"auto resolved to {(linsolve, kkt)}")
    t0 = time.perf_counter()
    stats = cannoles(pb, method="gauss_newton", max_time=900.0)
    t_total = time.perf_counter() - t0
    err = float(np.abs(np.asarray(stats.solution, np.float64) - np.asarray(xtrue, np.float64)).max())
    check(stats.status == "first_order", f"large fit status {stats.status}")
    check(err <= LARGE_X_TOL, f"large fit |x - x_true|inf = {err:.3e} > {LARGE_X_TOL}")
    return {"m": m, "n": n, "linsolve": linsolve, "kkt": kkt, "status": stats.status,
            "iter": stats.iter, "x_err": err, "tol": LARGE_X_TOL,
            "setup_plus_run_s": round(t_total, 3)}


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------
def _memory(devices):
    """Per-card ``peak_bytes_in_use`` and ``bytes_in_use``.  The peak also
    counts transient buffers, among them XLA's compile-time autotuning,
    which runs on one device."""
    stats = [d.memory_stats() or {} for d in devices]
    return {key: [int(st.get(key, -1)) for st in stats]
            for key in ("peak_bytes_in_use", "bytes_in_use")}


def phase_four_ladder(devices, B_per_card=65536, chunk=16384):
    """Ladder over a 1-D ("batch",) mesh against the same lanes on one card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from cannoles_tpu import CaNNOLeSSolver
    from cannoles_tpu.parallel.batch import make_batch_mesh, vsolve

    dtype = jnp.float32
    k = len(devices)
    B = k * B_per_card
    problem = bench.build_problem(dtype)
    solver = CaNNOLeSSolver(problem, method="lm", linsolve="pallas", kkt="full", dtype=dtype)
    x0s, datas = (np.asarray(a, np.float32) for a in bench.ladder_inputs(B))
    mesh = make_batch_mesh(devices)
    kw = dict(solver=solver, max_iter=50, rescue=True, **bench.ladder_cap(B_per_card))

    t0 = time.perf_counter()
    res = vsolve(problem, x0s, data_batch=datas, mesh=mesh, **kw)
    jax.block_until_ready(res.states.x)
    t_sharded = time.perf_counter() - t0
    memory = _memory(devices)
    x = res.states.x
    shards = sorted((s.device.id, s.data.shape) for s in x.addressable_shards)

    sh = NamedSharding(mesh, P("batch"))
    txt = solver.batch_runner(True, None, mesh).lower(
        jax.device_put(x0s, sh), jax.device_put(np.zeros((B, 1), np.float32), sh),
        solver.make_config(max_iter=50), jax.device_put(datas, sh),
    ).compile().as_text()
    check("all-gather" not in txt, "sharded batch program contains an all-gather")

    with jax.default_device(devices[0]):
        t0 = time.perf_counter()
        one = vsolve(problem, x0s, data_batch=datas, chunk_size=chunk, **kw)
        jax.block_until_ready(one.states.x)
        t_one = time.perf_counter() - t0
    dx = float(np.abs(res.solution - one.solution).max())
    check(res.solved_mask().all() and one.solved_mask().all(),
          f"solved {int(res.solved_mask().sum())}/{B} sharded, {int(one.solved_mask().sum())}/{B} one card")
    check(x.sharding.device_set == set(devices), f"lanes on {x.sharding.device_set}")
    check(all(s[1][0] == B_per_card for s in shards), f"shards {shards}")
    check(dx <= SHARD_X_TOL, f"sharded vs one card |dx|inf = {dx:.3e} > {SHARD_X_TOL}")
    return {"B": B, "solved": f"{int(res.solved_mask().sum())}/{B}",
            "device_set": sorted(d.id for d in x.sharding.device_set),
            "shards": shards, "memory": memory,
            "dx_vs_one_card": dx, "tol": SHARD_X_TOL, "all_gather": False,
            "sharded_setup_plus_run_s": round(t_sharded, 3),
            "one_card_setup_plus_run_s": round(t_one, 3)}


def phase_four_large(devices, m=8192, n=1024):
    """8192×1024 fit through solve_row_sharded over the cards against one card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from cannoles_tpu.parallel.schur import make_row_mesh, solve_row_sharded

    pb, xtrue = bench.build_large_problem(m, n, dtype=jnp.float32)
    mesh = make_row_mesh(devices)
    rows = NamedSharding(mesh, P("rows"))
    data = jax.tree.map(lambda a: jax.device_put(a, rows), pb.data)
    placed = {key: (sorted(d.id for d in a.sharding.device_set),
                    sorted({s.data.shape for s in a.addressable_shards}))
              for key, a in data.items()}
    t0 = time.perf_counter()
    st4 = solve_row_sharded(pb, mesh, method="gauss_newton", max_iter=200)
    t4 = time.perf_counter() - t0
    memory = _memory(devices)
    t0 = time.perf_counter()
    st1 = solve_row_sharded(pb, make_row_mesh(devices[:1]), method="gauss_newton", max_iter=200)
    t1 = time.perf_counter() - t0
    dx = float(np.abs(st4.solution - st1.solution).max())
    err = float(np.abs(st4.solution - np.asarray(xtrue)).max())
    check(st4.status == "first_order" and st1.status == "first_order",
          f"status {st4.status} on {len(devices)} cards, {st1.status} on one")
    check(all(len(ids) == len(devices) for ids, _ in placed.values()), f"placement {placed}")
    check(err <= LARGE_X_TOL, f"|x - x_true|inf = {err:.3e} > {LARGE_X_TOL}")
    check(dx <= LARGE_X_TOL, f"row-sharded vs one card |dx|inf = {dx:.3e} > {LARGE_X_TOL}")
    return {"m": m, "n": n, "status": st4.status, "iter": st4.iter, "x_err": err,
            "dx_vs_one_card": dx, "tol": LARGE_X_TOL, "data_placement": placed,
            "memory": memory, "sharded_setup_plus_run_s": round(t4, 3),
            "one_card_setup_plus_run_s": round(t1, 3)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phases (needs four GPUs)")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {platform!r}", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}", file=sys.stderr)
        return 2
    devices = devices[:need]
    _setup_jax()
    import bench

    card = bench.card_name()
    emit({"phase": "device", "devices": [str(d) for d in devices],
          "kind": devices[0].device_kind, "jax": jax.__version__,
          "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""), "card": card})
    print(card, flush=True)

    def run(name, fn, *a, **kw):
        t0 = time.perf_counter()
        row = fn(*a, **kw)
        emit({"phase": name, "ok": True, **row, "wall_s": round(time.perf_counter() - t0, 3),
              "card": card})

    if args.four:
        with jax.default_device(devices[0]):
            run("four_ladder", phase_four_ladder, devices)
            run("four_large", phase_four_large, devices)
    else:
        from cannoles_tpu.ops.pallas_ldlt import KERNEL_MAX_N

        with jax.default_device(devices[0]):
            for N, B in ((5, 65536), (73, 256), (KERNEL_MAX_N, 256)):
                run("kernel", phase_kernel, N, B)
            run("ladder", phase_ladder)
            run("ba", phase_ba)
            run("large", phase_large)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind, "count": need}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
