#!/usr/bin/env python
"""Large single-scene bundle adjustment: camera-Schur vs matrix-free CG.

The production-scale structured-elimination benchmark (a 100-camera /
10,000-landmark BA solving faster than the dense condensed path).  At this
size the dense path cannot run at all — the materialized Jacobian is
m x n = 2,000,000 x 30,600 = 245 GB — so the comparison is:

* :class:`SchurBASolver` — direct landmark elimination (core/ba.py);
* :class:`MatrixFreeSolver` — generic CG on the condensed operator.

Reports wall-clock and device-side per-iteration time (in-graph repetition
differencing removes the fixed per-dispatch host cost), iterations, final
objective/KKT numbers, and scene-recovery error.

    python benchmarks/bench_ba_large.py [--cams 100 --pts 10000] [--json out]
"""

import argparse
import json
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=100)
    ap.add_argument("--pts", type=int, default=10_000)
    ap.add_argument("--gauge", choices=["constraints", "fixed"], default="fixed")
    ap.add_argument(
        "--visibility", type=float, default=1.0,
        help="fraction of (cam, pt) pairs observed (BAL-style sparse scene)",
    )
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--skip-matfree", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        from cannoles_tpu.utils.testing import force_cpu

        force_cpu()

    import jax
    import jax.numpy as jnp

    jax.config.update(
        "jax_compilation_cache_dir",
        os.environ.get(
            "JAX_COMPILATION_CACHE_DIR",
            str(pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"),
        ),
    )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

    from cannoles_tpu.core.ba import SchurBASolver
    from cannoles_tpu.core.matfree import MatrixFreeSolver
    from cannoles_tpu.models.ba_large import large_bundle_adjustment

    C, P = args.cams, args.pts
    print(
        f"# scene: {C} cams x {P} pts (gauge={args.gauge}, "
        f"visibility={args.visibility}) -> nvar={6*C+3*P}, nequ={2*C*P}",
        flush=True,
    )
    pb, x_true = large_bundle_adjustment(
        C, P, noise=0.0, seed=0, gauge=args.gauge,
        visibility=args.visibility, dtype=jnp.float32,
    )
    # reference benchmark protocol tolerances (docs/src/benchmark.md:26-47:
    # atol=0, rtol=1e-5) — f32-reachable on the gauge-fixed formulation;
    # f64-grade absolute targets are not (conditioning of the f32 normal
    # equations)
    tol = dict(atol=0.0, rtol=1e-5, max_iter=60)
    frozen = (
        np.asarray(pb.data["gidx"]) if args.gauge == "fixed" else None
    )

    out = {
        "cams": C, "pts": P, "gauge": args.gauge, "nvar": pb.nvar,
        "nequ": pb.nequ, "visibility": args.visibility,
    }

    def device_solve_time(solver, iters_hint):
        """Device-side full-solve seconds via in-graph repetition
        differencing (the host-driven solve dispatches once per outer
        iteration, and each dispatch has a fixed host cost)."""
        import jax.numpy as jnp
        from jax import lax

        cfg = solver.make_config(**tol)

        def mk(R):
            @jax.jit
            def f(x0):
                def body(i, acc):
                    st = solver._run_compiled(x0 + acc * 1e-9, pb.y0, cfg, pb.data)
                    return acc + st.x[0]
                return lax.fori_loop(0, R, body, jnp.zeros((), jnp.float32))
            return f

        f1, f2 = mk(1), mk(3)
        for f in (f1, f2):
            float(f(pb.x0))
        def t(f):
            t0 = time.perf_counter()
            float(f(pb.x0))
            return time.perf_counter() - t0
        return (min(t(f2) for _ in range(2)) - min(t(f1) for _ in range(2))) / 2

    def _row(st, wall, extra=None):
        err = float(np.abs(np.asarray(st.solution, np.float64) - x_true).max())
        row = {
            "status": st.status,
            "iter": st.iter,
            "wall_s": round(wall, 2),
            "objective": st.objective,
            "dual_feas": st.dual_feas,
            "primal_feas": st.primal_feas,
            "recovery_err": err,
            "nfact": st.solver_specific["nfact"],
            "ncg": st.solver_specific["ncg"],
        }
        if extra:
            row.update(extra)
        return row

    def run(name, make_solver, polish_atol=2e-7):
        """Measured-best per-gauge recipe (RESULTS.md gauge study).

        Frozen gauge: plain Gauss-Newton, one phase.  Gauge-CONSTRAINED:
        three phases —

        1. LM + multiplier_refit at the reference protocol (atol=0,
           rtol=1e-5): the damping tames the feasibility-destroying
           transient along the near-gauge null space; exits first_order at
           the (loose, because ‖∇L⁰‖ is huge at 2M residuals) relative tol.
        2. Gauss-Newton continuation (resume + re-target, atol=1e-5
           absolute): past the transient the full Newton step converges the
           objective essentially to the f32 floor in ~3 iterations.
        3. GN polish at ``polish_atol``: walks the dual toward its f32
           noise floor.  Engine-specific target — the matfree CG engine
           reaches 2e-7 and its Krylov steps also walk the near-null gauge
           mode down (recovery ~8e-5); the direct Schur engine plateaus at
           ~1e-6 (its rho-ladder regularizes failed rho=0 attempts at
           rho0 = eps^(1/3) ≈ 5e-3 in f32, freezing the near-null mode at
           recovery ~7e-3 — measured, see RESULTS.md; resume the matfree
           engine from its state to recover the last decade).

        Round-4 reported phase 1 alone as "the fix"; its objective lands
        4 orders above the frozen-gauge run (2.2e-2 vs 8.3e-7).  The
        continuation closes that honestly: the final constrained objective
        is ~1e-9 — BELOW frozen-gauge — with recovery ~8e-5.
        """
        t0 = time.time()
        solver = make_solver(
            dict(method="lm", multiplier_refit=True)
            if constrained
            else dict(method="gauss_newton")
        )
        st = solver.solve(max_time=3000.0, **tol)
        wall = time.time() - t0
        if constrained and st.status == "first_order":
            out[name + "_phase1"] = _row(st, wall)
            print(f"# {name}_phase1: {out[name + '_phase1']}", flush=True)
            gn = make_solver(dict(method="gauss_newton", multiplier_refit=True))
            t1 = time.time()
            st = gn.solve(
                resume_from=solver.last_state, atol=1e-5, rtol=0.0,
                Fatol=0.0, Frtol=0.0, max_iter=tol["max_iter"] + 60,
                max_time=3000.0,
            )
            st = gn.solve(
                resume_from=gn.last_state, atol=polish_atol, rtol=0.0,
                Fatol=0.0, Frtol=0.0, max_iter=tol["max_iter"] + 200,
                max_time=3000.0,
            )
            wall = time.time() - t0
            solver = gn
            out[name] = _row(st, wall, {"polish_wall_s": round(time.time() - t1, 2)})
        else:
            out[name] = _row(st, wall)
        try:
            out[name]["device_solve_s"] = round(device_solve_time(solver, st.iter), 3)
        except Exception as e:  # noqa: BLE001
            out[name]["device_solve_s"] = f"failed: {e}"
        print(f"# {name}: {out[name]}", flush=True)
        return st

    constrained = args.gauge == "constraints"
    run(
        "schur",
        lambda skw: SchurBASolver(pb, C, P, frozen_cam_coords=frozen, **skw),
        polish_atol=1e-6,
    )
    if not args.skip_matfree:
        from cannoles_tpu.core.ba import ba_block_jacobi

        run(
            "matfree_cg",
            lambda skw: MatrixFreeSolver(
                pb, cg_maxiter=600, precond=ba_block_jacobi(C, P), **skw
            ),
        )

    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
