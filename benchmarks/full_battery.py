#!/usr/bin/env python
"""Aggregate battery — every registered problem family under the reference
benchmark protocol (``/root/reference/docs/src/benchmark.md``: ``atol = 0,
rtol = 1e-5``, 'solved' ⇔ status ∈ {first_order, small_residual}).

The reference's published protocol filters NLSProblems.jl to "82 problems"
(docs/src/benchmark.md:13-17).  This runner covers the analogous in-repo set:

* MGH 1–35 (unconstrained NLS)                — models/mgh.py
* 20 extended dimensional MGH variants        — models/mgh.py (extended)
* 14 constrained-MGH (``sum(x)=1`` attached)  — reference runtests.jl style
* Hock–Schittkowski equality-constrained SOS  — models/hs.py
* Luksan–Vlcek-style chained constrained      — models/lvcon.py

Each problem runs with the reference default configuration (newton / full
KKT), first with the fast unpivoted ``linsolve='ldlt'`` and — on an
exception status — one robust ``linsolve='eigh'`` retry (the same
ldlt-then-eigh escalation that ``cannoles(..., linsolve='auto')`` performs;
the reference's two-backend seam, CaNNOLeS.jl:317-320).  Three GENERIC
rescues then apply to every problem (no per-problem flags):

* still unsolved → one retry with the documented ``delta_min=1e-4``
  safeguard (tames the δ-schedule thrash signature: the aug-Lagrangian
  multiplier update λ ← λ − c/δ amplifies roundoff at the reference
  δmin = √eps on near-degenerate constraints);
* still unsolved → one retry with ``kkt='condensed',
  multiplier_refit=True`` (round 5: the configuration that solves the
  whole battery uniformly in f64 and repairs f32 multiplier blow-ups on
  rank-deficient-Jacobian constrained problems);
* unsolved, or first_order at an objective measurably above the known
  optimum (a local minimum — the reference would simply return it) →
  one batched multistart sweep (the batched rescue: 64 perturbed
  starts in one compiled vsolve).

The JSON summary records the uniform-config solve count
(``solved_uniform``), the with-rescue count (``solved``), and which rescue
fired per row.

Usage:  python benchmarks/full_battery.py [--cpu] [--json out.json]
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def collect():
    """Yields (family, name, make_problem, fstar_sumsq_or_None)."""
    from cannoles_tpu.models.mgh import mgh_suite
    from cannoles_tpu.models.hs import hs_suite
    from cannoles_tpu.models.lvcon import lvcon_suite
    from cannoles_tpu.models.basic import constrained

    items = []
    base = mgh_suite()
    for s in base:
        items.append(("mgh", s.name, s.make, s.fmin))
    seen = {s.name for s in base}
    for s in mgh_suite(extended=True):
        if s.name not in seen:
            items.append(("mgh_ext", s.name, s.make, s.fmin))
    CURATED = {
        "rosenbrock", "beale", "helical_valley", "powell_singular", "wood",
        "ext_rosenbrock", "ext_powell", "broyden_tridiagonal",
        "broyden_banded", "brown_almost_linear", "variably_dimensioned",
        "trigonometric", "discrete_boundary_value", "chebyquad",
    }
    for s in mgh_suite(extended=True):
        if s.name in CURATED:
            items.append(
                ("mgh_con", s.name + "+linear",
                 (lambda s=s: constrained(s.make(), "linear")), None)
            )
    for s in hs_suite():
        items.append(("hs", s.name, s.make, s.fstar))
    for pb in lvcon_suite():
        items.append(("lvcon", pb.name, (lambda pb=pb: pb), None))
    return items


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="force CPU + float64")
    ap.add_argument("--max-time", type=float, default=60.0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    if args.cpu:
        from cannoles_tpu.utils.testing import force_cpu

        force_cpu()

    from cannoles_tpu import CaNNOLeSSolver
    from cannoles_tpu.parallel.multistart import multistart

    def _ok(st):
        return st.status in ("first_order", "small_residual")

    rows = []
    for family, name, make, fstar in collect():
        t0 = time.time()
        try:
            pb = make()
            solver = CaNNOLeSSolver(pb, linsolve="ldlt")
            stats = solver.solve(atol=0.0, rtol=1e-5, max_time=args.max_time)
            if stats.status == "exception":
                solver = CaNNOLeSSolver(pb, linsolve="eigh")
                stats = solver.solve(atol=0.0, rtol=1e-5, max_time=args.max_time)
            solved_uniform = _ok(stats)
            rescue = None
            # generic rescue 1: unsolved → documented delta_min safeguard
            if not _ok(stats):
                st2 = CaNNOLeSSolver(pb, linsolve="ldlt", delta_min=1e-4).solve(
                    atol=0.0, rtol=1e-5, max_time=args.max_time
                )
                if _ok(st2):
                    stats, rescue = st2, "delta_min"
            # generic rescue 1b: unsolved → condensed KKT + per-outer CGLS
            # multiplier refit at full-precision matmuls (round 5; the
            # configuration that solves the whole battery uniformly in f64 —
            # see perf_profile — and that rescues f32 multiplier blow-ups on
            # rank-deficient-Jacobian constrained problems like
            # brown_almost_linear+linear.  matmul_precision='highest'
            # matters on a GPU, where default-f32 matmuls run in TF32:
            # a rescue pass buys robustness, not speed; no-op on CPU).
            if not _ok(stats):
                st2b = CaNNOLeSSolver(
                    pb, kkt="condensed", multiplier_refit=True,
                    matmul_precision="highest",
                ).solve(atol=0.0, rtol=1e-5, max_time=args.max_time)
                if _ok(st2b):
                    stats, rescue = st2b, "condensed_refit"
            # generic rescue 2: unsolved, or stationary above the known
            # optimum (local minimum) → batched multistart sweep
            local_min = (
                _ok(stats)
                and fstar is not None
                and 2 * stats.objective > fstar + 1e-4 * (1 + abs(fstar))
            )
            if not _ok(stats) or local_min:
                # bounded sweep: wildly-perturbed starts on stiff problems
                # (meyer-class exponentials) can otherwise burn the full
                # 100k-eval budget in vmapped inner loops per lane
                st3 = multistart(
                    pb, n_starts=64, atol=0.0, rtol=1e-5,
                    max_inner=100, max_eval=5000,
                )
                if _ok(st3) and (not _ok(stats) or st3.objective < stats.objective):
                    stats, rescue = st3, "multistart"
            row = dict(
                family=family, name=name, nvar=pb.nvar, nequ=pb.nequ,
                ncon=pb.ncon, status=stats.status,
                solved=_ok(stats),
                solved_uniform=solved_uniform, rescue=rescue,
                iter=stats.iter, fsumsq=2 * stats.objective, fstar=fstar,
                dual_feas=stats.dual_feas, primal_feas=stats.primal_feas,
                time=time.time() - t0,
            )
        except Exception as e:  # noqa: BLE001 — battery survives one bad problem
            row = dict(
                family=family, name=name, nvar=-1, nequ=-1, ncon=-1,
                status=f"error:{e}", solved=False, solved_uniform=False,
                rescue=None, iter=-1,
                fsumsq=float("nan"), fstar=fstar, dual_feas=float("nan"),
                primal_feas=float("nan"), time=time.time() - t0,
            )
        rows.append(row)
        print(
            f"{row['family']:8s} {row['name']:30s} {row['status']:<16s} "
            f"iter={row['iter']:<4} Σf²={row['fsumsq']:<12.5g} "
            f"t={row['time']:.2f}s",
            flush=True,
        )

    solved = sum(r["solved"] for r in rows)
    solved_uniform = sum(r["solved_uniform"] for r in rows)
    by_family = {}
    for r in rows:
        n, s = by_family.get(r["family"], (0, 0))
        by_family[r["family"]] = (n + 1, s + r["solved"])
    summary = dict(
        n=len(rows), solved=solved, solved_uniform=solved_uniform,
        solve_rate=round(solved / len(rows), 4),
        solve_rate_uniform=round(solved_uniform / len(rows), 4),
        by_family={k: f"{s}/{n}" for k, (n, s) in by_family.items()},
    )
    print(json.dumps(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(summary=summary, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
