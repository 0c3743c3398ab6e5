#!/usr/bin/env python
"""bf16 mixed-precision accuracy envelope over the MGH battery.

The reduced-precision mode is *mixed precision*: f32 solver state with bf16
multiply passes in the non-critical matmuls (`matmul_precision` knob on
``CaNNOLeSSolver``; the J'J condensation and quality-gate/refinement
contractions stay pinned at precision='highest').  This script measures what
that costs in accuracy, reference-style (multiprecision sweep analog,
``/root/reference/test/runtests.jl:102-113``):

* solve every MGH battery problem in float64 ('highest') as ground truth;
* re-solve in f32 under matmul_precision in {'highest', 'bfloat16'};
* report solved counts and the max/median deviation of the returned solution
  and objective from the f64 answer — the envelope.

Run on a GPU (precision knobs are no-ops on CPU):

    python benchmarks/bf16_envelope.py [--json out.json]
"""

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        from cannoles_tpu.utils.testing import force_cpu

        force_cpu()

    import jax
    import jax.numpy as jnp

    from cannoles_tpu import CaNNOLeSSolver
    from cannoles_tpu.models.mgh import mgh_suite

    cpu = jax.local_devices(backend="cpu")[0]

    rows = []
    for spec in mgh_suite():
        pb = spec.make()
        row = {"name": spec.name}
        # f64 ground truth on the host CPU
        try:
            with jax.enable_x64(True), jax.default_device(cpu):
                s64 = CaNNOLeSSolver(pb, method="newton", dtype=jnp.float64).solve(
                    max_time=120.0
                )
            x64v = np.asarray(s64.solution, np.float64)
            row["f64_status"] = s64.status
        except Exception as e:  # noqa: BLE001
            row["f64_status"] = f"error: {e}"
            x64v = None
        for mp in ("highest", "bfloat16"):
            try:
                s = CaNNOLeSSolver(
                    pb, method="newton", dtype=jnp.float32, matmul_precision=mp
                ).solve(max_time=120.0)
                ok = s.status in ("first_order", "small_residual")
                dev = (
                    float(np.max(np.abs(np.asarray(s.solution, np.float64) - x64v)))
                    if (ok and x64v is not None)
                    else None
                )
                row[mp] = {"status": s.status, "dev": dev,
                           "obj": float(s.objective), "iter": s.iter}
            except Exception as e:  # noqa: BLE001
                row[mp] = {"status": f"error: {e}", "dev": None}
        rows.append(row)
        print(row, flush=True)

    for mp in ("highest", "bfloat16"):
        solved = [r for r in rows if r[mp]["status"] in ("first_order", "small_residual")]
        devs = [r[mp]["dev"] for r in solved if r[mp]["dev"] is not None]
        print(
            f"{mp}: solved {len(solved)}/{len(rows)}  "
            f"max_dev={max(devs) if devs else float('nan'):.3e}  "
            f"median_dev={float(np.median(devs)) if devs else float('nan'):.3e}"
        )
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
