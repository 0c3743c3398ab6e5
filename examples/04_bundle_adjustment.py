#!/usr/bin/env python
"""Bundle adjustment three ways: batched scenes, camera-Schur, matrix-free.

Run on CPU (small sizes) with:  python examples/04_bundle_adjustment.py --cpu
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

ap = argparse.ArgumentParser()
ap.add_argument("--cpu", action="store_true")
args = ap.parse_args()
if args.cpu:
    from cannoles_tpu.utils.testing import force_cpu

    force_cpu()

import jax.numpy as jnp
import numpy as np

# ----------------------------------------------------------------------
# 1. A batch of small gauge-constrained scenes in one compiled vsolve
#    (the instance-batch regime: thousands of independent solves per chip)
# ----------------------------------------------------------------------
from cannoles_tpu import CaNNOLeSSolver
from cannoles_tpu.models.families import bundle_adjustment_batch
from cannoles_tpu.parallel.batch import vsolve

B = 8
pb, x0s, datas, x_true = bundle_adjustment_batch(B, n_cams=3, n_pts=16)
solver = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="pallas")
res = vsolve(pb, x0s, data_batch=datas, solver=solver, max_iter=40)
print("batched scenes:", res.summary())

# ----------------------------------------------------------------------
# 2. One large scene, camera-Schur direct elimination (production path):
#    frozen-gauge formulation, no (m, n) Jacobian ever materialized
# ----------------------------------------------------------------------
from cannoles_tpu import SchurBASolver
from cannoles_tpu.models.ba_large import large_bundle_adjustment

C, P = 10, 500
pb2, xt2 = large_bundle_adjustment(C, P, gauge="fixed", dtype=jnp.float32)
st = SchurBASolver(
    pb2, C, P, frozen_cam_coords=np.asarray(pb2.data["gidx"])
).solve(atol=0.0, rtol=1e-5, max_iter=60)
print(
    f"schur {C}c/{P}p: {st.status} in {st.iter} iters, obj {st.objective:.2e}, "
    f"scene err {np.abs(np.asarray(st.solution) - xt2).max():.2e}"
)

# ----------------------------------------------------------------------
# 3. Same scene through the generic matrix-free CG engine (no structure
#    assumptions — works for any large NLS, not just BA)
# ----------------------------------------------------------------------
from cannoles_tpu import MatrixFreeSolver

st2 = MatrixFreeSolver(pb2, cg_maxiter=400).solve(atol=0.0, rtol=1e-5, max_iter=60)
print(f"matfree: {st2.status} in {st2.iter} iters, obj {st2.objective:.2e}")

# ----------------------------------------------------------------------
# 4. Gauge via equality CONSTRAINTS (exercises the constrained KKT
#    machinery).  The round-4 recipe: LM damping tames the transient along
#    the near-gauge null space, and the per-outer CGLS multiplier refit
#    replaces the slow first-order dual walk — first_order in a handful of
#    iterations where the plain configuration needs hundreds.
# ----------------------------------------------------------------------
pb3, xt3 = large_bundle_adjustment(C, P, gauge="constraints", dtype=jnp.float32)
# small scenes have a SMALLER initial dual, so the rtol-derived target is
# tighter in absolute terms and f32 needs more iterations than the
# production scales (this 10c/500p needs ~90)
st3 = SchurBASolver(pb3, C, P, method="lm", multiplier_refit=True).solve(
    atol=0.0, rtol=1e-5, max_iter=120
)
print(
    f"schur constrained: {st3.status} in {st3.iter} iters, "
    f"|c| {st3.primal_feas:.2e}, scene err "
    f"{np.abs(np.asarray(st3.solution) - xt3).max():.2e}"
)

# the generic engine matches with the structure-aware block preconditioner
from cannoles_tpu.core.ba import ba_block_jacobi

mf3 = MatrixFreeSolver(
    pb3, method="lm", multiplier_refit=True, precond=ba_block_jacobi(C, P)
)
st4 = mf3.solve(atol=0.0, rtol=1e-5, max_iter=120)
print(f"matfree constrained: {st4.status} in {st4.iter} iters")

# ----------------------------------------------------------------------
# 5. Round-5 continuation: the relative exit above is LOOSE at scale
#    (epstol = rtol * |grad L0|, and the initial gradient of a big scene is
#    big), so polish by RESUMING with an absolute target — passing explicit
#    tolerances together with resume_from re-targets the run from the
#    current iterate.  Past the LM-tamed transient, plain Gauss-Newton
#    drives the objective to the f32 floor in a few more iterations
#    (benchmarks/bench_ba_large.py runs the same recipe at 100c/10k).
# ----------------------------------------------------------------------
gn3 = MatrixFreeSolver(
    pb3, method="gauss_newton", multiplier_refit=True,
    precond=ba_block_jacobi(C, P),
)
st5 = gn3.solve(
    resume_from=mf3.last_state,
    atol=1e-6, rtol=0.0, Fatol=0.0, Frtol=0.0, max_iter=st4.iter + 100,
)
print(
    f"continuation: {st5.status} at iter {st5.iter}, obj {st5.objective:.2e}, "
    f"scene err {np.abs(np.asarray(st5.solution) - xt3).max():.2e}"
)
