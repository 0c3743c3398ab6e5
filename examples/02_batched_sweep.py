#!/usr/bin/env python
"""Batched instance sweep + multistart (the accelerator regime).

python examples/02_batched_sweep.py [--cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

if "--cpu" in sys.argv:
    from cannoles_tpu.utils.testing import force_cpu

    force_cpu()

import jax.numpy as jnp
import numpy as np

from cannoles_tpu import CaNNOLeSSolver, multistart, nls_problem, vsolve

# A problem *family*: `data` parameterizes each instance.
def residual(x, theta):
    return jnp.array([x[0] - theta[0], 10 * (x[1] - x[0] ** 2) - theta[1]])


def cons(x, theta):
    return jnp.array([x[0] + x[1] - theta[2]])


family = nls_problem(
    residual, jnp.array([-1.2, 1.0]), 2, cons, [0.0], [0.0], data=jnp.zeros(3)
)

B = 512
rng = np.random.default_rng(0)
x0s = rng.normal(scale=0.5, size=(B, 2)) + [-1.2, 1.0]
thetas = np.stack(
    [1 + 0.2 * rng.normal(size=B), 0.1 * rng.normal(size=B), 1 + 0.2 * rng.normal(size=B)],
    axis=1,
)

solver = CaNNOLeSSolver(family, method="lm", kkt="condensed")
res = vsolve(family, x0s, data_batch=jnp.asarray(thetas), solver=solver, chunk_size=128)
print("sweep:", res.summary())

# Multistart: batched global search on a nonconvex problem the single start
# gets stuck on (Freudenstein-Roth: local min at 48.98, global at 0)
from cannoles_tpu.models.mgh import mgh_problem

fr = mgh_problem("freudenstein_roth")
single = CaNNOLeSSolver(fr).solve(atol=0.0, rtol=1e-5)
best = multistart(fr, n_starts=64, atol=0.0, rtol=1e-5, max_iter=150)
print(f"freudenstein_roth: single start Σf² = {2*single.objective:.4g}, "
      f"multistart Σf² = {2*best.objective:.4g}")
