#!/usr/bin/env python
"""Basics: define problems, solve, inspect results.

Run anywhere:  python examples/01_basics.py  (add --cpu to stay on the CPU)
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

if "--cpu" in sys.argv:
    from cannoles_tpu.utils.testing import force_cpu

    force_cpu()

import jax.numpy as jnp

from cannoles_tpu import CaNNOLeSSolver, cannoles, nls_problem

# ---- unconstrained Rosenbrock in NLS form --------------------------------
rosen = nls_problem(
    lambda x: jnp.array([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
    jnp.array([-1.2, 1.0]),
    nequ=2,
)
stats = cannoles(rosen)
print("rosenbrock:", stats)

# ---- equality constrained, with the iteration log ------------------------
constrained = nls_problem(
    lambda x: jnp.array([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
    jnp.array([-1.2, 1.0]),
    2,
    cons=lambda x: jnp.array([x[0] + x[1]]),
    lcon=[1.0],
    ucon=[1.0],
)
stats = cannoles(constrained, verbose=1)
print("solution:", stats.solution, " multipliers:", stats.multipliers)

# ---- reusable solver: warm starts without recompilation ------------------
solver = CaNNOLeSSolver(constrained, method="gauss_newton", kkt="condensed")
for x0 in ([0.0, 0.0], [3.0, -2.0], [-5.0, 5.0]):
    s = solver.solve(x0=jnp.asarray(x0, dtype=solver.dtype))
    print(f"from {x0}: {s.status} in {s.iter} iters -> {s.solution}")
