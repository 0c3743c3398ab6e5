#!/usr/bin/env python
"""Matrix-free engine benchmark: one huge dense-Jacobian-impossible NLS fit.

The dense solver stores J (m, n); at m = 2**21 residuals x n = 4096
parameters that is 32 GB in f32.  The matrix-free
engine solves it with only m- and n-vectors live; each CG iteration is a
jvp+vjp pair (two matmuls for this separable model).

Usage: python benchmarks/bench_matfree.py [--m 2097152] [--n 4096] [--cpu]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=2**21)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--cg-maxiter", type=int, default=100)
    args = ap.parse_args()

    if args.cpu:
        from cannoles_tpu.utils.testing import force_cpu

        force_cpu()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from cannoles_tpu import MatrixFreeSolver, nls_problem

    m, n = args.m, args.n
    dtype = jnp.float64 if args.cpu else jnp.float32
    rng = np.random.default_rng(0)
    # separable model: residual_i = <phi(t_i), w> - y_i with a random sparse
    # frequency embedding evaluated on the fly (J never materialized)
    t = jnp.asarray(np.linspace(0, 1, m), dtype=dtype)
    freqs = jnp.asarray(rng.uniform(1, 50, size=n), dtype=dtype)
    w_true = jnp.asarray(rng.normal(size=n) / np.sqrt(n), dtype=dtype)

    def model(w, d):
        # (m, n) features formed tile-wise by XLA fusion inside the matmul
        return jnp.sin(d["t"][:, None] * d["f"][None, :]) @ w

    data = {"t": t, "f": freqs}
    y = model(w_true, data)
    data["y"] = y

    pb = nls_problem(
        lambda w, d: model(w, d) - d["y"],
        jnp.zeros(n, dtype=dtype),
        m,
        data=data,
        name="huge_separable_fit",
    )
    solver = MatrixFreeSolver(pb, cg_maxiter=args.cg_maxiter, dtype=dtype)
    t0 = time.time()
    st = solver.solve(max_time=600.0, verbose=1, max_iter=30)
    wall = time.time() - t0
    err = float(np.max(np.abs(np.asarray(st.solution) - np.asarray(w_true))))
    ncg = st.solver_specific["ncg"]
    jac_gb = m * n * jnp.dtype(dtype).itemsize / 2**30
    print(
        f"m={m} n={n} (J would be {jac_gb:.1f} GB, never formed): "
        f"status={st.status} iters={st.iter} cg_total={ncg} "
        f"wall={wall:.2f}s param_err={err:.2e}"
    )


if __name__ == "__main__":
    main()
