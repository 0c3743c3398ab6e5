"""Tracing / profiling helpers.

The reference's only observability is its log table and eval counters
(SURVEY.md §5).  Here:

* per-stage wall-clock timing of the compiled pieces (init / KKT assembly +
  factorization / full outer step) with ``block_until_ready`` fencing;
* counters (nfact, nlinsolve, nbk, evals) already ride the state pytree, so
  they survive vmap/while_loop and are free to read;
* :func:`trace` wraps ``jax.profiler.trace`` for XLA device timeline captures.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax
import jax.numpy as jnp

__all__ = ["stage_timings", "trace"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture an XLA profiler trace (view with tensorboard/xprof)."""
    with jax.profiler.trace(log_dir):
        yield


def stage_timings(solver, x0=None, lam0=None, reps: int = 10, **numeric) -> Dict[str, float]:
    """Wall-clock per compiled stage (seconds), after warmup.

    Stages: ``init`` (evals + CGLS multiplier estimate), ``outer_step`` (one
    full outer iteration: KKT assembly, factorization(s), line search,
    Jacobians), ``newton_system`` (assembly + inertia-corrected
    factorize/solve only).
    """
    pb = solver.problem
    x0 = jnp.asarray(pb.x0 if x0 is None else x0, solver.dtype)
    lam0 = jnp.asarray(pb.y0 if lam0 is None else lam0, solver.dtype)
    cfg = solver.make_config(**numeric)
    data = pb.data

    out: Dict[str, float] = {}

    def bench(fn, *args):
        r = fn(*args)
        jax.block_until_ready(r)
        t0 = time.perf_counter()
        for _ in range(reps):
            r = fn(*args)
        jax.block_until_ready(r)
        return (time.perf_counter() - t0) / reps

    out["init"] = bench(solver._init_fn, x0, lam0, cfg, data)
    state = solver._init_fn(x0, lam0, cfg, data)
    out["outer_step"] = bench(solver._outer_fn, state, cfg)

    n, m, p = pb.nvar, pb.nequ, pb.ncon

    @jax.jit
    def newton_only(s):
        H = solver._H_block(s.x, s.lam, s.r, s.Fx, s.JxT, s.damp, s.data)
        if solver.kkt == "condensed":
            K0 = solver._assemble_condensed(H, s.JxT, s.Jcx, s.delta)
            b = jnp.concatenate([s.dual + s.JxT @ s.primal[:m], s.primal[m:]])
            return solver._newton_system(K0, b, s.rho_old)[0]
        W0 = solver._assemble_kkt(H, s.JxT.T, s.Jcx, s.delta)
        rhs = jnp.concatenate([s.dual, s.primal])
        return solver._newton_system(W0, rhs, s.rho_old)[0]

    out["newton_system"] = bench(newton_only, state)
    return out
