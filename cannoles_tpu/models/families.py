"""Parameterized large-scale problem families (BASELINE configs 4/5).

These are the production-shaped workloads the accelerator build exists for — no
reference analog (the reference ships only small test fixtures):

* :func:`curve_fit_family` — m-observation exponential curve fits; the data
  pytree carries the observation axis, so it batches (vsolve) and row-shards
  (solve_row_sharded) without code changes.
* :func:`bundle_adjustment` — equality-constrained planar pinhole bundle
  adjustment: camera poses + 3D landmarks from 2D reprojections, with the
  7-dof gauge freedom removed by *equality constraints* (first pose pinned,
  baseline scale fixed) — exercising the constrained KKT machinery on its
  classic large-NLS use case.  Residual rows = 2·(cams·points).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..problem import NLSProblem, nls_problem

__all__ = ["curve_fit_family", "bundle_adjustment", "bundle_adjustment_batch"]


def curve_fit_family(m: int = 1024, dtype=jnp.float32) -> NLSProblem:
    """y(t) = a1·exp(-b1 t) + a2·exp(-b2 t) + c — 5 params, m rows.

    ``data = {"t": (m,), "y": (m,)}``; build batches by stacking data leaves.
    """
    t = jnp.linspace(0.0, 4.0, m, dtype=dtype)

    def model(x, t):
        return x[0] * jnp.exp(-x[1] * t) + x[2] * jnp.exp(-x[3] * t) + x[4]

    def residual(x, d):
        return model(x, d["t"]) - d["y"]

    true = jnp.asarray([2.0, 1.5, 1.0, 0.4, 0.5], dtype=dtype)
    data = {"t": t, "y": model(true, t)}
    x0 = jnp.asarray([1.0, 1.0, 0.5, 0.1, 0.0], dtype=dtype)
    return nls_problem(residual, x0, m, data=data, name=f"curvefit_{m}")


def _rodrigues(w, X):
    """Rotate points X (..., 3) by angle-axis w (3,), small-angle safe."""
    theta2 = jnp.vdot(w, w)
    theta = jnp.sqrt(theta2 + 1e-30)
    k = w / theta
    c, s = jnp.cos(theta), jnp.sin(theta)
    kxX = jnp.cross(jnp.broadcast_to(k, X.shape), X)
    kdX = (X @ k)[..., None]
    R = c * X + s * kxX + (1 - c) * kdX * k
    # fall back to first-order for tiny angles (AD-safe)
    small = theta2 < 1e-12
    return jnp.where(small, X + jnp.cross(jnp.broadcast_to(w, X.shape), X), R)


def bundle_adjustment(
    n_cams: int = 4,
    n_pts: int = 32,
    noise: float = 0.0,
    seed: int = 0,
    focal: float = 1.0,  # normalized image coordinates (standard BA scaling —
    # pixel-scale residuals make the initial ‖∇L‖ huge and thrash any
    # aug-Lagrangian method)
    dtype=jnp.float64,
) -> Tuple[NLSProblem, np.ndarray]:
    """Synthesize a consistent scene and return (problem, x_true).

    Parameter vector: ``[cam_poses (n_cams, 6) ; landmarks (n_pts, 3)]`` with
    pose = (angle-axis w, translation t); camera model u = f·(R(X−t))_{xy}/z.
    Equality constraints fix the gauge: pose 0 pinned (6) and the baseline
    ‖t₁−t₀‖² fixed (1) ⇒ ncon = 7.
    """
    rng = np.random.default_rng(seed)
    # cameras on an arc looking at the origin; landmarks in a box ahead
    angles = np.linspace(-0.3, 0.3, n_cams)
    t_true = np.stack([4.0 * np.sin(angles), 0.3 * rng.normal(size=n_cams), -6.0 + np.cos(angles)], axis=1)
    w_true = np.stack([0.05 * rng.normal(size=n_cams), angles * 0.5, 0.02 * rng.normal(size=n_cams)], axis=1)
    X_true = rng.uniform(-2.0, 2.0, size=(n_pts, 3))
    X_true[:, 2] += 1.0  # keep landmarks in front of the arc

    cams_true = np.concatenate([w_true, t_true], axis=1)  # (K, 6)
    x_true = np.concatenate([cams_true.reshape(-1), X_true.reshape(-1)])

    def project_all(x):
        cams = x[: 6 * n_cams].reshape(n_cams, 6)
        pts = x[6 * n_cams :].reshape(n_pts, 3)
        w = cams[:, :3]
        t = cams[:, 3:]
        # (K, P, 3): rotate (X - t_i) by w_i
        rel = pts[None, :, :] - t[:, None, :]
        Xc = jnp.stack([_rodrigues(w[i], rel[i]) for i in range(n_cams)])
        z = jnp.maximum(Xc[..., 2], 1e-3)
        uv = focal * Xc[..., :2] / z[..., None]
        return uv.reshape(-1)  # (2 K P,)

    # synthesize observations in pure numpy: jnp ops here would issue
    # hundreds of tiny device dispatches per scene
    def _np_project(cams, pts):
        uv = np.empty((n_cams, n_pts, 2))
        for i in range(n_cams):
            w, t = cams[i, :3], cams[i, 3:]
            th = np.sqrt((w**2).sum()) + 1e-30
            k = w / th
            X = pts - t
            c, s_ = np.cos(th), np.sin(th)
            Xc = c * X + s_ * np.cross(np.broadcast_to(k, X.shape), X) + (
                (1 - c) * (X @ k)[:, None] * k
            )
            uv[i] = focal * Xc[:, :2] / np.maximum(Xc[:, 2], 1e-3)[:, None]
        return uv.reshape(-1)

    obs = _np_project(cams_true, X_true)
    obs = obs + noise * rng.normal(size=obs.shape)

    def residual(x, d):
        return project_all(x) - d["obs"]

    base2 = float(np.sum((t_true[1] - t_true[0]) ** 2))
    pose0 = cams_true[0].copy()

    # gauge constants live in `data` so scenes batch under vsolve
    def cons(x, d):
        c_pin = x[:6] - d["pose0"]  # pin pose 0 (6)
        t0 = x[3:6]
        t1 = x[9:12]
        c_scale = jnp.array([jnp.sum((t1 - t0) ** 2)]) - d["base2"]
        return jnp.concatenate([c_pin, c_scale])

    x0 = x_true + 0.02 * rng.normal(size=x_true.shape)
    x0[:6] = pose0  # start feasible on the pinned pose
    m = 2 * n_cams * n_pts
    pb = nls_problem(
        residual,
        jnp.asarray(x0, dtype=dtype),
        m,
        cons,
        np.zeros(7),
        np.zeros(7),
        data={
            "obs": jnp.asarray(obs, dtype=dtype),
            "pose0": jnp.asarray(pose0, dtype=dtype),
            "base2": jnp.asarray([base2], dtype=dtype),
        },
        name=f"bundle_adjustment_{n_cams}c{n_pts}p",
    )
    return pb, x_true


def bundle_adjustment_batch(n_scenes: int, n_cams: int = 4, n_pts: int = 32,
                            noise: float = 0.0, seed: int = 0, dtype=jnp.float64):
    """Build ``n_scenes`` independent BA instances of one family: returns
    (problem, x0_batch, data_batch, x_true_batch) ready for ``vsolve``."""
    pbs, x0s, datas, trues = None, [], [], []
    for i in range(n_scenes):
        pb, xt = bundle_adjustment(n_cams, n_pts, noise=noise, seed=seed + i, dtype=dtype)
        if pbs is None:
            pbs = pb
        x0s.append(np.asarray(pb.x0))
        datas.append(pb.data)
        trues.append(xt)
    data_batch = jax.tree.map(lambda *ls: jnp.stack(ls), *datas)
    return pbs, jnp.asarray(np.stack(x0s), dtype=dtype), data_batch, np.stack(trues)
