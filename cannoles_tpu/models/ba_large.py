"""Large single-scene bundle adjustment with a full visibility grid.

The production-scale BA workload (100 cameras x 10,000 landmarks -> 30,600
parameters, 2,000,000 reprojection residuals).  The dense solver cannot touch
this (the materialized Jacobian alone is m*n = 245 GB); the capability analog
in the reference is sparse-J handling (/root/reference/src/CaNNOLeS.jl:259-315).
The answers here are:

* :class:`~cannoles_tpu.core.ba.SchurBASolver` — direct camera-Schur
  elimination on the structured Gauss-Newton system (core/ba.py);
* :class:`~cannoles_tpu.core.matfree.MatrixFreeSolver` — generic CG fallback.

Layout: ``x = [cams (C, 6).ravel(); pts (P, 3).ravel()]``, pose = (angle-axis
w, translation t), pinhole projection u = f*(R(X - t))_{xy}/z in normalized
image coordinates.  Full (C, P) visibility keeps every per-observation tensor
dense and batched — the static-shape restatement of BA sparsity (the block *structure*
is what's exploited, not COO indices).  Gauge freedom is removed by equality
constraints on the camera block only: pose 0 pinned (6) + squared baseline
fixed (1), as in :func:`cannoles_tpu.models.families.bundle_adjustment`.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..problem import NLSProblem, nls_problem

__all__ = ["project_point", "large_bundle_adjustment"]


def project_point(cam: jax.Array, pt: jax.Array, focal: float = 1.0) -> jax.Array:
    """Pinhole projection of one landmark through one camera.

    ``cam``: (6,) = (angle-axis w, translation t); ``pt``: (3,).  Returns the
    (2,) normalized image coordinates.  Small-angle-safe Rodrigues rotation
    (same model as models/families.py so the two BA generators agree).
    """
    w, t = cam[:3], cam[3:]
    X = pt - t
    theta2 = jnp.vdot(w, w)
    theta = jnp.sqrt(theta2 + 1e-30)
    k = w / theta
    c, s = jnp.cos(theta), jnp.sin(theta)
    kxX = jnp.cross(k, X)
    Xc_full = c * X + s * kxX + (1 - c) * jnp.vdot(k, X) * k
    Xc = jnp.where(theta2 < 1e-12, X + jnp.cross(w, X), Xc_full)
    z = jnp.maximum(Xc[2], 1e-3)
    return focal * Xc[:2] / z


def large_bundle_adjustment(
    n_cams: int = 100,
    n_pts: int = 10_000,
    noise: float = 0.0,
    seed: int = 0,
    gauge: str = "constraints",
    visibility: float = 1.0,
    dtype=jnp.float32,
) -> Tuple[NLSProblem, np.ndarray]:
    """Synthesize one consistent large scene; returns (problem, x_true).

    ``data = {"obs": (C, P, 2), "pose0": (6,), "base2": (1,)}``; residual is
    the raveled (C, P, 2) reprojection error — evaluated as one batched
    vmap-of-vmap of :func:`project_point` (dense batched work, no Python
    loops), so jvp/vjp through it stay cheap for the matrix-free surface.

    ``visibility``: fraction of (camera, landmark) pairs observed (default
    1.0 = full grid).  Below 1.0 a Bernoulli mask ``data["vis"]`` (C, P) is
    drawn — with every landmark forced visible in ≥ 2 cameras so the scene
    stays well-posed — and the residual is ``vis ⊙ (proj − obs)``.  This is
    the static-shape restatement of BAL-style sparse scenes (the reference
    handles arbitrary sparsity via COO storage, CaNNOLeS.jl:259-315; here
    the static-shape grid is masked, so XLA keeps every contraction dense
    and batched while the *algebra* — including the SchurBASolver's
    analytic U/V/W blocks — sees the true sparse Jacobian).

    ``gauge``: how the 7-dof similarity gauge freedom is removed —

    * ``"constraints"`` (default): equality constraints on the camera block
      (pose 0 pinned + squared baseline fixed) — exercises the constrained
      KKT machinery; in f32 the long-range constraint-deformation coupling
      limits attainable accuracy at extreme scale (RESULTS.md).
    * ``"fixed"``: gauge parameters (pose 0's six + camera 1's x
      translation) are frozen by projection inside the residual — their
      Jacobian columns are exactly zero, the rho regularizer makes those
      coordinates trivially stationary, and the problem is unconstrained:
      the production BA formulation, far better conditioned in f32.
    """
    rng = np.random.default_rng(seed)
    C, P = n_cams, n_pts
    angles = np.linspace(-0.4, 0.4, C)
    t_true = np.stack(
        [5.0 * np.sin(angles), 0.3 * rng.normal(size=C), -7.0 + np.cos(angles)], axis=1
    )
    w_true = np.stack(
        [0.05 * rng.normal(size=C), angles * 0.5, 0.02 * rng.normal(size=C)], axis=1
    )
    X_true = rng.uniform(-2.5, 2.5, size=(P, 3))
    X_true[:, 2] += 1.0
    cams_true = np.concatenate([w_true, t_true], axis=1)
    x_true = np.concatenate([cams_true.reshape(-1), X_true.reshape(-1)])

    def _proj_grid(cams, pts):
        return jax.vmap(lambda c: jax.vmap(lambda p: project_point(c, p))(pts))(cams)

    # observations at the widest available precision (f64 when x64 is on,
    # f32 otherwise — the residual then carries ~1e-7 synthesis rounding)
    obs = np.asarray(_proj_grid(jnp.asarray(cams_true), jnp.asarray(X_true)))
    obs = obs + noise * rng.normal(size=obs.shape)

    vis = None
    if visibility < 1.0:
        vis = (rng.random((C, P)) < visibility).astype(np.float64)
        # well-posedness: every landmark needs ≥ 2 observing cameras (a 3D
        # point seen once is depth-unconstrained → singular V block)
        for p_idx in np.nonzero(vis.sum(axis=0) < 2)[0]:
            vis[rng.choice(C, size=2, replace=False), p_idx] = 1.0
        # and every camera needs ≥ 6 observations to constrain its pose
        for c_idx in np.nonzero(vis.sum(axis=1) < 6)[0]:
            vis[c_idx, rng.choice(P, size=6, replace=False)] = 1.0

    base2 = float(np.sum((t_true[1] - t_true[0]) ** 2))
    pose0 = cams_true[0].copy()
    # frozen-gauge coordinate set: pose 0 (6) + camera 1's x translation (1).
    # The scale mode acts about camera 0's center, so the pinning coordinate
    # must differ strongly between the two cameras: t_x spans the arc
    # (|t1x − t0x| ~ 1), whereas t_z is nearly common — pinning z would
    # leave a near-null scale mode and a ~1e-4-wide minimizer plateau.
    gauge_idx = np.concatenate([np.arange(6), [9]])
    gauge_vals = x_true[gauge_idx].copy()

    masked = vis is not None

    def _err(cams, pts, d):
        e = _proj_grid(cams, pts) - d["obs"]
        if masked:
            e = e * d["vis"][..., None]
        return e.reshape(-1)

    if gauge == "fixed":

        def residual(x, d):
            x_eff = x.at[d["gidx"]].set(d["gvals"])
            cams = x_eff[: 6 * C].reshape(C, 6)
            pts = x_eff[6 * C :].reshape(P, 3)
            return _err(cams, pts, d)

        cons = None
    else:

        def residual(x, d):
            cams = x[: 6 * C].reshape(C, 6)
            pts = x[6 * C :].reshape(P, 3)
            return _err(cams, pts, d)

        def cons(x, d):
            c_pin = x[:6] - d["pose0"]
            t0, t1 = x[3:6], x[9:12]
            c_scale = jnp.array([jnp.sum((t1 - t0) ** 2)]) - d["base2"]
            return jnp.concatenate([c_pin, c_scale])

    x0 = x_true + 0.01 * rng.normal(size=x_true.shape)
    x0[:6] = pose0
    if gauge == "fixed":
        x0[gauge_idx] = gauge_vals
    data = {
        "obs": jnp.asarray(obs, dtype=dtype),
        "pose0": jnp.asarray(pose0, dtype=dtype),
        "base2": jnp.asarray([base2], dtype=dtype),
    }
    if masked:
        data["vis"] = jnp.asarray(vis, dtype=dtype)
    if gauge == "fixed":
        data["gidx"] = jnp.asarray(gauge_idx, dtype=jnp.int32)
        data["gvals"] = jnp.asarray(gauge_vals, dtype=dtype)
    pb = nls_problem(
        residual,
        jnp.asarray(x0, dtype=dtype),
        2 * C * P,
        cons,
        None if cons is None else np.zeros(7),
        None if cons is None else np.zeros(7),
        data=data,
        name=f"ba_large_{C}c{P}p_{gauge}"
        + (f"_vis{visibility:g}" if masked else ""),
    )
    return pb, x_true
