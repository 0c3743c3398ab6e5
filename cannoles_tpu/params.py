"""Algorithm hyper-parameters, precision-derived.

Restatement of the reference parameter pack
(``/root/reference/src/CaNNOLeS.jl:36-87``, ``ParamCaNNOLeS``): every constant
is derived from the machine epsilon of the working dtype so that the same
algorithm runs in float64 (parity runs, CPU), float32 (GPU throughput) and
float16 (reference Float16 analog, tests/test_precision_trajectory.py).

bfloat16 note: bf16 as a *solve dtype* is deliberately not offered as a
supported mode — its 8-bit mantissa makes the eps-derived tolerances
(eps^0.5 ≈ 0.09) accept meaningless points.  Reduced precision enters only
through matmuls: f32 state/scalars, with the non-critical matmuls at JAX's
default precision (TF32 on an H100) or committed to bf16/TF32 explicitly via
``CaNNOLeSSolver(matmul_precision=...)``; accuracy envelope measured by
benchmarks/bf16_envelope.py.

All fields are *static* Python floats: they are fixed once the dtype is chosen,
so they embed as compile-time constants inside jitted solver code (no tracing
overhead, no recompilation across solves).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp
import numpy as np


def _eps(dtype) -> float:
    return float(jnp.finfo(dtype).eps)


@dataclasses.dataclass(frozen=True)
class Params:
    """Regularization / line-search constants (reference: ParamCaNNOLeS).

    Defaults follow ``/root/reference/src/CaNNOLeS.jl:48-62``:
      eig_tol   = eps            (pivot/eigenvalue zero tolerance)
      delta_min = sqrt(eps)      (floor for the dual regularizer delta)
      kappa_dec = 1/3            (rho shrink factor relative to last good rho)
      kappa_inc = 8              (rho escalation when a previous rho existed)
      kappa_large_inc = min(100, 16*sizeof(T))  (first-time rho escalation)
      rho0      = eps^(1/3)      (first regularization attempt)
      rho_max   = eps^(-2)       (give-up threshold, capped below dtype max)
      rho_min   = sqrt(eps)      (floor for rho)
      gamma_A   = eps^(1/4)      (Armijo slope fraction)
    """

    eig_tol: float
    delta_min: float
    kappa_dec: float
    kappa_inc: float
    kappa_large_inc: float
    rho0: float
    rho_max: float
    rho_min: float
    gamma_A: float

    @staticmethod
    def for_dtype(dtype: Any, **overrides) -> "Params":
        eps = _eps(dtype)
        itemsize = np.dtype(dtype).itemsize
        fmax = float(jnp.finfo(dtype).max)
        vals = dict(
            eig_tol=eps,
            delta_min=float(np.sqrt(eps)),
            kappa_dec=1.0 / 3.0,
            kappa_inc=8.0,
            kappa_large_inc=float(min(100, 16 * itemsize)),
            rho0=float(eps ** (1.0 / 3.0)),
            rho_max=float(min(eps ** (-2.0), fmax * (1 - 2 * eps))),
            rho_min=float(np.sqrt(eps)),
            gamma_A=float(eps ** 0.25),
        )
        vals.update(overrides)
        return Params(**vals)


# Extrapolation step-length clip on the multiplier step
# (reference: Mdlambda = 1e4, /root/reference/src/CaNNOLeS.jl:664-667).
MAX_DLAMBDA = 1e4

# Objective blow-up guard (reference /root/reference/src/CaNNOLeS.jl:638).
F_BLOWUP = 1e60

# Dual-feasibility scaling cap (reference smax, CaNNOLeS.jl:532).
SMAX = 100.0
