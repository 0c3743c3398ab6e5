"""Test harness config: run everything on a virtual 8-device CPU mesh in
float64 (parity with the reference's Float64 default).

The platform is ``$JAX_PLATFORMS`` when set, else the CPU, chosen before any
backend is initialized; 8 host devices are requested so sharding tests
exercise real multi-device code paths (SURVEY.md §4 rebuild mapping (e)).
Tests marked ``gpu`` need a card: the ``gpu`` fixture skips them elsewhere
(``chip_smoke.py`` runs the same checks on the card).
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax
import pytest

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r}); run chip_smoke.py on the card")
    return dev
