"""Helpers for running on the host CPU (virtual multi-device) platform.

Call :func:`force_cpu` before any JAX backend initialization (it sets
``jax_platforms`` to cpu, so a machine with a GPU stays off it) and
optionally request N virtual host devices for mesh tests without hardware.
"""

from __future__ import annotations

import os


def force_cpu(n_devices: int | None = None, x64: bool = True) -> None:
    if n_devices is not None and "--xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""
    ):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={n_devices}"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if x64:
        jax.config.update("jax_enable_x64", True)
