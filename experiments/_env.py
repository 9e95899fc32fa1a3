"""Platform selection for experiment scripts.

Reproduction/validation scripts default to CPU + float64 (the reference's
numerical regime); pass ``--platform gpu`` / set ``NBMF_PLATFORM=gpu`` for
device runs (f32).  The platform is set through ``jax.config`` before any
backend initializes.
"""

from __future__ import annotations

import os


def force_platform(platform: str | None = None) -> str:
    """Select the JAX platform (default: ``NBMF_PLATFORM`` env or ``cpu``).

    ``gpu`` raises if JAX finds no GPU; ``cpu`` also enables x64 so parity
    checks run in float64; ``default`` leaves JAX's own choice.  Returns the
    platform chosen.  Must be called before any jax computation.
    """
    import jax

    platform = platform or os.environ.get("NBMF_PLATFORM", "cpu")
    if platform == "gpu":
        jax.config.update("jax_platforms", "cuda")
        if jax.devices()[0].platform != "gpu":
            raise RuntimeError("no GPU backend is available")
        return platform
    if platform != "default":
        os.environ["JAX_PLATFORMS"] = platform
        jax.config.update("jax_platforms", platform)
    if platform == "cpu":
        jax.config.update("jax_enable_x64", True)
    return platform
