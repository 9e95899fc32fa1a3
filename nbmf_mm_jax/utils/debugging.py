"""Development-mode numerical debugging (SURVEY.md §5: the compiled-JAX
analogue of sanitizers for a single-process numerical library)."""

from __future__ import annotations

import contextlib

import jax

__all__ = ["enable_nan_checks", "nan_checks"]


def enable_nan_checks(enable: bool = True) -> None:
    """Globally enable ``jax_debug_nans``: any NaN produced inside jitted
    code raises immediately with the offending primitive (re-runs the
    computation un-jitted to localize it).  Dev-mode only — it disables some
    fusion and slows execution."""
    jax.config.update("jax_debug_nans", enable)


@contextlib.contextmanager
def nan_checks():
    """Scoped variant of :func:`enable_nan_checks`."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)
