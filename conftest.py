"""Test-session configuration (runs before test collection).

Mirrors the reference's test strategy (SURVEY.md §4): property tests run on
the CPU backend in float64 (the monotonicity tolerances require f64
accumulation), with 8 virtual devices so mesh/GSPMD tests exercise real
sharding + collectives without accelerators.  ``JAX_PLATFORMS``, when set,
selects the platform instead (``JAX_PLATFORMS=cuda`` for the gpu-marked
tests on the card); x64 is enabled only on the CPU.
"""

import os
import sys

_platform = os.environ.get("JAX_PLATFORMS") or "cpu"
os.environ["JAX_PLATFORMS"] = _platform
if _platform == "cpu":
    os.environ.setdefault("JAX_ENABLE_X64", "1")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if _platform == "cpu" and os.environ.get("JAX_ENABLE_X64") == "1":
    jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(__file__))
