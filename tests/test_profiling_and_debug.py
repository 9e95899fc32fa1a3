"""Profiling/debugging utilities (SURVEY.md §5 subsystems)."""

import numpy as np
import pytest

import jax.numpy as jnp

from nbmf_mm_jax.utils import sweep_timer, trace
from nbmf_mm_jax.utils.debugging import nan_checks


def test_sweep_timer_measures_compiled_fn():
    import jax

    f = jax.jit(lambda x: (x @ x.T).sum())
    x = jnp.ones((64, 64))
    dt, per_sec = sweep_timer(f, x, warmup=1, iters=3)
    assert dt > 0 and per_sec == pytest.approx(1.0 / dt)


def test_trace_writes_profile(tmp_path):
    import jax

    with trace(str(tmp_path)):
        jax.block_until_ready(jnp.ones((32, 32)) @ jnp.ones((32, 32)))
    produced = list(tmp_path.rglob("*"))
    assert produced, "profiler trace produced no files"


def test_nan_checks_catches_nan():
    import jax

    @jax.jit
    def bad(x):
        return jnp.log(x - 2.0)  # log of negative -> nan

    with nan_checks():
        with pytest.raises((FloatingPointError, Exception)):
            np.asarray(bad(jnp.ones(4)))
    # config restored
    assert not jax.config.jax_debug_nans


def test_enable_nan_checks_global_toggle():
    import jax

    from nbmf_mm_jax.utils.debugging import enable_nan_checks

    try:
        enable_nan_checks(True)
        assert jax.config.jax_debug_nans
    finally:
        enable_nan_checks(False)
    assert not jax.config.jax_debug_nans


def test_device_memory_stats_shape():
    from nbmf_mm_jax.utils.profiling import device_memory_stats

    stats = device_memory_stats()
    assert isinstance(stats, dict)  # may be empty on CPU backends
