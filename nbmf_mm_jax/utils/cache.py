"""Persistent XLA compilation cache for the repository's launchers.

Every first ``fit`` at a new (shape, options) signature pays an XLA compile.
JAX's persistent compilation cache keeps compiled executables on disk keyed
by program fingerprint, so that cost is paid once per machine instead of
once per process.  The launchers (``chip_smoke.py``, ``bench.py``,
``experiments/flagship_scale.py``) call :func:`enable_compilation_cache`;
plain package import and the test suite do not.

- If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that directory
  and nothing is set in code.
- Otherwise the cache goes to the fixed ``<checkout>/.jax_cache`` (listed in
  ``.gitignore``): the path is part of the cache key, so a fixed directory
  is what lets a later process hit it.

Caveat (CPU backend): XLA:CPU AOT cache entries embed the *compile host's*
CPU feature set; on VMs that migrate between physical hosts, reloading a
stale CPU entry triggers loud machine-feature-mismatch warnings and can in
principle SIGILL.  GPU executables are keyed to the GPU target and are not
affected, so launchers enable the cache only on the GPU.
"""

from __future__ import annotations

import os

__all__ = ["enable_compilation_cache"]

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache and return its directory:
    ``$JAX_COMPILATION_CACHE_DIR`` when set (left to JAX), else
    ``<checkout>/.jax_cache``.  Write thresholds are lowered so even
    sub-second programs are cached (the default min-compile-time gate would
    skip most of this library's programs)."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = _DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
