"""Tracing / profiling hooks (SURVEY.md §5).

The reference has essentially no observability: examples wrap ``fit`` in
``time.time()`` and the solver's returned ``time_elapsed`` is hard-coded 0.0
(``_solver.py:216``).  Here:

- :func:`trace` wraps a region in a ``jax.profiler`` trace (viewable in
  TensorBoard / Perfetto);
- :func:`sweep_timer` measures *device* time per MM sweep via
  ``block_until_ready`` around a compiled sweep, amortizing dispatch;
- :func:`device_memory_stats` surfaces per-device memory usage when the
  backend reports it;
- :func:`require_gpu` and :func:`gpu_card` are the launchers' device check
  and the card line (name, power limit) written beside every measurement.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import jax

__all__ = ["trace", "sweep_timer", "device_memory_stats", "require_gpu", "gpu_card"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a jax.profiler trace of the enclosed region into ``log_dir``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def sweep_timer(fn, *args, warmup: int = 2, iters: int = 10):
    """Time a compiled function's steady-state device execution.

    Returns ``(seconds_per_call, calls_per_second)``.  ``fn`` must return
    jax arrays (they are blocked on to include device time).
    """
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    return dt, 1.0 / dt


def device_memory_stats(device=None) -> dict:
    """Best-effort memory stats for ``device`` (default: first device)."""
    device = device or jax.devices()[0]
    stats = getattr(device, "memory_stats", lambda: None)()
    return dict(stats) if stats else {}


def require_gpu():
    """Return ``jax.devices()`` if JAX runs on a GPU; raise otherwise.  A
    measurement that finds no GPU fails instead of falling back."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {devices[0].platform!r} ({devices[0].device_kind})"
        )
    return devices


def gpu_card() -> str:
    """The cards' name and power limit, one line per card, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
