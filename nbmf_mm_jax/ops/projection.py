"""On-device simplex projections.

Two simplex steps are supported by the solver (the reference README documents
both, ``README.md:27-30,90-94``, but its code only ships the multiplicative
"normalize" step — the ``duchi`` path was removed upstream and is implemented
for real here):

- ``"normalize"`` — the paper-exact MM step (divide by ``n`` then L1-normalize
  columns), implemented inline in :mod:`nbmf_mm_jax.ops.updates` because it is
  part of the MM majorizer and preserves the monotone-descent guarantee.
- ``"duchi"`` — Euclidean projection onto the probability simplex via the
  O(k log k) sort-based algorithm of Duchi, Shalev-Shwartz, Singer & Chandra
  (ICML 2008).  ``k`` is the factorization rank (small), so the sort runs on
  tiny ``(k, m)`` arrays and is negligible next to the ``(m, n)`` sweeps.

All functions are jit/vmap/GSPMD-compatible (no data-dependent shapes).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["project_columns_simplex_duchi", "project_simplex_duchi"]


def project_columns_simplex_duchi(X: jnp.ndarray) -> jnp.ndarray:
    """Project each column of ``X`` (shape ``(k, m)``) onto the probability
    simplex ``{w : w >= 0, sum(w) = 1}`` in Euclidean norm.

    Vectorized sort-based algorithm: for a column ``x`` with descending sort
    ``u`` and cumulative sums ``c``, the active-set size is
    ``rho = max{ j : u_j > (c_j - 1) / j }`` and the threshold is
    ``tau = (c_rho - 1) / rho``; the projection is ``max(x - tau, 0)``.
    """
    k = X.shape[0]
    u = -jnp.sort(-X, axis=0)  # descending sort per column
    css = jnp.cumsum(u, axis=0)
    j = jnp.arange(1, k + 1, dtype=X.dtype).reshape((k,) + (1,) * (X.ndim - 1))
    cond = u > (css - 1.0) / j
    # `cond` is prefix-true along axis 0, so the active-set size is its sum.
    rho = jnp.sum(cond, axis=0, keepdims=True).astype(jnp.int32)
    css_rho = jnp.take_along_axis(css, rho - 1, axis=0)
    tau = (css_rho - 1.0) / rho.astype(X.dtype)
    return jnp.maximum(X - tau, 0.0)


def project_simplex_duchi(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Project slices of ``x`` along ``axis`` onto the probability simplex."""
    moved = jnp.moveaxis(x, axis, 0)
    return jnp.moveaxis(project_columns_simplex_duchi(moved), 0, axis)
