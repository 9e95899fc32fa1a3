"""Core MM update and objective math for mean-parameterized Bernoulli matrix
factorization (NBMF-MM), expressed as pure functions on ``jnp`` arrays.

The model is ``V ~ Bernoulli(W @ H)`` with ``V in {0,1}^{m x n}`` (any values in
``[0,1]`` are accepted), a simplex constraint on one factor and an elementwise
Beta(alpha, beta) prior on the other.  One MM sweep performs a multiplicative
update of the Beta factor followed by a multiplicative update + simplex step of
the Dirichlet factor, and is guaranteed to monotonically decrease the
(negative) MAP objective (Magron & Fevotte, 2022).

Everything here is written for the canonical "beta-dir" orientation in the
*internal* layout:

- ``W``: shape ``(k, m)``, columns sum to 1 (the simplex factor, transposed),
- ``H``: shape ``(k, n)``, entries in ``(0, 1)`` (the Beta-prior factor).

The "dir-beta" orientation is handled by the solver driver via the transpose
symmetry of the model (see :mod:`nbmf_mm_jax.solver.driver`).

Masked data enters through three loop-invariant matrices precomputed once by
:func:`precompute_masked_terms` (the reference recomputes them every sweep):

- ``Ym  = Y * mask``          — feeds every "positive" (``log WH``) term,
- ``Ym2 = (1 - Y) * mask``    — feeds the W update's negative term,
- ``Yc``                      — the complement used by the H-update
  denominator and by the objective.  In ``mask_mode="parity"`` this is
  ``1 - Ym`` (the reference's exact, slightly asymmetric semantics where
  unobserved entries act as observed zeros in those two places — reference
  ``src/nbmf_mm/_solver.py:43,154``); in ``mask_mode="corrected"`` it is
  ``(1 - Y) * mask`` so unobserved entries contribute nothing anywhere.

Behavioral parity notes (vs. the reference implementation ``siddC/nbmf_mm``):

- Update formulas match ``src/nbmf_mm/_solver.py:39-57`` exactly, including
  the epsilon placement, the clip-then-use ordering for ``H``, and the
  divide-by-n + column-renormalization simplex step for ``W``.
- The objective matches ``src/nbmf_mm/_solver.py:148-162``: mean masked
  Bernoulli NLL plus Beta-prior terms, normalized by the observed count.

These functions avoid data-dependent Python control flow so they can be
``jit``-ed, ``vmap``-ed over restarts, and sharded with GSPMD unchanged.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .projection import project_columns_simplex_duchi

__all__ = [
    "precompute_masked_terms",
    "h_contractions",
    "w_contraction",
    "log_likelihood",
    "mm_sweep",
    "map_objective",
    "fold_in_w_update",
]


def precompute_masked_terms(
    Y: jnp.ndarray,
    mask: Optional[jnp.ndarray],
    mask_mode: str = "parity",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Precompute the loop-invariant masked matrices ``(Ym, Ym2, Yc)``.

    See the module docstring for their roles.  With ``mask=None`` the two
    modes coincide and ``Ym2 is Yc``.
    """
    if mask_mode not in ("parity", "corrected"):
        raise ValueError(f"unknown mask_mode: {mask_mode!r}")
    if mask is None:
        comp = 1.0 - Y
        return Y, comp, comp
    mask = mask.astype(Y.dtype)
    Ym = Y * mask
    Ym2 = (1.0 - Y) * mask
    Yc = (1.0 - Ym) if mask_mode == "parity" else Ym2
    return Ym, Ym2, Yc


def clip_upper_interior(eps, dtype):
    """Upper clip bound for the Beta factor, strictly below 1 in ``dtype``.

    The reference clips to ``1 - eps`` with ``eps = 1e-8`` — below the f32
    ulp at 1.0 (6e-8), so in f32 that bound rounds to exactly 1.0 and H can
    reach the boundary.  Downstream, XLA may reassociate ``1 - H + eps``
    into ``(1 + eps) - H`` (== ``1 - H`` in f32), turning the prior/loss
    logs into ``log(0) = -inf`` — observed under jit at ``beta < 1``.
    Bounding by the largest representable value below 1 keeps every
    ``1 - H (+ eps)`` strictly positive under any association.  In f64
    ``1 - 1e-8`` is exactly representable and this returns it unchanged
    (reference parity preserved).
    """
    below_one = np.nextafter(np.asarray(1.0, dtype), np.asarray(0.0, dtype))
    return jnp.minimum(jnp.asarray(1.0, dtype) - eps, below_one)


def h_contractions(W, H, Ym, Yc, eps=1e-8, precision=jax.lax.Precision.HIGHEST):
    """The H update's two contractions ``(W @ (Ym / (W.T@H + eps)),
    W @ (Yc / (1 - W.T@H + eps)))``, each ``(k, n)`` — the plain reference
    for the fused H pass (:func:`nbmf_mm_jax.ops.pallas_sweep.hloss_terms`)."""
    dot = partial(jnp.matmul, precision=precision)
    WH = dot(W.T, H)  # (m, n)
    return (
        dot(W, Ym / (WH + eps)),
        dot(W, Yc / (jnp.maximum(1.0 - WH, 0.0) + eps)),
    )


def w_contraction(W, H_new, Ym, Ym2, eps=1e-8, precision=jax.lax.Precision.HIGHEST):
    """The W update's contraction ``T = H @ (Ym / (W.T@H + eps)).T
    + (1-H) @ (Ym2 / (1 - W.T@H + eps)).T`` ``(k, m)`` — the plain reference
    for the fused W pass (:func:`nbmf_mm_jax.ops.pallas_sweep.w_terms`).

    The reference forms ``HW_T = H_new.T @ W`` of shape ``(n, m)`` and
    contracts ``H_new @ (Y.T*mask.T / HW_T)``; this is the transpose-free
    equivalent ``(Ym / (W.T @ H_new)).T``, identical values without
    materializing transposed copies."""
    dot = partial(jnp.matmul, precision=precision)
    WHn = dot(W.T, H_new)  # (m, n) == HW_T.T
    return dot(H_new, (Ym / (WHn + eps)).T) + dot(
        1.0 - H_new, (Ym2 / (jnp.maximum(1.0 - WHn, 0.0) + eps)).T
    )


def log_likelihood(W, H, Ym, Yc, eps=1e-8, precision=jax.lax.Precision.HIGHEST):
    """Masked Bernoulli log-likelihood ``sum(Ym log(WH+eps) + Yc
    log(1-WH+eps))`` — the loss term of the fused H pass."""
    WH = jnp.matmul(W.T, H, precision=precision)
    return jnp.sum(Ym * jnp.log(WH + eps) + Yc * jnp.log(jnp.maximum(1.0 - WH, 0.0) + eps))


def _h_update(W, H, Ym, Yc, alpha, beta, eps, precision):
    """Multiplicative Beta-factor update (reference ``_solver.py:39-47``)."""
    # num = H (*) W @ (Ym / WH) + (alpha - 1);  den mirrors with complements.
    Num, Den = h_contractions(W, H, Ym, Yc, eps, precision)
    num = H * Num + (alpha - 1.0)
    den = (1.0 - H) * Den + (beta - 1.0)
    H_new = num / (num + den + eps)
    return jnp.clip(H_new, eps, clip_upper_interior(eps, H.dtype))


def _w_update(W, H_new, Ym, Ym2, n_real, eps, projection, precision):
    """Multiplicative simplex-factor update (reference ``_solver.py:50-57``)."""
    W_raw = W * w_contraction(W, H_new, Ym, Ym2, eps, precision)  # (k, m)
    if projection == "normalize":
        # Paper-exact simplex step: /n keeps columns on the simplex up to
        # rounding; the renormalization is a numerical-stability safeguard.
        W_new = W_raw / n_real
        col_sums = W_new.sum(axis=0, keepdims=True)
        # Guard zero columns (cannot occur for positive data, but keeps the
        # padded / degenerate cases NaN-free without changing live columns).
        W_new = W_new / jnp.where(col_sums > 0, col_sums, 1.0)
    elif projection == "duchi":
        # Euclidean (sort-based) projection of each column onto the simplex.
        W_new = project_columns_simplex_duchi(W_raw / n_real)
    else:  # pragma: no cover - validated at the API boundary
        raise ValueError(f"unknown projection: {projection!r}")
    return W_new


def mm_sweep(
    W: jnp.ndarray,
    H: jnp.ndarray,
    Ym: jnp.ndarray,
    Ym2: jnp.ndarray,
    Yc: jnp.ndarray,
    *,
    alpha: float,
    beta: float,
    n_real: int,
    eps: float = 1e-8,
    projection: str = "normalize",
    precision=jax.lax.Precision.HIGHEST,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One full MM sweep: H update (old W) then W update (new H).

    Parameters use the internal layout documented in the module docstring.
    ``n_real`` is the (unpadded) number of columns of the data matrix; it is
    the MM scaling constant of the simplex step (reference ``_solver.py:54``).
    """
    H_new = _h_update(W, H, Ym, Yc, alpha, beta, eps, precision)
    W_new = _w_update(W, H_new, Ym, Ym2, n_real, eps, projection, precision)
    return W_new, H_new


def map_objective(
    W: jnp.ndarray,
    H: jnp.ndarray,
    Ym: jnp.ndarray,
    Yc: jnp.ndarray,
    *,
    alpha: float,
    beta: float,
    n_obs,
    eps: float = 1e-8,
    precision=jax.lax.Precision.HIGHEST,
    col_validity=None,
) -> jnp.ndarray:
    """Negative MAP objective per observed entry (reference ``_solver.py:148-162``).

    ``loss = -(sum(Ym log(WH+eps) + Yc log(1-WH+eps))
              + (alpha-1) sum(log(H+eps)) + (beta-1) sum(log(1-H+eps))) / n_obs``

    ``col_validity`` (``(1, n)`` 0/1) restricts the Beta-prior sums to the
    real columns of a zero-padded ``H`` (GSPMD shard padding; the
    log-likelihood term needs no mask — zero-padded ``Ym``/``Yc`` entries
    contribute exactly nothing).
    """
    log_lik = log_likelihood(W, H, Ym, Yc, eps, precision)
    log_h = jnp.log(H + eps)
    log_1mh = jnp.log(1.0 - H + eps)
    if col_validity is not None:
        log_h = log_h * col_validity
        log_1mh = log_1mh * col_validity
    prior_a = (alpha - 1.0) * jnp.sum(log_h)
    prior_b = (beta - 1.0) * jnp.sum(log_1mh)
    return -(log_lik + prior_a + prior_b) / n_obs


def fold_in_w_update(
    Wt: jnp.ndarray,
    H: jnp.ndarray,
    Ym: jnp.ndarray,
    Ym2: jnp.ndarray,
    *,
    n_features: int,
    eps: float = 1e-8,
    precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """One fold-in iteration used by ``transform`` (reference ``_base.py:178-193``):
    the beta-dir W update with ``H`` held fixed.  ``Wt`` has internal layout
    ``(k, m)``; returns the updated ``(k, m)`` factor with unit column sums.
    """
    Wt = Wt * w_contraction(Wt, H, Ym, Ym2, eps, precision) / n_features
    col_sums = Wt.sum(axis=0, keepdims=True)
    return Wt / jnp.where(col_sums > 0, col_sums, 1.0)
