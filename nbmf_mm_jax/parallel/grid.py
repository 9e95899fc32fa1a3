"""Batched hyperparameter grid solves.

The reference's Figure-1 experiment loops over an (alpha, beta) grid of
independent fits in Python (``examples/reproduce_magron2022.py:75-152``),
paying full solver time per cell.  On an accelerator the natural formulation is a
``vmap`` over the hyperparameter axis: every grid cell advances in lockstep
inside one compiled program, so a 36-cell grid costs one compile and one
batched while_loop whose matmuls are (grid,)-batched.

Hyperparameters are *traced* scalars in the solver core, which is what makes
this legal without recompilation per cell.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.updates import precompute_masked_terms
from ..solver.driver import (
    _resolve_backend,
    _resolve_dtype,
    _resolve_precision,
    _solve_core,
)

__all__ = ["grid_solve"]


def grid_solve(
    Y,
    n_components: int,
    alphas: Sequence[float],
    betas: Sequence[float],
    *,
    max_iter: int = 500,
    tol: float = 1e-5,
    mask=None,
    random_state: Optional[int] = 0,
    eps: float = 1e-8,
    projection: str = "normalize",
    mask_mode: str = "parity",
    dtype=None,
    precision=None,
    pair_mode: str = "product",
    backend: str = "auto",
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    pallas_interpret: bool = False,
    packed: Optional[bool] = None,
):
    """Solve NBMF-MM for every (alpha, beta) cell in one batched program.

    ``pair_mode="product"`` runs the full cartesian grid
    ``len(alphas) x len(betas)``; ``"zip"`` pairs them elementwise.  All cells
    share the same seeded initialization (as the reference's grid loop does
    with a fixed ``random_state``), isolating the hyperparameter effect.

    ``scipy.sparse`` input densifies here (hyperparameter grids run at
    paper scale; the no-dense-staging sparse ingestion lives in
    :func:`~nbmf_mm_jax.solver.driver.solve`, which a per-cell loop can
    use if a grid must run at packed-ceiling sizes).

    ``packed`` follows :func:`~nbmf_mm_jax.solver.driver.solve`'s contract:
    ``None`` auto-bitpacks exactly-binary data on the Pallas path, ``False``
    disables, ``True`` requires eligibility and raises otherwise.

    Returns a dict of stacked results with a leading grid axis:
    ``W (G, m, k)``, ``H (G, k, n)``, ``losses (G, max_iter)``,
    ``n_iter (G,)``, ``final_loss (G,)``, plus ``alpha (G,)`` / ``beta (G,)``.
    """
    if projection not in ("normalize", "duchi"):
        # Validated up front for every backend (same reason as solve(): the
        # Pallas route only string-compares inside the compiled loop, so a
        # typo would silently select the other projection).
        raise ValueError(
            f"projection must be 'normalize' or 'duchi', got {projection!r}"
        )
    dtype = _resolve_dtype(dtype)
    # Same two-tier default as solve(): jnp path HIGHEST, Pallas path
    # DEFAULT (TF32 products on the GPU); an explicit argument is honored on both.
    kernel_precision = None if precision is None else _resolve_precision(precision)
    precision = _resolve_precision(precision)

    # bf16 translation, exactly as solve(): bf16 is a DATA-storage mode —
    # factors, losses, and the tol comparison stay f32 (bf16 losses quantize
    # to ~0.4% resolution and falsely converge after ~2 sweeps).
    data_dtype = None
    if dtype == jnp.dtype(jnp.bfloat16):
        data_dtype = jnp.bfloat16
        dtype = jnp.dtype(jnp.float32)
        precision = jax.lax.Precision.DEFAULT
        kernel_precision = None

    Y = np.asarray(Y.toarray() if hasattr(Y, "toarray") else Y, dtype=dtype)
    if mask is not None:
        mask = np.asarray(mask.toarray() if hasattr(mask, "toarray") else mask, dtype=dtype)
    m, n = Y.shape
    k = int(n_components)

    if pair_mode == "product":
        A, B = np.meshgrid(np.asarray(alphas), np.asarray(betas), indexing="ij")
        a_flat, b_flat = A.ravel(), B.ravel()
    elif pair_mode == "zip":
        a_flat = np.asarray(alphas, dtype=float)
        b_flat = np.asarray(betas, dtype=float)
        if a_flat.shape != b_flat.shape:
            raise ValueError("zip pair_mode requires len(alphas) == len(betas)")
    else:
        raise ValueError(f"unknown pair_mode: {pair_mode!r}")

    # Same seeded init as driver.solve(random_state=...) with n_init=1, so a
    # grid cell is bit-identical to the equivalent standalone fit.
    from ..solver.driver import _random_uniform_inits

    key = jax.random.PRNGKey(0 if random_state is None else int(random_state))
    W0b, H0b = _random_uniform_inits(key, 1, m, n, k, dtype)
    W0 = jnp.swapaxes(W0b, 1, 2)[0]
    W0 = W0 / W0.sum(axis=0, keepdims=True)
    H0 = H0b[0]

    Ym, Ym2, Yc = precompute_masked_terms(
        jnp.asarray(Y), None if mask is None else jnp.asarray(mask), mask_mode
    )
    n_obs = (
        jnp.array(Y.size, dtype=dtype)
        if mask is None
        else jnp.count_nonzero(mask).astype(dtype)
    )

    alphas_d = jnp.asarray(a_flat, dtype=dtype)
    betas_d = jnp.asarray(b_flat, dtype=dtype)
    # "auto" routes to the fused kernels on the GPU for <= f32 (same
    # resolution rule as driver.solve), so Figure-1-style grids take the
    # fast path on the card.
    if _resolve_backend(backend, dtype, kernel_precision):
        # Fused-kernel grid: the hyperparameter axis vmaps over the fused
        # while_loop exactly like the restart axis does.
        from ..ops import pallas_sweep as ps
        from ..solver.driver import _solve_core_pallas, _stage_fused_operands

        Mp, Np = ps.padded_dims(m, n, block_m, block_n)
        W0p = jnp.pad(W0, ((0, 0), (0, Mp - m)))
        H0p = jnp.pad(H0, ((0, 0), (0, Np - n)))
        # Only the operands the kernels read: unmasked data streams Ym alone
        # (the complement is formed in registers); corrected mode's Yc is
        # Ym2.  All grid cells share one staged (and, for exactly-binary
        # data, packed) copy.
        masked = mask is not None
        Ymp, Ym2p, Ycp, use_packed = _stage_fused_operands(
            Ym,
            Ym2 if masked else None,
            Ym2 if masked and mask_mode == "corrected" else None,
            Mp, Np, packed=packed, data_dtype=data_dtype,
        )
        core = partial(
            _solve_core_pallas,
            max_iter=max_iter, projection=projection, verbose=0,
            eps=float(eps), m_real=m, n_real=n,
            block_m=block_m, block_n=block_n, interpret=pallas_interpret,
            packed=use_packed, kernel_precision=kernel_precision,
        )
        batched = jax.vmap(
            core, in_axes=(None, None, None, None, None, 0, 0, None, None)
        )
        W, H, losses, n_iter, final_loss, done = batched(
            Ymp, Ym2p, Ycp, W0p, H0p,
            alphas_d, betas_d, jnp.array(tol, dtype=dtype), n_obs,
        )
        W, H = W[:, :, :m], H[:, :, :n]
    else:
        if packed is True:
            raise ValueError(
                "packed=True requires the Pallas backend (backend='pallas', "
                "or 'auto' resolving to it on the GPU with dtype <= float32)"
            )
        core = partial(
            _solve_core,
            max_iter=max_iter,
            projection=projection,
            precision=precision,
            verbose=0,
        )
        batched = jax.vmap(
            core, in_axes=(None, None, None, None, None, 0, 0, None, None, None, None)
        )
        W, H, losses, n_iter, final_loss, done = batched(
            Ym,
            Ym2,
            Yc,
            W0,
            H0,
            alphas_d,
            betas_d,
            jnp.array(tol, dtype=dtype),
            jnp.array(eps, dtype=dtype),
            n_obs,
            jnp.array(n, dtype=dtype),
        )
    return {
        "alpha": a_flat,
        "beta": b_flat,
        "W": np.swapaxes(np.asarray(W), 1, 2),  # external (G, m, k)
        "H": np.asarray(H),
        "losses": np.asarray(losses),
        "n_iter": np.asarray(n_iter),
        "final_loss": np.asarray(final_loss),
        "converged": np.asarray(done),
    }
