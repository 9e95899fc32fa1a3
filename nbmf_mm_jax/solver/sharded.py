"""Sharded fused solver: the fused sweep kernels inside ``shard_map`` over
a 2-D device mesh.

The GSPMD path (:mod:`nbmf_mm_jax.parallel.sharding`) lets XLA partition the
*XLA* sweep automatically; this module is the multi-device **fast** path:
the fused 2-pass kernels run on each device's local block of the data and
the cross-device reductions are explicit collectives —

- H+loss pass: local ``(Num, Den, ll)`` partials from the local ``m`` block,
  then ``psum`` over the ``rows`` axis (``ll`` over both axes);
- W pass: local ``T`` partials from the local ``n`` block, ``psum`` over
  ``cols``.

Those are exactly the reductions the math requires; everything else
(elementwise factor updates, the convergence test) is local and replicated-
consistent because the psum'd loss is identical on every device.  Per sweep
each device exchanges only ``(k, n_local) + (k, m_local)`` floats — the big
``(m, n)`` data never moves.

Padding contract (different from the single-device path): every operand is
padded so each *shard* is block-aligned, the complements ``Ym2``/``Yc`` are
always materialized with zero pads (pad entries then contribute exactly
nothing to every contraction and to the loss, with no in-kernel validity
masks), and a column-validity vector ``Vn`` (sharded like ``H``) keeps H's
pad columns at zero and excludes them from the Beta-prior sums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import pallas_sweep as ps
from ..ops.projection import project_columns_simplex_duchi
from ..ops.updates import clip_upper_interior

__all__ = [
    "solve_core_sharded",
    "plan_shard_padding",
    "pack_words_for_mesh",
]


def pack_words_for_mesh(
    Y,
    mask,
    *,
    mesh: Mesh,
    mesh_axes: Tuple[str, str],
    block_m: Optional[int],
    block_n: Optional[int],
    mask_mode: str = "parity",
):
    """Build the ``(Ymw, Ym2w, Ycw)`` pre-packed word arrays for
    :func:`solve_core_sharded` ``packed_words=`` from ``scipy.sparse``
    operands — chunk by chunk, so no dense copy of the matrix ever exists.

    ``Y`` (and ``mask``, if given) must be canonical exactly-binary CSR
    (see ``ops.packed.csr_binary_canonical``; the solver driver validates
    before calling).  The three operands follow the sharded padding
    contract (module docstring): ``Ym = Y*mask``, ``Ym2 = (1-Y)*mask``,
    ``Yc`` = parity complement ``1 - Ym`` (zero pads) or the corrected
    alias ``Ym2``.  The word layout does not depend on blocks, so the words
    of the whole padded matrix shard into exactly the words of each local
    block.  Returns int32 numpy arrays of shape ``(Mp//32, Np)``.
    """
    from ..ops.packed import pack_sparse_words

    rows, cols = mesh_axes
    Mp, Np = plan_shard_padding(
        *Y.shape, mesh.shape[rows], mesh.shape[cols], block_m, block_n
    )
    if mask is not None:
        Ym_s = Y.multiply(mask).tocsr()
        Ym2_s = (mask - Ym_s).tocsr()
    else:
        Ym_s, Ym2_s = Y, None

    wm = pack_sparse_words(Ym_s, Mp, Np)
    if Ym2_s is not None:
        wm2 = pack_sparse_words(Ym2_s, Mp, Np)
    else:  # unmasked: Ym2 is the complement (dense as sparse, free as bits)
        wm2 = pack_sparse_words(Ym_s, Mp, Np, complement=True)
    if mask is None or mask_mode == "corrected":
        wc = wm2  # corrected aliases Ym2; unmasked complement == Ym2 too
    else:  # parity: Yc = 1 - Ym in the real region, zero pads
        wc = pack_sparse_words(Ym_s, Mp, Np, complement=True)
    return wm, wm2, wc


def plan_shard_padding(m: int, n: int, n_rows: int, n_cols: int,
                       block_m: Optional[int], block_n: Optional[int]) -> Tuple[int, int]:
    """Padded global ``(Mp, Np)`` for an ``(m, n)`` problem over an
    ``n_rows x n_cols`` mesh: each shard's local block is padded like a
    single-device problem (:func:`~nbmf_mm_jax.ops.pallas_sweep.padded_dims`),
    so its rows are a multiple of 32 and packed words split at shard
    boundaries."""
    m_loc, n_loc = ps.padded_dims(-(-m // n_rows), -(-n // n_cols), block_m, block_n)
    return m_loc * n_rows, n_loc * n_cols


def solve_core_sharded(
    Ym,
    Ym2,
    Yc,
    W0,
    H0,
    alpha,
    beta,
    tol,
    n_obs,
    *,
    mesh: Mesh,
    mesh_axes: Tuple[str, str],
    max_iter: int,
    projection: str,
    eps: float,
    m_real: int,
    n_real: int,
    block_m: Optional[int],
    block_n: Optional[int],
    interpret: bool = False,
    data_dtype=None,
    packed: bool = False,
    kernel_precision=None,
    packed_words=None,
):
    """Run the shifted-loss 2-pass loop with per-shard fused kernels.

    ``packed=True`` (caller guarantees exactly-binary operands) bitpacks
    each device's LOCAL data blocks inside the shard_map and runs the
    kernels on words per shard — the collectives are unchanged (they move
    ``(k, ·)`` factor terms, never data).

    ``packed_words`` (sparse-ingestion fast path): a ``(Ymw, Ym2w, Ycw)``
    tuple of pre-packed int32 word arrays shaped ``(Mp//32, Np)`` for the
    padding this function derives (``pack_words_for_mesh`` builds them from
    ``scipy.sparse`` operands chunk by chunk).  Dense ``Ym``/``Ym2``/``Yc``
    are then ignored (pass ``None``) — the data never exists dense, host
    or device.

    Inputs are *unpadded* device-agnostic arrays in the internal layout with
    a leading restart axis: ``W0 (b, k, m)`` unit-column-sum, ``H0 (b, k,
    n)`` — the restart axis is ``vmap``-ed *inside* the shard_map (every
    restart advances in lockstep on every shard).  This function plans the
    shard-aligned padding, places the operands, and returns unpadded batched
    results ``(W, H, losses, n_iter, final_loss, done)``.
    """
    rows, cols = mesh_axes
    n_rows, n_cols = mesh.shape[rows], mesh.shape[cols]
    m, n = (m_real, n_real) if packed_words is not None else Ym.shape
    dtype = W0.dtype

    Mp, Np = plan_shard_padding(m, n, n_rows, n_cols, block_m, block_n)

    W0p = jnp.pad(W0, ((0, 0), (0, 0), (0, Mp - m)))
    H0p = jnp.pad(H0, ((0, 0), (0, 0), (0, Np - n)))
    Vn = (jnp.arange(Np)[None, :] < n_real).astype(dtype)  # (1, Np)

    dsh = NamedSharding(mesh, P(rows, cols))
    W0p = jax.device_put(W0p, NamedSharding(mesh, P(None, None, rows)))
    H0p = jax.device_put(H0p, NamedSharding(mesh, P(None, None, cols)))
    Vn = jax.device_put(Vn, NamedSharding(mesh, P(None, cols)))

    m_loc, n_loc = Mp // n_rows, Np // n_cols
    prepacked = packed_words is not None
    use_packed = packed or prepacked
    kw = dict(block_m=block_m, block_n=block_n, packed=use_packed, interpret=interpret,
              precision=kernel_precision, eps=eps)

    if prepacked:
        want = (Mp // ps.WORD_BITS, Np)
        for name, Aw in zip(("Ym", "Ym2", "Yc"), packed_words):
            if tuple(Aw.shape) != want:
                raise ValueError(
                    f"packed_words[{name}] has shape {tuple(Aw.shape)}, "
                    f"expected {want} (pack with pack_words_for_mesh for "
                    "this mesh and shape)"
                )
        Ymp, Ym2p, Ycp = (
            jax.device_put(jnp.asarray(Aw), dsh) for Aw in packed_words
        )
    else:
        # Parity mode aliases Yc == 1 - Ym *inside the real region*; pads
        # must be zero, so the complement is always materialized explicitly.
        Ymp, Ym2p, Ycp = (ps.pad_to(A, Mp, Np) for A in (Ym, Ym2, Yc))
        if data_dtype is not None:
            Ymp, Ym2p, Ycp = (A.astype(data_dtype) for A in (Ymp, Ym2p, Ycp))
        Ymp, Ym2p, Ycp = (jax.device_put(A, dsh) for A in (Ymp, Ym2p, Ycp))

    def local_loop(Ym_l, Ym2_l, Yc_l, W_b0, H_b0, Vn_l, alpha, beta, tol, n_obs):
        if packed and not prepacked:
            # Pack each local block once, outside the while_loop (the word
            # layout is block-independent, so local words are exactly the
            # matching slice of the global words).
            Ym_l, Ym2_l, Yc_l = (ps.pack_bits(A) for A in (Ym_l, Ym2_l, Yc_l))
        hloss_local = lambda W_l, H_l: ps.hloss_terms(
            W_l, H_l, Ym_l, Yc_l, m_real=m_loc, n_real=n_loc, **kw
        )
        wterms_local = lambda W_l, H_new: ps.w_terms(
            W_l, H_new, Ym_l, Ym2_l, n_real=n_loc, **kw
        )

        def objective_from_ll(ll_partial, H_l):
            ll = jax.lax.psum(ll_partial, (rows, cols))
            # Beta-prior sums over the real columns only (Vn zeroes pads);
            # H is replicated over `rows`, sharded over `cols`.
            pa = (alpha - 1.0) * jax.lax.psum(
                jnp.sum(jnp.log(H_l + eps) * Vn_l), cols
            )
            pb = (beta - 1.0) * jax.lax.psum(
                jnp.sum(jnp.log(1.0 - H_l + eps) * Vn_l), cols
            )
            return (-(ll + pa + pb) / n_obs).astype(dtype)

        def finish_sweep(W_l, H_l, Num, Den):
            num = H_l * Num + (alpha - 1.0)
            den = (1.0 - H_l) * Den + (beta - 1.0)
            # dtype-aware upper bound (ops.updates.clip_upper_interior)
            H_new = jnp.clip(
                num / (num + den + eps), eps,
                clip_upper_interior(eps, W_l.dtype),
            ) * Vn_l
            T = jax.lax.psum(wterms_local(W_l, H_new), cols)
            W_raw = W_l * T
            if projection == "normalize":
                W_new = W_raw / n_real
                col_sums = W_new.sum(axis=0, keepdims=True)
                W_new = W_new / jnp.where(col_sums > 0, col_sums, 1.0)
            else:
                W_new = project_columns_simplex_duchi(W_raw / n_real)
                # re-zero pad columns (all-zero cols project to uniform)
                zero_cols = W_l.sum(axis=0, keepdims=True) == 0
                W_new = jnp.where(zero_cols, 0.0, W_new)
            return W_new, H_new

        losses0 = jnp.zeros((max_iter,), dtype=dtype)

        def cond(carry):
            _, _, _, _, it, done = carry
            return jnp.logical_and(it < max_iter, jnp.logical_not(done))

        # (cond/body below operate on ONE restart; the restart axis is
        # vmapped at the bottom — the freeze semantics make that exact.)

        def body(carry):
            W_l, H_l, losses, prev1, it, done = carry
            Num_p, Den_p, ll_p = hloss_local(W_l, H_l)
            Num = jax.lax.psum(Num_p, rows)
            Den = jax.lax.psum(Den_p, rows)
            loss_cur = objective_from_ll(ll_p, H_l)
            rec = jnp.logical_and(it >= 1, jnp.logical_not(done))
            losses = jnp.where(
                rec, losses.at[jnp.maximum(it - 1, 0)].set(loss_cur), losses
            )
            rel_change = jnp.abs(prev1 - loss_cur) / jnp.abs(prev1)
            newly_done = jnp.logical_and(it >= 2, rel_change < tol)
            done_out = jnp.logical_or(done, newly_done)
            W_new, H_new = finish_sweep(W_l, H_l, Num, Den)
            W_out = jnp.where(done_out, W_l, W_new)
            H_out = jnp.where(done_out, H_l, H_new)
            prev_out = jnp.where(rec, loss_cur, prev1)
            it_out = jnp.where(done_out, it, it + 1)
            return (W_out, H_out, losses, prev_out, it_out, done_out)

        def one_restart(W_l0, H_l0):
            init = (
                W_l0,
                H_l0,
                losses0,
                jnp.array(jnp.inf, dtype=dtype),
                jnp.array(0, dtype=jnp.int32),
                jnp.array(False),
            )
            W_l, H_l, losses, prev1, n_iter, done = jax.lax.while_loop(
                cond, body, init
            )

            # Final-loss fill on max_iter exhaustion (single-chip core dito).
            _, _, ll_p = hloss_local(W_l, H_l)
            loss_fin = objective_from_ll(ll_p, H_l)
            need_final = jnp.logical_not(done)
            losses = jnp.where(
                need_final, losses.at[jnp.maximum(n_iter - 1, 0)].set(loss_fin), losses
            )
            final_loss = jnp.where(need_final, loss_fin, prev1)
            rel_fin = jnp.abs(prev1 - loss_fin) / jnp.abs(prev1)
            done = jnp.logical_or(
                done,
                jnp.logical_and(
                    need_final, jnp.logical_and(n_iter >= 2, rel_fin < tol)
                ),
            )
            return W_l, H_l, losses, n_iter, final_loss, done

        return jax.vmap(one_restart)(W_b0, H_b0)

    mapped = jax.shard_map(
        local_loop,
        mesh=mesh,
        in_specs=(
            P(rows, cols),  # Ym
            P(rows, cols),  # Ym2
            P(rows, cols),  # Yc
            P(None, None, rows),  # W (restart axis leading)
            P(None, None, cols),  # H
            P(None, cols),  # Vn
            P(), P(), P(), P(),  # scalars
        ),
        out_specs=(
            P(None, None, rows),  # W
            P(None, None, cols),  # H
            P(),  # losses (b, max_iter)
            P(),  # n_iter (b,)
            P(),  # final_loss (b,)
            P(),  # done (b,)
        ),
        check_vma=False,
    )
    mapped = jax.jit(mapped)
    W, H, losses, n_iter, final_loss, done = mapped(
        Ymp, Ym2p, Ycp, W0p, H0p, Vn, alpha, beta, tol, n_obs
    )
    return W[:, :, :m], H[:, :, :n], losses, n_iter, final_loss, done
