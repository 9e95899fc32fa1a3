"""Fused Pallas kernels for the NBMF-MM sweep, written for NVIDIA Hopper
through the Triton route (``pl.pallas_call(..., backend="triton")``).

The XLA path (:mod:`nbmf_mm_jax.ops.updates`) materialises several (m, n)
temporaries per sweep in device memory (``W.T@H`` three times, the ratio
matrices, the log-likelihood matrix), and XLA does not fuse a
GEMM -> elementwise -> GEMM chain across the contraction.  These kernels fuse
each of the two structural contractions of a sweep into one pass that reads
the data matrix once and keeps every (block_m, block_n) temporary on chip:

- :func:`hloss_terms` -- ``Num = W @ (Ym / (W.T@H + eps))``, ``Den = W @
  (Yc / (1 - W.T@H + eps))`` (both (k, n)) AND the Bernoulli log-likelihood
  of the current ``(W, H)``, all from one ``W.T@H`` (the solver's
  shifted-loss schedule fuses the loss into the H pass);
- :func:`w_terms` -- ``T = H @ (Ym / (W.T@H + eps)).T
  + (1-H) @ (Ym2 / (1 - W.T@H + eps)).T`` ((k, m)), the W-update (and
  fold-in) contraction.

Kernel shape.  Each kernel is written for one thread block.  The H pass runs
its grid over column blocks of ``n``; each block loops over the row blocks of
``m`` -- ``S = W_m.T @ H_j``, ratios formed in registers, ``Num_j += W_m @ P``,
``Den_j += W_m @ Q`` and a per-column log-likelihood partial.  The W pass
mirrors it: grid over row blocks of ``m``, loop over ``n``.  Thread blocks
run in no order, so nothing carries between them: when the outer axis has
too few blocks to fill the card, the loop axis is split over a second grid
dimension and the partial sums are added by one small XLA reduction (no
atomics, so results are the same run to run).

Data operands are dense (f32 or bf16) or bitpacked int32 words
(:func:`pack_bits`: word row ``w``, bit ``b`` <-> data row ``32w + b``, so
the words do not depend on any block size).  One loader turns either into a
0/1 (or valued) tile in the accumulation dtype, and the same arithmetic
follows, so the packed kernels are bit-identical to the dense ones.

The ratios go through a shared reciprocal (one divide instead of two:
``p = ym * (b * r)`` with ``r = 1/(a*b)``), so they are not bit-identical to
the XLA path's ``ym / a``; cross-path differences are last-ulp.

Precision: every kernel takes ``precision=`` (threaded into each
``dot_general``).  ``None`` leaves the products at DEFAULT, which on the GPU
means TF32 tensor-core products (about 10 mantissa bits); ``"highest"`` /
``lax.Precision.HIGHEST`` asks for IEEE f32 products.

Layout / padding contract (:func:`padded_dims`):

- factors in the internal layout ``W (k, Mp)``, ``H (k, Np)``; the kernels
  pad ``k`` to a power of two >= 16 (tensor-core operands) with zero rows;
- ``Mp``/``Np`` are multiples of the power-of-two block sizes; data
  matrices are zero-padded, W's pad *columns* are zero (their contributions
  then vanish in every contraction), and the caller zeroes H's pad columns
  after each elementwise update (:func:`apply_col_validity`);
- the in-register complement ``1 - Ym`` is masked to the real columns in the
  W pass, and the log-likelihood to the real ``(m, n)`` region, so
  real-region results do not depend on the padding.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = [
    "hloss_terms",
    "w_terms",
    "pack_bits",
    "pack_bits_host",
    "unpack_bits",
    "padded_dims",
    "block_size",
    "apply_col_validity",
    "round_up",
]

# Per-pass defaults (block_m, block_n, num_warps, num_stages): the fastest of
# sweeps over power-of-two configurations on H100 80GB HBM3 cards (400 W and
# 700 W power limits) at 10^4 x 10^4, K=128, TF32, dense and packed alike.
# The H pass holds two (k, block_n) accumulators, so it wants a narrow
# block_n; the W pass holds one (k, block_m).
HLOSS_BLOCKS = (64, 32, 4, 2)
W_BLOCKS = (128, 64, 8, 3)
WORD_BITS = 32  # data rows per packed int32 word; also the smallest block
_MIN_K = 16  # tensor-core dot operands need every dimension >= 16
# Two thread blocks for each of the H100's 132 SMs: below this many outer
# blocks, the loop axis is split over a second grid dimension.
_TARGET_PROGRAMS = 264


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def block_size(dim: int, block: int) -> int:
    """Power-of-two block for an axis of length ``dim``: ``block`` (rounded
    up to a power of two) shrunk for short axes, never below 32."""
    return max(WORD_BITS, min(_next_pow2(block), _next_pow2(dim)))


def padded_dims(m: int, n: int, block_m: Optional[int] = None,
                block_n: Optional[int] = None) -> Tuple[int, int]:
    """``(Mp, Np)``: an ``(m, n)`` problem padded to a multiple of every
    block either pass uses (``block_m``/``block_n`` override both passes'
    defaults).  ``Mp`` is a multiple of 32, so packed words cover the padded
    rows exactly."""
    bm = max(block_size(m, block_m or c[0]) for c in (HLOSS_BLOCKS, W_BLOCKS))
    bn = max(block_size(n, block_n or c[1]) for c in (HLOSS_BLOCKS, W_BLOCKS))
    return round_up(m, bm), round_up(n, bn)


def _acc_dtype(dtype):
    """Accumulation dtype: f32 for half types, else the factor dtype (f64
    only occurs in interpret-mode tests on the CPU)."""
    d = jnp.dtype(dtype)
    return jnp.float32 if d in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16)) else d


def _operand_dtype(data_dtype, factor_dtype):
    """Dot operand dtype.  bf16 data (lossless for binary values, half the
    bytes) runs the products in bf16 with f32 accumulation; ratios are still
    formed in f32."""
    if jnp.dtype(data_dtype) == jnp.dtype(jnp.bfloat16):
        return jnp.bfloat16
    return jnp.dtype(factor_dtype)


def _split(outer: int, inner: int) -> Tuple[int, int]:
    """``(n_splits, blocks_per_split)`` for a loop of ``inner`` blocks under
    ``outer`` grid blocks: enough splits to reach ``_TARGET_PROGRAMS``
    programs, none left empty."""
    split = max(1, min(-(-_TARGET_PROGRAMS // outer), inner))
    per = -(-inner // split)
    return -(-inner // per), per


def _pad_k(A):
    """Zero-pad the leading (k) axis of a factor to a power of two >= 16."""
    k = A.shape[0]
    kp = max(_MIN_K, _next_pow2(k))
    return A if kp == k else jnp.pad(A, ((0, kp - k), (0, 0)))


def _unpack_tile(words):
    """``(r, c)`` int32 words -> ``(32 r, c)`` int32 0/1, row ``32w + b``
    taken from bit ``b`` of word row ``w``."""
    r, c = words.shape
    shifts = jax.lax.broadcasted_iota(jnp.int32, (r, WORD_BITS, c), 1)
    bits = jnp.right_shift(words[:, None, :], shifts) & 1
    return bits.reshape(r * WORD_BITS, c)


def _tile(ref, rows, cols, packed: bool, dtype):
    """Load a data tile; ``rows`` is a ``pl.ds`` in data rows for dense refs
    and in word rows for packed ones."""
    t = ref[rows, cols]
    if packed:
        t = _unpack_tile(t)
    return t.astype(dtype)


def _ratios(wh, ym, eps):
    """Shared-reciprocal ratio terms: ``b*r == 1/(wh+eps)`` and
    ``a*r == 1/(1-wh+eps)``; ``p = ym/(wh+eps)``."""
    a = wh + eps
    b = jnp.maximum(1.0 - wh, 0.0) + eps  # exact when wh <= 1; guards f32 wh > 1
    r = 1.0 / (a * b)
    return a, b, r, ym * (b * r)


def _config(Mp, Np, block_m, block_n, precision, defaults):
    """Blocks and compiler parameters for one pass: explicit blocks, else
    the pass's tuned defaults; blocks shrink for short axes and must divide
    the padded sizes.  IEEE f32 products (HIGHEST) hold larger operand
    tiles in shared memory — three W-pass stages then ask for 256 KB of the
    227 KB a block may use — so they pipeline two stages deep."""
    bm = block_size(Mp, block_m or defaults[0])
    bn = block_size(Np, block_n or defaults[1])
    if Mp % bm or Np % bn:
        raise ValueError(f"({Mp}, {Np}) is not a multiple of the blocks ({bm}, {bn})")
    ieee = jax.lax.Precision.HIGHEST in (
        precision if isinstance(precision, tuple) else (precision,)
    )
    stages = min(defaults[3], 2) if ieee else defaults[3]
    return bm, bn, plgpu.CompilerParams(num_warps=defaults[2], num_stages=stages)


# ------------------------------------------------------- fused H+loss pass
def _hloss_kernel(*refs, bm, per, n_loop, m_real, n_real, eps, packed,
                  explicit_yc, opd, acc, precision):
    if explicit_yc:
        w_ref, h_ref, ym_ref, yc_ref, num_ref, den_ref, ll_ref = refs
    else:
        w_ref, h_ref, ym_ref, num_ref, den_ref, ll_ref = refs
        yc_ref = None
    j, s = pl.program_id(0), pl.program_id(1)
    h = h_ref[...].astype(opd)  # (kp, bn)
    kp, bn = h.shape
    col_ok = (j * bn + jax.lax.broadcasted_iota(jnp.int32, (1, bn), 1)) < n_real
    rstep = bm // WORD_BITS if packed else bm
    dot = functools.partial(
        jax.lax.dot_general, preferred_element_type=acc, precision=precision
    )

    def body(i, carry):
        num, den, ll = carry
        w = w_ref[:, pl.ds(pl.multiple_of(i * bm, bm), bm)].astype(opd)
        rows = pl.ds(pl.multiple_of(i * rstep, rstep), rstep)
        ym = _tile(ym_ref, rows, slice(None), packed, acc)
        wh = dot(w, h, (((0,), (0,)), ((), ())))  # (bm, bn)
        a, b, r, p = _ratios(wh, ym, eps)
        yc = _tile(yc_ref, rows, slice(None), packed, acc) if explicit_yc else 1.0 - ym
        q = yc * (a * r)
        num = num + dot(w, p.astype(opd), (((1,), (0,)), ((), ())))
        den = den + dot(w, q.astype(opd), (((1,), (0,)), ((), ())))
        row_ok = (i * bm + jax.lax.broadcasted_iota(jnp.int32, (bm, 1), 0)) < m_real
        lt = ym * jnp.log(a) + yc * jnp.log(b)
        ll = ll + jnp.sum(jnp.where(row_ok & col_ok, lt, 0.0), axis=0)
        return num, den, ll

    lo = s * per
    init = (
        jnp.zeros((kp, bn), acc),
        jnp.zeros((kp, bn), acc),
        jnp.zeros((bn,), acc),
    )
    num, den, ll = jax.lax.fori_loop(lo, jnp.minimum(lo + per, n_loop), body, init)
    num_ref[...] = num.astype(num_ref.dtype)
    den_ref[...] = den.astype(den_ref.dtype)
    ll_ref[...] = ll


def hloss_terms(
    W: jnp.ndarray,
    H: jnp.ndarray,
    Ym: jnp.ndarray,
    Yc: Optional[jnp.ndarray] = None,
    *,
    m_real: int,
    n_real: int,
    eps: float = 1e-8,
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    packed: bool = False,
    interpret: bool = False,
    precision=None,
):
    """One fused pass computing the H-update contractions and the Bernoulli
    log-likelihood of the *current* ``(W, H)``.

    ``W (k, Mp)``, ``H (k, Np)``; ``Ym`` (and ``Yc``) are ``(Mp, Np)`` dense
    or, with ``packed=True``, ``(Mp // 32, Np)`` words.  ``Yc=None`` selects
    the parity/unmasked complement ``1 - Ym`` formed in registers; an
    explicit ``Yc`` serves ``mask_mode="corrected"``.  Returns ``(Num, Den,
    ll_sum)`` with ``ll_sum`` a scalar over the real ``(m_real, n_real)``
    region.
    """
    k, Mp = W.shape
    Np = H.shape[1]
    bm, bn, params = _config(Mp, Np, block_m, block_n, precision, HLOSS_BLOCKS)
    Wp, Hp = _pad_k(W), _pad_k(H)
    kp = Wp.shape[0]
    acc = _acc_dtype(W.dtype)
    opd = W.dtype if packed else _operand_dtype(Ym.dtype, W.dtype)
    n_blocks = Np // bn
    n_split, per = _split(n_blocks, Mp // bm)
    rows = Mp // WORD_BITS if packed else Mp
    explicit_yc = Yc is not None
    kernel = functools.partial(
        _hloss_kernel, bm=bm, per=per, n_loop=Mp // bm, m_real=m_real,
        n_real=n_real, eps=eps, packed=packed, explicit_yc=explicit_yc,
        opd=opd, acc=acc, precision=precision,
    )
    data_spec = pl.BlockSpec((rows, bn), lambda j, s: (0, j))
    in_specs = [
        pl.BlockSpec((kp, Mp), lambda j, s: (0, 0)),  # W, sliced in the loop
        pl.BlockSpec((kp, bn), lambda j, s: (0, j)),  # H column block
        data_spec,
    ] + ([data_spec] if explicit_yc else [])
    part_spec = pl.BlockSpec((None, kp, bn), lambda j, s: (s, 0, j))
    call = pl.pallas_call(
        kernel,
        grid=(n_blocks, n_split),
        in_specs=in_specs,
        out_specs=(part_spec, part_spec, pl.BlockSpec((None, bn), lambda j, s: (s, j))),
        out_shape=(
            jax.ShapeDtypeStruct((n_split, kp, Np), W.dtype),
            jax.ShapeDtypeStruct((n_split, kp, Np), W.dtype),
            jax.ShapeDtypeStruct((n_split, Np), acc),
        ),
        compiler_params=params,
        backend="triton",
        interpret=interpret,
        name="nbmf_hloss_pass",
    )
    Num, Den, ll = call(Wp, Hp, Ym, *((Yc,) if explicit_yc else ()))
    return Num.sum(axis=0)[:k], Den.sum(axis=0)[:k], ll.sum()


# ----------------------------------------------------------------- W pass
def _w_kernel(*refs, bn, per, n_loop, n_real, eps, packed, explicit_ym2,
              opd, acc, precision):
    if explicit_ym2:
        w_ref, h_ref, ym_ref, ym2_ref, t_ref = refs
    else:
        w_ref, h_ref, ym_ref, t_ref = refs
        ym2_ref = None
    s = pl.program_id(1)
    w = w_ref[...].astype(opd)  # (kp, bm)
    kp, bm = w.shape
    dot = functools.partial(
        jax.lax.dot_general, preferred_element_type=acc, precision=precision
    )

    def body(jn, t):
        cols = pl.ds(pl.multiple_of(jn * bn, bn), bn)
        h = h_ref[:, cols]  # (kp, bn)
        ym = _tile(ym_ref, slice(None), cols, packed, acc)
        wh = dot(w, h.astype(opd), (((0,), (0,)), ((), ())))  # (bm, bn)
        a, b, r, p = _ratios(wh, ym, eps)
        if explicit_ym2:
            ym2 = _tile(ym2_ref, slice(None), cols, packed, acc)
        else:
            col = jn * bn + jax.lax.broadcasted_iota(jnp.int32, (1, bn), 1)
            ym2 = jnp.where(col < n_real, 1.0 - ym, 0.0)
        q = ym2 * (a * r)
        # T += H @ P.T + (1-H) @ Q.T, contracting the n axis.  This MUST stay
        # in the two-product all-nonnegative form: the "one product + rank-1
        # reduction" identity H @ (P - Q).T + colsum(Q) is exact in real
        # arithmetic, but q reaches ~1/eps ~ 1e8 wherever wh -> 1 on a Y=0
        # entry, and with reduced-precision products (TF32 keeps ~10
        # mantissa bits) the cancellation leaves absolute errors far above
        # the true result -> T < 0 -> negative W -> NaN losses.  The
        # nonnegative form keeps every product and partial sum >= 0, so
        # T >= 0 at ANY product precision (tests/test_pallas.py
        # TestWTermsCancellation).
        t = t + dot(h.astype(opd), p.astype(opd), (((1,), (1,)), ((), ())))
        return t + dot((1.0 - h).astype(opd), q.astype(opd), (((1,), (1,)), ((), ())))

    lo = s * per
    t = jax.lax.fori_loop(
        lo, jnp.minimum(lo + per, n_loop), body, jnp.zeros((kp, bm), acc)
    )
    t_ref[...] = t.astype(t_ref.dtype)


def w_terms(
    W: jnp.ndarray,
    H_new: jnp.ndarray,
    Ym: jnp.ndarray,
    Ym2: Optional[jnp.ndarray] = None,
    *,
    n_real: int,
    eps: float = 1e-8,
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    packed: bool = False,
    interpret: bool = False,
    precision=None,
) -> jnp.ndarray:
    """Fused W-update contraction ``T (k, Mp)``.

    Operand contract as :func:`hloss_terms`.  ``Ym2=None`` means unmasked
    data: the complement ``1 - Ym`` is formed in registers and masked to the
    real columns so zero-padded columns beyond ``n_real`` contribute
    nothing; an explicit ``Ym2`` (``(1-Y)*mask``) serves both masked modes.
    """
    k, Mp = W.shape
    Np = H_new.shape[1]
    bm, bn, params = _config(Mp, Np, block_m, block_n, precision, W_BLOCKS)
    Wp, Hp = _pad_k(W), _pad_k(H_new)
    kp = Wp.shape[0]
    acc = _acc_dtype(W.dtype)
    opd = W.dtype if packed else _operand_dtype(Ym.dtype, W.dtype)
    m_blocks = Mp // bm
    n_split, per = _split(m_blocks, Np // bn)
    explicit_ym2 = Ym2 is not None
    kernel = functools.partial(
        _w_kernel, bn=bn, per=per, n_loop=Np // bn, n_real=n_real, eps=eps,
        packed=packed, explicit_ym2=explicit_ym2, opd=opd, acc=acc,
        precision=precision,
    )
    data_spec = pl.BlockSpec(
        ((bm // WORD_BITS) if packed else bm, Np), lambda i, s: (i, 0)
    )
    in_specs = [
        pl.BlockSpec((kp, bm), lambda i, s: (0, i)),  # W row block
        pl.BlockSpec((kp, Np), lambda i, s: (0, 0)),  # H, sliced in the loop
        data_spec,
    ] + ([data_spec] if explicit_ym2 else [])
    call = pl.pallas_call(
        kernel,
        grid=(m_blocks, n_split),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((None, kp, bm), lambda i, s: (s, 0, i)),
        out_shape=jax.ShapeDtypeStruct((n_split, kp, Mp), W.dtype),
        compiler_params=params,
        backend="triton",
        interpret=interpret,
        name="nbmf_w_pass",
    )
    T = call(Wp, Hp, Ym, *((Ym2,) if explicit_ym2 else ()))
    return T.sum(axis=0)[:k]


# ------------------------------------------------------------ bitpacking
#
# The model's data is BINARY (the estimator enforces the reference's
# "X must be binary" contract), so the (m, n) matrices the sweep streams can
# be packed 32 entries per int32 word: a 32x cut in both the data stream and
# the data's memory footprint.  Layout: word row w, bit b <-> data row
# 32w + b (bit set <=> entry nonzero).  It does not depend on any block size,
# so zero word rows / columns are exactly zero data rows / columns, and a
# shard of rows packs to the matching slice of the words.


def pack_bits(Y: jnp.ndarray) -> jnp.ndarray:
    """Pack a binary ``(M, N)`` matrix into ``(ceil(M/32), N)`` int32 words
    on the device (rows beyond ``M`` pack as zeros)."""
    M, N = Y.shape
    Mw = -(-M // WORD_BITS)
    bits = jnp.pad((Y != 0).astype(jnp.int32), ((0, Mw * WORD_BITS - M), (0, 0)))
    shifts = jnp.arange(WORD_BITS, dtype=jnp.int32)[None, :, None]
    return jnp.bitwise_or.reduce(bits.reshape(Mw, WORD_BITS, N) << shifts, axis=1)


def pack_bits_host(Y: np.ndarray) -> np.ndarray:
    """NumPy mirror of :func:`pack_bits` -- identical words, computed on the
    host so callers can ship 1/32 of the bytes to the device."""
    if not np.little_endian:  # pragma: no cover
        raise RuntimeError("pack_bits_host requires a little-endian host")
    M, N = Y.shape
    Mw = -(-M // WORD_BITS)
    bits = np.zeros((Mw * WORD_BITS, N), dtype=np.uint8)
    bits[:M] = np.asarray(Y) != 0
    # np.packbits over a contiguous trailing 32-bit axis runs at memcpy-class
    # speed.  With bitorder="little", byte j of each 4-byte group holds bits
    # 8j..8j+7, so the little-endian uint32 view has bit b == row 32w + b.
    bits = np.ascontiguousarray(bits.reshape(Mw, WORD_BITS, N).transpose(0, 2, 1))
    words = np.packbits(bits, axis=-1, bitorder="little")  # (Mw, N, 4) u8
    return words.view(np.uint32).view(np.int32).reshape(Mw, N)


def unpack_bits(P: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """Inverse of :func:`pack_bits`: ``(Mw, N)`` words -> dense ``(32 Mw, N)``
    0/1 matrix (plain XLA; for the occasional non-streaming pass)."""
    Mw, N = P.shape
    shifts = jnp.arange(WORD_BITS, dtype=jnp.int32)[None, :, None]
    bits = jnp.right_shift(P[:, None, :], shifts) & 1
    return bits.reshape(Mw * WORD_BITS, N).astype(dtype)


# ------------------------------------------------------------- padding glue
def pad_to(A, rows: int, cols: int):
    """Zero-pad a 2-D array (numpy or jax) to ``(rows, cols)``; ``None`` and
    already-sized arrays pass through untouched."""
    if A is None or A.shape == (rows, cols):
        return A
    xp = np if isinstance(A, np.ndarray) else jnp
    return xp.pad(A, ((0, rows - A.shape[0]), (0, cols - A.shape[1])))


def apply_col_validity(H: jnp.ndarray, n_real: int) -> jnp.ndarray:
    """Zero H's pad columns (beyond ``n_real``) after an elementwise update."""
    k, Np = H.shape
    if Np == n_real:
        return H
    col = jax.lax.broadcasted_iota(jnp.int32, (1, Np), 1)
    return jnp.where(col < n_real, H, 0.0)
