"""First-class bitpacked data input: build and hold a binary matrix as int32
bit-plane words without ever materializing it dense.

The fused kernels (:mod:`nbmf_mm_jax.ops.pallas_sweep`) read 32 matrix
entries per int32 word, which cuts the data stream *and the data's device
footprint* by 32x and moves the largest solvable problem from "what fits
dense" to "what fits packed".  ``solve()`` packs dense binary inputs by
itself, but the dense staging (host array -> device f32 -> pad -> pack) is
then the memory ceiling: a 4x10^5 x 10^4 matrix is 16 GB dense f32 and only
0.5 GB packed.  This module removes that ceiling:

- :class:`PackedMatrix` — the packed words plus the real (unpadded) shape;
- :func:`pack_matrix` — pack a dense matrix (host or device) into one;
- :func:`pack_matrix_chunked` — build one from row chunks produced on
  demand (a generator/callback), so no dense copy of the full matrix ever
  exists anywhere; chunks are packed as they arrive;
- :func:`pack_matrix_sparse` — the same from a ``scipy.sparse`` matrix.

Word layout: word row ``w``, bit ``b`` <-> data row ``32w + b``.  It does not
depend on any kernel block size, so zero word rows and columns are exactly
zero data rows and columns, and ``solve`` pads the words to its blocks.
``solve(PackedMatrix, ...)`` runs the fused kernels on the words directly
(single-device path; see the ``solve`` docstring for the contract).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import pallas_sweep as ps

__all__ = [
    "PackedMatrix",
    "csr_binary_canonical",
    "pack_matrix",
    "pack_matrix_chunked",
    "pack_matrix_sparse",
    "pack_sparse_words",
]

# Rows densified at a time by the chunked packers: ~2^26 entries' worth.
_CHUNK_ENTRIES = 1 << 26


def _chunk_rows(n: int, chunk_rows: Optional[int]) -> int:
    rows = chunk_rows or _CHUNK_ENTRIES // max(n, 1)
    return max(ps.WORD_BITS, rows // ps.WORD_BITS * ps.WORD_BITS)


def csr_binary_canonical(S):
    """CSR view of a scipy.sparse matrix with canonical (duplicate-summed)
    data, or ``None`` if its dense-equivalent stored values are not exactly
    0/1.  Never mutates the input: duplicate entries SUM in the dense view
    (two stored 1.0s at one position are dense 2.0), so non-canonical
    inputs canonicalize on a COPY before the binaryness check — non-binary
    sums are rejected, not silently packed as one bit.
    """
    Sr = S.tocsr()  # normalizes .data layout across formats (lil/dia/bsr/...)
    if not Sr.has_canonical_format:
        Sr = Sr.copy()
        Sr.sum_duplicates()
    if Sr.data.size and not bool(((Sr.data == 0) | (Sr.data == 1)).all()):
        return None
    return Sr


@dataclass(frozen=True)
class PackedMatrix:
    """A binary matrix stored as bit-plane words.

    ``words`` is ``(ceil(m / 32), n)`` int32 (bit ``b`` of word row ``w``
    holds entry ``(32w + b, j)``; rows beyond ``m`` are zero) and ``shape``
    the real ``(m, n)``.
    """

    words: jnp.ndarray
    shape: Tuple[int, int]

    def __post_init__(self):
        m, n = self.shape
        want = (-(-m // ps.WORD_BITS), n)
        if tuple(self.words.shape) != want:
            raise ValueError(
                f"PackedMatrix words of shape {tuple(self.words.shape)} do "
                f"not encode a {self.shape} matrix (expected {want})"
            )

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.words.shape)) * 4

    def unpack(self) -> jnp.ndarray:
        """Dense 0/1 float32 ``(m, n)`` (for tests/small inspections)."""
        return ps.unpack_bits(self.words)[: self.shape[0]]


def pack_matrix(Y) -> PackedMatrix:
    """Pack a dense exactly-binary ``(m, n)`` matrix (numpy or jax array).

    Host arrays are packed on the host (the data then crosses to the device
    at 1/32 of the bytes); device arrays are packed on the device.
    """
    if isinstance(Y, np.ndarray):
        if not bool(((Y == 0) | (Y == 1)).all()):
            raise ValueError("pack_matrix requires exactly binary data")
        words = jnp.asarray(ps.pack_bits_host(Y))
    else:
        if not bool(jnp.all((Y == 0) | (Y == 1))):
            raise ValueError("pack_matrix requires exactly binary data")
        words = jax.jit(ps.pack_bits)(Y)
    return PackedMatrix(words=words, shape=tuple(Y.shape))


def pack_matrix_chunked(
    row_chunk: Callable[[int, int], "np.ndarray | jnp.ndarray"],
    m: int,
    n: int,
    *,
    chunk_rows: Optional[int] = None,
    validate: bool = True,
) -> PackedMatrix:
    """Build a :class:`PackedMatrix` from on-demand row chunks.

    ``row_chunk(start, stop)`` must return the dense rows ``[start, stop)``
    of the matrix (``stop - start`` rows by ``n`` columns; numpy or device
    array, any 0/1 dtype).  Chunks start at multiples of 32 rows, so their
    words concatenate into exactly ``pack_bits`` of the whole matrix and
    only one chunk is ever dense.

    ``chunk_rows`` defaults to ~2^26 entries' worth of rows, rounded down to
    a multiple of 32.  Set ``validate=False`` to skip the per-chunk
    binaryness scan (e.g. chunks straight from ``jax.random.bernoulli``).
    """
    step = _chunk_rows(n, chunk_rows)
    pack_dev = jax.jit(ps.pack_bits)
    parts = []
    for start in range(0, m, step):
        stop = min(start + step, m)
        C = row_chunk(start, stop)
        if C.shape != (stop - start, n):
            raise ValueError(
                f"row_chunk({start}, {stop}) returned shape {C.shape}, "
                f"expected {(stop - start, n)}"
            )
        host = isinstance(C, np.ndarray)
        if validate:
            ok = ((C == 0) | (C == 1)).all() if host else jnp.all((C == 0) | (C == 1))
            if not bool(ok):
                raise ValueError(f"rows [{start}, {stop}) are not exactly binary")
        parts.append(jnp.asarray(ps.pack_bits_host(C)) if host else pack_dev(C))
    words = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    return PackedMatrix(words=words, shape=(m, n))


def pack_sparse_words(
    S,
    Mp: int,
    Np: int,
    *,
    complement: bool = False,
    chunk_rows: Optional[int] = None,
) -> np.ndarray:
    """Chunked sparse -> words host packer: bit-identical to
    ``pack_bits_host`` of the ``(Mp, Np)`` zero-padded dense equivalent,
    built one transient row chunk at a time.

    ``complement=True`` packs ``1 - S`` over the real region (pads stay
    zero) — the parity-mode/unmasked complement operand, which is dense as
    a sparse matrix but free as bits.
    """
    m, n = S.shape
    if Mp % ps.WORD_BITS:
        raise ValueError(f"pack_sparse_words: Mp={Mp} is not a multiple of 32")
    step = _chunk_rows(Np, chunk_rows)
    parts = []
    for start in range(0, Mp, step):
        stop = min(start + step, Mp)
        real = min(stop, m)
        C = np.zeros((stop - start, Np), dtype=np.uint8)
        if real > start:
            D = np.asarray(S[start:real].toarray(), dtype=np.uint8)
            C[: real - start, :n] = (1 - D) if complement else D
        parts.append(ps.pack_bits_host(C))
    return np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]


def pack_matrix_sparse(Y, *, chunk_rows: Optional[int] = None) -> PackedMatrix:
    """Pack a scipy.sparse binary matrix without a full dense staging.

    The common at-scale source of binary data is a sparse matrix (user-item
    interactions — e.g. the paper's lastfm matrix is 3% dense); its dense
    f32 form is what blows the memory ceiling that bitpacking removes.
    This builder densifies only ``chunk_rows``-row slices (uint8, transient)
    on the way into the host packer, so peak extra memory is one chunk +
    the words (1/32 the dense f32 matrix), and the data crosses to the
    device packed.

    Stored values must be exactly 0 or 1 (explicit zeros are fine);
    anything else raises — the ``solve(packed=...)`` binaryness contract.
    """
    import scipy.sparse as sp

    if not sp.issparse(Y):
        raise TypeError(f"pack_matrix_sparse expects a scipy.sparse matrix, got {type(Y)}")
    Yr = csr_binary_canonical(Y)
    if Yr is None:
        raise ValueError(
            "pack_matrix_sparse requires exactly binary stored values"
        )
    m, n = Yr.shape

    def row_chunk(a, b):
        return np.asarray(Yr[a:b].toarray(), dtype=np.uint8)

    return pack_matrix_chunked(
        row_chunk, m, n, chunk_rows=chunk_rows,
        validate=False,  # stored values were validated above, exactly once
    )
