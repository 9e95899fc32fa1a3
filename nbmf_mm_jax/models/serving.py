"""Serving: high-throughput fold-in of new rows against a trained model.

The estimator's ``transform`` (reference ``_base.py:162-199`` semantics)
recompiles for every new batch shape and round-trips through the host.  For
production serving — scoring streams of new users/rows against a fixed
``components_`` — this module provides :class:`FoldInServer`:

- **shape bucketing**: incoming batches are padded up to a small set of
  power-of-two row counts, so any request shape hits one of a handful of
  precompiled programs (pad rows are synthesized as all-zero observations
  with a zero mask and sliced away — they do not affect real rows, whose
  fold-in is row-independent given fixed H);
- the fold-in itself is the reference's 50-iteration multiplicative W
  update, jitted once per bucket, entirely on-device;
- outputs: the simplex weights ``W`` and optionally the Bernoulli
  reconstruction / per-row log-likelihood scores.

The per-row independence given a fixed H is what makes this correct:
each padded row's updates never mix with other rows' (all contractions in
the fold-in run over the feature axis).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.updates import fold_in_w_update
from ..solver.driver import _resolve_backend, _resolve_dtype, _resolve_precision
from ..utils.validation import check_is_fitted, densify

__all__ = ["FoldInServer", "fold_in_fused"]


@partial(
    jax.jit,
    static_argnames=(
        "n_iter", "n_real", "eps", "block_m", "block_n", "interpret",
        "packed", "kernel_precision",
    ),
)
def _fold_in_batch_pallas(
    Hp, A, B, W0t, *, n_iter: int, n_real: int, eps: float,
    block_m: int, block_n: int, interpret: bool,
    packed: bool = False, kernel_precision=None,
):
    """Fused-kernel fold-in on padded operands.

    The fold-in contraction is exactly the solver's W pass
    (:func:`nbmf_mm_jax.ops.pallas_sweep.w_terms`): per iteration it streams
    the (b, n) data once and keeps the ratio terms on chip, instead of
    materializing two (b, n) ratio temporaries in device memory as the XLA
    path does.

    ``packed=False``: ``A`` is the padded data ``Xp (Bp, Np)`` and ``B``
    the padded mask.  ``packed=True``: ``A``/``B`` are host-packed int32
    words for ``Ym = X*mask`` / ``Ym2 = (1-X)*mask`` (:func:`pack_bits_host`
    — the chunk crosses to the device at 1/32 of the bytes), and all
    ``n_iter`` iterations read the words — bit-identical results; the
    single scoring pass unpacks them once in-program.

    Operand contract: ``Hp (k, Np)``; data/mask zero-padded (pad rows/cols
    all-zero in *both*, so their ratio terms vanish and pad columns of
    ``W`` stay exactly zero through the multiplicative updates);
    ``W0t (k, Bp)`` with zero pad columns.
    """
    from ..ops import pallas_sweep as ps

    if packed:
        Ymp, Ym2p = A, B
        # Dense 0/1 copies ONLY for the single scoring pass after the loop
        # (the iterations never touch them).
        Ym = ps.unpack_bits(Ymp, dtype=W0t.dtype)
        Ym2 = ps.unpack_bits(Ym2p, dtype=W0t.dtype)
    else:
        Ym = Ymp = A * B
        Ym2 = Ym2p = (1.0 - A) * B

    def contraction(Wt):
        return ps.w_terms(
            Wt, Hp, Ymp, Ym2p, n_real=n_real, eps=eps, block_m=block_m,
            block_n=block_n, packed=packed, interpret=interpret,
            precision=kernel_precision,
        )

    n_features = jnp.asarray(n_real, W0t.dtype)

    def body(_, Wt):
        Wt = Wt * contraction(Wt) / n_features
        col = Wt.sum(axis=0, keepdims=True)
        return Wt / jnp.where(col > 0, col, 1.0)

    Wt = jax.lax.fori_loop(0, n_iter, body, W0t)
    W = jnp.clip(Wt.T, 1e-8, 1.0)
    W = W / W.sum(axis=1, keepdims=True)
    # Per-row mean observed log-likelihood (one (Bp, Np) pass, outside the
    # iteration loop; XLA fuses the elementwise chain into the matmul).
    R = jnp.matmul(W, Hp, precision=jax.lax.Precision.DEFAULT)
    ll = Ym * jnp.log(R + 1e-8) + Ym2 * jnp.log(jnp.maximum(1.0 - R, 0.0) + 1e-8)
    n_obs = jnp.maximum((Ym + Ym2).sum(axis=1), 1.0)
    return W, ll.sum(axis=1) / n_obs


def _stage_fold_in(X, mask, rows, Bp, Np, dtype, packed):
    """Pad a request chunk to ``(Bp, Np)`` on the host and choose its data
    form: int32 words for ``X*mask`` / ``(1-X)*mask`` when the chunk is
    exactly binary (``packed`` follows ``solve()``: ``None`` packs when
    eligible, ``True`` requires it, ``False`` never), else the dense padded
    data and mask.  Returns ``(A, B, use_packed)``."""
    from ..ops import pallas_sweep as ps

    host_dtype = np.dtype(dtype)
    n_features = X.shape[1]
    Xp = np.zeros((Bp, Np), dtype=host_dtype)
    Xp[:rows, :n_features] = np.asarray(X)
    mp = np.zeros((Bp, Np), dtype=host_dtype)
    mp[:rows, :n_features] = 1.0 if mask is None else np.asarray(mask)
    use_packed = False
    if packed is not False:
        # The binaryness scan runs for packed=True as well: packing collapses
        # every entry to one bit, and silently binarizing non-binary data
        # would produce wrong fold-in results.
        use_packed = bool(((Xp == 0) | (Xp == 1)).all() and ((mp == 0) | (mp == 1)).all())
        if packed is True and not use_packed:
            raise ValueError("packed=True requires exactly binary data (and mask)")
    if use_packed:
        # Boolean planes (data and mask are exactly 0/1 here) skip
        # materializing the f32 Ym/Ym2 products.
        observed = mp != 0
        A = jnp.asarray(ps.pack_bits_host((Xp != 0) & observed))
        B = jnp.asarray(ps.pack_bits_host((Xp == 0) & observed))
        return A, B, True
    return jnp.asarray(Xp), jnp.asarray(mp), False


@partial(jax.jit, static_argnames=("n_iter", "precision", "masked"))
def _fold_in_batch(H, Xp, mask_or_rows, W0t, eps, *, n_iter: int, precision, masked: bool):
    """Fold-in on a padded batch.

    ``masked=False``: ``mask_or_rows`` is the valid-row count (i32 scalar)
    and the row-validity mask is synthesized in-program — nothing beyond the
    data itself crosses the host-device link.  ``masked=True``: it is the
    (padded) observation mask array.
    """
    n_features = H.shape[1]
    if masked:
        mp = mask_or_rows
    else:
        b = Xp.shape[0]
        mp = (
            jax.lax.broadcasted_iota(jnp.int32, (b, 1), 0) < mask_or_rows
        ).astype(Xp.dtype)
    Ym = Xp * mp
    Ym2 = (1.0 - Xp) * mp

    def body(_, Wt):
        return fold_in_w_update(
            Wt, H, Ym, Ym2, n_features=n_features, eps=eps, precision=precision
        )

    Wt = jax.lax.fori_loop(0, n_iter, body, W0t)
    W = jnp.clip(Wt.T, 1e-8, 1.0)
    W = W / W.sum(axis=1, keepdims=True)
    # Per-row mean observed log-likelihood of the reconstruction.
    R = jnp.matmul(W, H, precision=precision)
    ll = Ym * jnp.log(R + 1e-8) + Ym2 * jnp.log(jnp.maximum(1.0 - R, 0.0) + 1e-8)
    n_obs = jnp.maximum((Ym + Ym2).sum(axis=1), 1.0)
    return W, ll.sum(axis=1) / n_obs


def fold_in_fused(
    H,
    X,
    mask=None,
    W0t=None,
    *,
    n_iter: int = 50,
    dtype=None,
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    interpret: bool = False,
    packed: Optional[bool] = None,
    random_state: int = 0,
    eps: float = 1e-8,
    kernel_precision=None,
):
    """One-shot fused fold-in of ``X`` against a fixed ``H (k, n_features)``.

    The kernel dispatch of :class:`FoldInServer` (words for exactly-binary
    data, dense otherwise) without the bucketing/caching machinery — used
    by ``NBMFMM.transform``'s size-gated fast path, where the caller
    supplies the *seeding-contract* initial factor ``W0t (k, rows)``
    (internal layout; pad columns are appended here and stay exactly zero
    through the multiplicative updates).  When ``W0t`` is omitted it is
    drawn U(0.1, 0.9) from ``random_state``.

    Returns ``(W (rows, k), per_row_loglik (rows,))`` as numpy arrays.
    ``packed`` follows the ``solve()`` contract: ``None`` auto-packs
    binary data, ``True`` requires eligibility and raises otherwise,
    ``False`` disables.
    """
    from ..ops import pallas_sweep as ps

    dtype = _resolve_dtype(dtype)
    X = densify(X)
    if mask is not None:
        mask = densify(mask)
    rows, n_features = X.shape
    if isinstance(H, jax.Array):  # device H stays in place (no host pull)
        H = H.astype(dtype)
    else:
        H = jnp.asarray(np.asarray(H), dtype=dtype)
    k = H.shape[0]

    Bp, Np = ps.padded_dims(rows, n_features, block_m, block_n)
    Hp = jnp.pad(H, ((0, 0), (0, Np - n_features)))
    if W0t is None:
        key = jax.random.fold_in(jax.random.PRNGKey(int(random_state)), Bp)
        W0t_full = jax.random.uniform(
            key, (k, Bp), dtype=dtype, minval=0.1, maxval=0.9
        )
    else:
        W0t_full = jnp.zeros((k, Bp), dtype=dtype)
        W0t_full = W0t_full.at[:, :rows].set(jnp.asarray(W0t, dtype=dtype))
    # Zero pad columns: their data/mask rows are zero => multiplicative
    # updates keep them exactly zero (guarded renorm).
    col = jax.lax.broadcasted_iota(jnp.int32, (1, Bp), 1)
    W0t_full = jnp.where(col < rows, W0t_full, 0.0)
    A, B, use_packed = _stage_fold_in(X, mask, rows, Bp, Np, dtype, packed)
    W, scores = _fold_in_batch_pallas(
        Hp,
        A,
        B,
        W0t_full,
        n_iter=n_iter,
        n_real=n_features,
        eps=eps,
        block_m=block_m,
        block_n=block_n,
        interpret=interpret,
        packed=use_packed,
        kernel_precision=kernel_precision,
    )
    return np.asarray(W)[:rows], np.asarray(scores)[:rows]


class FoldInServer:
    """Precompiled, shape-bucketed fold-in against a fitted model.

    Parameters
    ----------
    model_or_H : fitted ``NBMF`` estimator, a ``SolverResult`` (from
        ``solve``; with ``device_results=True`` the handoff keeps ``H``
        on-device end-to-end), or an ``(k, n_features)`` array (a device
        ``jax.Array`` is used in place, never pulled to the host)
    n_iter : fold-in iterations (reference uses a fixed 50)
    buckets : ascending row-count buckets; requests pad to the next bucket
        (and chunk by the largest). Default: 64..8192 powers of two.
    backend : {"auto", "jnp", "pallas"} — "auto" serves through the fused
        ``w_terms`` kernel on the GPU (<= f32): the per-iteration ``(b, n)``
        ratio terms stay on chip instead of round-tripping device memory.
    mesh, mesh_axes : shard serving over a device mesh with GSPMD (batch
        rows over the first axis, features over the second; XLA inserts
        the feature-axis psums of the contraction).  Mesh serving uses the
        XLA path.
    packed : None (default) bitpacks each exactly-binary chunk once and
        streams int32 bit-plane words through all ``n_iter`` fold-in
        iterations (1/32 the per-iteration data traffic, bit-identical
        results; the chunk's staging buffers are scanned once to verify
        binaryness).  ``True`` requires every chunk to be exactly binary
        and raises otherwise (same contract as ``solve(packed=True)``);
        ``False`` disables.  Pallas path only.
    """

    def __init__(
        self,
        model_or_H,
        *,
        n_iter: int = 50,
        buckets: Tuple[int, ...] = (64, 256, 1024, 4096, 8192),
        random_state: Optional[int] = 0,
        dtype=None,
        precision=None,
        backend: str = "auto",
        block_m: Optional[int] = None,
        block_n: Optional[int] = None,
        pallas_interpret: bool = False,
        mesh=None,
        mesh_axes: Tuple[str, str] = ("rows", "cols"),
        packed: Optional[bool] = None,
    ):
        if hasattr(model_or_H, "n_components"):  # an estimator
            check_is_fitted(model_or_H, ["components_"])
            H = model_or_H.components_
        elif hasattr(model_or_H, "H") and hasattr(model_or_H, "losses"):
            # a SolverResult — with solve(device_results=True) this wires
            # fit -> serve entirely on-device (H never visits the host)
            H = model_or_H.H
        else:
            H = model_or_H
        self.dtype = _resolve_dtype(dtype)
        self.precision = _resolve_precision(precision)
        # Two-tier default as in solve(): the fused kernels run DEFAULT
        # (TF32 products on the GPU) unless precision is given explicitly.
        self.kernel_precision = (
            None if precision is None else _resolve_precision(precision)
        )
        # Device-resident H stays on device (no host round-trip — the
        # fit -> serve handoff from solve(device_results=True)); host
        # inputs upload once here.
        if isinstance(H, jax.Array):
            self.H = H.astype(self.dtype)
        else:
            self.H = jnp.asarray(np.asarray(H), dtype=self.dtype)
        self.k, self.n_features = self.H.shape
        self.n_iter = int(n_iter)
        self.buckets = tuple(sorted(buckets))
        self.random_state = 0 if random_state is None else int(random_state)
        # "auto" routes batches through the fused w_terms kernel on the
        # GPU; a mesh shards the batch over 'rows' and the feature axis over
        # 'cols' with GSPMD (XLA inserts the feature-axis psums of the
        # fold-in contraction automatically).
        self.backend = backend
        self.block_m = block_m
        self.block_n = block_n
        self.pallas_interpret = pallas_interpret
        self.mesh = mesh
        self.mesh_axes = mesh_axes
        self.packed = packed
        self._use_pallas = mesh is None and _resolve_backend(
            backend, self.dtype, precision
        )
        if packed is True and not self._use_pallas:
            # Same contract as solve(): an explicit packed demand must not
            # silently ship dense bytes from a routing that can't pack.
            raise ValueError(
                "packed=True requires the Pallas serving path (no mesh, and "
                "backend resolving to Pallas with dtype <= float32)"
            )
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            rows, cols = mesh_axes
            self._h_sharding = NamedSharding(mesh, P(None, cols))
            self._x_sharding = NamedSharding(mesh, P(rows, cols))
            self._w_sharding = NamedSharding(mesh, P(None, rows))
            self.H = jax.device_put(self.H, self._h_sharding)

    def _bucket(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return self.buckets[-1]

    def _serve_chunk(self, X, mask):
        if self._use_pallas:
            return self._serve_chunk_pallas(X, mask)
        rows = X.shape[0]
        b = self._bucket(rows)
        # Pad on the HOST (device-side padding would compile one eager op per
        # novel request shape) and transfer only the data; row validity is synthesized in-program.
        # Host staging buffers use self.dtype so f64 serving (continuous
        # values / weighted masks) is not silently truncated through f32.
        host_dtype = np.dtype(self.dtype)
        Xp = np.zeros((b, self.n_features), dtype=host_dtype)
        Xp[:rows] = np.asarray(X)
        Xp = jnp.asarray(Xp, dtype=self.dtype)
        if self.mesh is not None:
            Xp = jax.device_put(Xp, self._x_sharding)
        if mask is None:
            mask_or_rows = jnp.asarray(rows, dtype=jnp.int32)
        else:
            mp = np.zeros((b, self.n_features), dtype=host_dtype)
            mp[:rows] = np.asarray(mask)
            mask_or_rows = jnp.asarray(mp, dtype=self.dtype)
            if self.mesh is not None:
                mask_or_rows = jax.device_put(mask_or_rows, self._x_sharding)
        key = jax.random.fold_in(jax.random.PRNGKey(self.random_state), b)
        W0t = jax.random.uniform(
            key, (self.k, b), dtype=self.dtype, minval=0.1, maxval=0.9
        )
        if self.mesh is not None:
            W0t = jax.device_put(W0t, self._w_sharding)
        W, scores = _fold_in_batch(
            self.H, Xp, mask_or_rows, W0t, jnp.asarray(1e-8, dtype=self.dtype),
            n_iter=self.n_iter, precision=self.precision, masked=mask is not None,
        )
        return np.asarray(W)[:rows], np.asarray(scores)[:rows]

    def _serve_chunk_pallas(self, X, mask):
        """Fused-kernel chunk path: pad batch/features to kernel blocks on
        the host, run the fold-in loop through :func:`_fold_in_batch_pallas`
        (words for exactly-binary chunks, dense otherwise; one compile per
        bucket and variant)."""
        from ..ops import pallas_sweep as ps

        rows = X.shape[0]
        Bp, Np = ps.padded_dims(
            self._bucket(rows), self.n_features, self.block_m, self.block_n
        )
        if not hasattr(self, "_Hp") or self._Hp.shape[1] != Np:
            self._Hp = jnp.pad(self.H, ((0, 0), (0, Np - self.n_features)))
        key = jax.random.fold_in(jax.random.PRNGKey(self.random_state), Bp)
        W0t = jax.random.uniform(
            key, (self.k, Bp), dtype=self.dtype, minval=0.1, maxval=0.9
        )
        # zero pad columns: their data/mask rows are zero => multiplicative
        # updates keep them exactly zero (guarded renorm).
        col = jax.lax.broadcasted_iota(jnp.int32, (1, Bp), 1)
        W0t = jnp.where(col < rows, W0t, 0.0)
        A, B, use_packed = _stage_fold_in(
            X, mask, rows, Bp, Np, self.dtype, self.packed
        )
        W, scores = _fold_in_batch_pallas(
            self._Hp,
            A,
            B,
            W0t,
            n_iter=self.n_iter,
            n_real=self.n_features,
            eps=1e-8,
            block_m=self.block_m,
            block_n=self.block_n,
            interpret=self.pallas_interpret,
            packed=use_packed,
            kernel_precision=self.kernel_precision,
        )
        return np.asarray(W)[:rows], np.asarray(scores)[:rows]

    def transform(self, X, mask=None):
        """Fold in new rows; returns ``(W, per_row_loglik)`` as numpy arrays.

        Requests larger than the top bucket are chunked.  ``X``/``mask``
        may be ``scipy.sparse`` (the common shape of at-scale serving
        batches): rows densify one chunk at a time, so peak host memory is
        one bucket's dense staging — and exactly-binary sparse chunks then
        cross the host-device link bitpacked like any other chunk.
        """
        sparse_in = hasattr(X, "toarray") and not isinstance(X, np.ndarray)
        X = X.tocsr() if sparse_in else densify(X)
        if mask is not None:
            mask_sparse = hasattr(mask, "toarray") and not isinstance(
                mask, np.ndarray
            )
            mask = mask.tocsr() if mask_sparse else densify(mask)
        else:
            mask_sparse = False
        if X.shape[0] == 0:  # empty batch: well-defined empty result
            return (np.zeros((0, self.k)), np.zeros((0,)))
        top = self.buckets[-1]
        Ws, Ss = [], []
        for start in range(0, X.shape[0], top):
            sl = slice(start, start + top)
            Xc = X[sl].toarray() if sparse_in else X[sl]
            if mask is None:
                mc = None
            else:
                mc = mask[sl].toarray() if mask_sparse else mask[sl]
            W, s = self._serve_chunk(Xc, mc)
            Ws.append(np.asarray(W))
            Ss.append(np.asarray(s))
        return np.concatenate(Ws, axis=0), np.concatenate(Ss, axis=0)

    def warmup(self):
        """Precompile every bucket — every kernel VARIANT a request can
        dispatch to, not just one: with ``packed=None`` a binary request
        hits the packed variant and a continuous-mask request the dense
        one, and a cold compile mid-serving is exactly what this class
        exists to prevent."""
        for b in self.buckets:
            zeros = np.zeros((b, self.n_features))
            self._serve_chunk(zeros, None)
            if self._use_pallas:
                if self.packed is None:
                    # A non-binary mask forces the dense fallback variant.
                    self._serve_chunk(zeros, np.full_like(zeros, 0.5))
            else:
                # The XLA path compiles masked/unmasked separately.
                self._serve_chunk(zeros, np.ones_like(zeros))
        return self
