"""Scikit-learn-style estimator for NBMF-MM, backed by the compiled solver.

Preserves the full behavioral contract of the reference estimator
(``siddC/nbmf_mm`` ``src/nbmf_mm/_base.py``): constructor signature and
attribute names (``W_``, ``components_``, ``loss_curve_``,
``objective_history_``, ``loss_``, ``n_iter_``, ``reconstruction_err_``),
orientation aliases and canonicalization, input validation ("X must be
binary"), sparse densification, masked training, ``transform`` fold-in,
``score``/``perplexity`` semantics (including the refit-via-transform
behavior, ``_base.py:235``).

Documented deviations (SURVEY.md §7 decision list):

- ``transform`` (and therefore ``score``/``perplexity``) is *seeded* from
  ``random_state`` — the reference draws from the global NumPy RNG
  (``_base.py:175``), which no test pins;
- new constructor capabilities: ``n_init`` (vmapped restarts), ``projection``
  (``"normalize"``/``"duchi"``), ``mask_mode`` (``"parity"``/``"corrected"``),
  ``dtype``, ``precision``, ``mesh`` (GSPMD sharding);
- legacy README-only flags (``use_numexpr``, ``use_numba``,
  ``projection_backend``) are accepted and ignored for drop-in compatibility.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.updates import fold_in_w_update
from ..solver.driver import _resolve_dtype, _resolve_precision, solve
from ..utils.validation import (
    check_array,
    check_is_fitted,
    densify,
    warn_large_sparse_densify,
)

__all__ = ["NBMFMM", "NBMF"]

try:  # sklearn is optional; the estimator works standalone.
    from sklearn.base import BaseEstimator, TransformerMixin

    _BASES = (BaseEstimator, TransformerMixin)
except Exception:  # pragma: no cover
    _BASES = (object,)


_ORIENTATION_ALIASES = {
    # Canonical forms and case/synonym aliases (reference _base.py:127-137).
    "beta-dir": "beta-dir",
    "dir-beta": "dir-beta",
    "Beta-Dir": "beta-dir",
    "Dir-Beta": "dir-beta",
    "Dir Beta": "dir-beta",
    "binary ICA": "beta-dir",
    "Binary ICA": "beta-dir",
    "bICA": "beta-dir",
    "Aspect Bernoulli": "dir-beta",
}


@partial(jax.jit, static_argnames=("n_iter", "precision"))
def _transform_core(H, Ym, Ym2, W0t, eps, *, n_iter: int, precision):
    """Fold-in: find W for new data with ``H`` fixed (reference
    ``_base.py:178-193``), as a jitted ``fori_loop`` of the beta-dir W update."""
    n_features = H.shape[1]

    def body(_, Wt):
        return fold_in_w_update(
            Wt, H, Ym, Ym2, n_features=n_features, eps=eps, precision=precision
        )

    Wt = jax.lax.fori_loop(0, n_iter, body, W0t)
    W = Wt.T
    # Final box clip + row renormalization (reference _base.py:196-198).
    W = jnp.clip(W, 1e-8, 1.0)
    return W / W.sum(axis=1, keepdims=True)


class NBMFMM(*_BASES):
    """Non-negative Binary Matrix Factorization via Majorization-Minimization.

    JAX implementation of the NBMF-MM algorithm from P. Magron and
    C. Fevotte, "A majorization-minimization algorithm for nonnegative binary
    matrix factorization," IEEE Signal Processing Letters, 2022.

    Parameters
    ----------
    n_components : int, default=10
        Latent dimension ``k``.
    alpha, beta : float, default=1.2
        Beta-prior parameters for the continuous factor.
    max_iter : int, default=2000
        Maximum number of MM sweeps.
    tol : float, default=1e-5
        Relative-loss-change convergence tolerance.
    W_init, H_init : array-like, optional
        Warm-start factors (shapes ``(n_samples, k)`` / ``(k, n_features)``).
    init : ignored
        Present for API compatibility with the reference (unused there too).
    random_state : int or None
        Seed for factor initialization (and for ``transform``'s fold-in).
    verbose : int, default=0
        Print loss every 10 sweeps when > 0.
    orientation : str, default="beta-dir"
        ``"beta-dir"``: W rows on the simplex, H ~ Beta (paper default);
        ``"dir-beta"``: H columns on the simplex, W ~ Beta.  Aliases such as
        ``"Binary ICA"`` / ``"Aspect Bernoulli"`` are canonicalized.
    n_init : int, default=1
        Number of random restarts, batched on-device via ``vmap``; the fit
        with the lowest final objective is kept.
    projection : {"normalize", "duchi"}, default="normalize"
        Simplex step: paper-exact multiplicative renormalization, or Duchi
        sort-based Euclidean projection.
    mask_mode : {"parity", "corrected"}, default="parity"
        Masked-training semantics: exact reference behavior vs. fully
        consistent observed-entries-only masking.
    dtype : optional
        Compute dtype (default: float64 when JAX x64 is enabled, else f32).
    precision : optional
        Matmul precision ("default"/"high"/"highest" or lax.Precision).
        ``None`` = path-appropriate defaults: HIGHEST on the XLA/jnp path,
        DEFAULT on the fused GPU path (TF32 tensor-core products, about 10
        mantissa bits).  Pass ``"highest"`` explicitly for IEEE f32
        products.
    mesh : jax.sharding.Mesh, optional
        Shard the factorization over a device mesh with GSPMD.
    mesh_axes : (str, str), default ("rows", "cols")
        The mesh axis names the samples/features dimensions shard over;
        must name axes of ``mesh``.
    backend : {"auto", "jnp", "pallas"}, default="auto"
        Compute backend for ``fit``: ``"auto"`` picks the fused Pallas
        kernels on the GPU for <= f32 dtypes and XLA otherwise.
    packed : bool, optional
        Bitpack exactly-binary operands for the fused kernels (32 entries /
        int32 word — ~32x less data stream and data memory, bit-identical
        results).  ``None`` (default) auto-enables when the
        data and mask are exactly 0/1; ``False`` disables; ``True``
        requires eligibility (raises otherwise).
    solver_options : dict, optional
        Extra keyword arguments forwarded verbatim to
        :func:`~nbmf_mm_jax.solver.driver.solve` by ``fit`` (e.g.
        ``block_m``/``block_n`` block sizes, ``pallas_interpret``,
        ``device_results``).  Entries override the constructor-derived
        arguments on key collision; ``pallas_interpret`` also applies to
        the fused ``transform``.
    use_numexpr, use_numba, projection_backend : ignored
        Legacy reference-README flags, accepted for drop-in compatibility.
    """

    def __init__(
        self,
        n_components=10,
        alpha=1.2,
        beta=1.2,
        max_iter=2000,
        tol=1e-5,
        W_init=None,
        H_init=None,
        init=None,
        random_state=None,
        verbose=0,
        orientation="beta-dir",
        n_init=1,
        projection="normalize",
        mask_mode="parity",
        dtype=None,
        precision=None,
        mesh=None,
        mesh_axes=("rows", "cols"),
        backend="auto",
        packed=None,
        solver_options=None,
        use_numexpr=None,
        use_numba=None,
        projection_backend=None,
    ):
        self.n_components = n_components
        self.alpha = alpha
        self.beta = beta
        self.max_iter = max_iter
        self.tol = tol
        self.W_init = W_init
        self.H_init = H_init
        self.init = init  # unused; kept for reference compatibility
        self.random_state = random_state
        self.verbose = verbose
        self.orientation = orientation
        self.n_init = n_init
        self.projection = projection
        self.mask_mode = mask_mode
        self.dtype = dtype
        self.precision = precision
        self.mesh = mesh
        self.mesh_axes = mesh_axes
        self.backend = backend
        self.packed = packed
        self.solver_options = solver_options
        self.use_numexpr = use_numexpr
        self.use_numba = use_numba
        self.projection_backend = projection_backend

    # ------------------------------------------------------------------ fit
    def fit(self, X, y=None, mask=None):
        """Fit the NBMF model to binary (or [0,1]-valued) data ``X``.

        ``X`` may also be a :class:`~nbmf_mm_jax.ops.packed.PackedMatrix`
        (binary by construction; ``solve`` enforces the packed contract) or
        a ``scipy.sparse`` matrix — sparse input is passed through to
        ``solve`` un-densified, where packed-eligible routings bitpack it
        straight from the sparse structure and every other routing
        densifies it, with results identical to dense input either way.
        """
        from ..ops.packed import PackedMatrix

        if isinstance(X, PackedMatrix):
            pass  # bit-plane words are exactly binary; nothing to validate
        else:
            X = check_array(X, accept_sparse="csr", dtype=np.float64)
            values = X.data if hasattr(X, "toarray") else X
            if not np.all((values >= 0) & (values <= 1)):
                raise ValueError("X must be binary")

        # Canonicalize and *store* the normalized orientation — tests rely on
        # the mutation (reference _base.py:94-95).
        orientation = self._normalize_orientation(self.orientation)
        self.orientation = orientation

        solve_kwargs = dict(
            n_components=self.n_components,
            max_iter=self.max_iter,
            tol=self.tol,
            alpha=self.alpha,
            beta=self.beta,
            W_init=self.W_init,
            H_init=self.H_init,
            mask=mask,
            random_state=self.random_state,
            verbose=self.verbose,
            orientation=orientation,
            n_init=self.n_init,
            projection=self.projection,
            mask_mode=self.mask_mode,
            dtype=self.dtype,
            precision=self.precision,
            mesh=self.mesh,
            # getattr: estimators pickled before these attributes existed
            # have none of them in __dict__ (unpickling skips __init__).
            mesh_axes=tuple(getattr(self, "mesh_axes", ("rows", "cols"))),
            backend=getattr(self, "backend", "auto"),
            packed=getattr(self, "packed", None),
        )
        solve_kwargs.update(getattr(self, "solver_options", None) or {})
        result = solve(X, **solve_kwargs)

        self.W_ = result.W
        self.components_ = result.H
        self.loss_curve_ = result.losses
        self.objective_history_ = result.losses  # backward-compat alias
        self.loss_ = result.losses[-1] if result.losses else np.inf
        self.n_iter_ = result.n_iter
        self.reconstruction_err_ = result.losses[-1] if result.losses else np.inf
        self.converged_ = result.converged
        self.fit_time_ = result.time_elapsed
        self.solver_result_ = result
        return self

    def _normalize_orientation(self, orientation):
        """Map orientation aliases to canonical form (reference
        ``_base.py:124-143``); raise ``ValueError`` on unknown values."""
        try:
            return _ORIENTATION_ALIASES[orientation]
        except (KeyError, TypeError):
            raise ValueError(
                f"Unknown orientation: {orientation}. "
                f"Must be one of {list(_ORIENTATION_ALIASES.keys())}"
            ) from None

    def fit_transform(self, X, y=None):
        """Fit to ``X`` and return ``W_`` (exactly ``fit(X).W_``; the mask
        argument is intentionally absent, reference ``_base.py:145-160``)."""
        self.fit(X)
        return self.W_

    # Entry-count gate for routing transform/score fold-ins through the
    # fused Pallas kernels under backend="auto": below this the XLA path's
    # (m, n) ratio temporaries are cheap and not worth an extra compile.
    _FUSED_TRANSFORM_MIN_ENTRIES = 1 << 22  # ~4.2M entries

    def _use_fused_transform(self, n_entries: int, dtype) -> bool:
        """Route ``transform`` through the fused fold-in kernels
        (:func:`nbmf_mm_jax.models.serving.fold_in_fused`)?  ``"pallas"``
        always does; ``"auto"`` does on the GPU for large inputs;
        ``"jnp"``, a mesh, or f64 never."""
        backend = getattr(self, "backend", "auto")
        if self.mesh is not None or backend == "jnp":
            return False
        if jnp.dtype(dtype) == jnp.dtype(jnp.float64):
            return False
        if backend == "pallas":
            return True
        from ..solver.driver import _resolve_backend

        return (
            _resolve_backend(backend, dtype, self.precision)
            and n_entries >= self._FUSED_TRANSFORM_MIN_ENTRIES
        )

    # ------------------------------------------------------------ transform
    def transform(self, X, mask=None):
        """Fold in new data: find W for ``X`` with fitted ``components_`` held
        fixed, via 50 beta-dir multiplicative updates (reference
        ``_base.py:162-199``; run seeded and jitted here).

        Large batches on the GPU (and any batch under
        ``backend="pallas"``) run through the fused fold-in kernels — the
        same seeded ``W0`` draw, so results match the XLA path to f32
        kernel tolerance while the per-iteration ``(m, n)`` ratio terms
        stay on chip (``score``/``perplexity`` inherit this through their
        ``transform`` refit).  The kernels run interpreted only when
        ``solver_options={"pallas_interpret": True}`` asks for it.

        Sparse ``X`` is densified whole (the seeded ``W0`` draw spans the
        full batch, so chunking here would change results) — with a
        ``UserWarning`` above ~1 GB of dense materialization; for sparse
        request batches at scale use
        :class:`~nbmf_mm_jax.models.serving.FoldInServer`, which accepts
        ``scipy.sparse`` and stages one bucket-chunk at a time."""
        check_is_fitted(self, ["components_"])
        X = check_array(X, accept_sparse="csr", dtype=np.float64)
        warn_large_sparse_densify(X, "transform")
        X = densify(X)
        if mask is not None:
            warn_large_sparse_densify(mask, "transform (mask)")
            mask = densify(mask)

        dtype = _resolve_dtype(self.dtype)
        precision = _resolve_precision(self.precision)

        if self._use_fused_transform(X.size, dtype):
            from .serving import fold_in_fused

            m, k = X.shape[0], self.n_components
            seed = 0 if self.random_state is None else int(self.random_state)
            key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x7F01)
            # The SAME seeded draw as the XLA path below — the two routes
            # agree to f32 kernel tolerance.
            W0t = jax.random.uniform(
                key, (k, m), dtype=dtype, minval=0.1, maxval=0.9
            )
            W, _ = fold_in_fused(
                self.components_,
                X,
                mask,
                W0t,
                n_iter=50,
                dtype=dtype,
                interpret=bool(
                    (getattr(self, "solver_options", None) or {}).get(
                        "pallas_interpret", False
                    )
                ),
                packed=getattr(self, "packed", None),
                kernel_precision=(
                    None if self.precision is None
                    else _resolve_precision(self.precision)
                ),
            )
            return W
        X = jnp.asarray(X, dtype=dtype)
        H = jnp.asarray(self.components_, dtype=dtype)
        m, k = X.shape[0], self.n_components

        if mask is None:
            Ym, Ym2 = X, 1.0 - X
        else:
            mask = jnp.asarray(mask, dtype=dtype)
            Ym, Ym2 = X * mask, (1.0 - X) * mask

        seed = 0 if self.random_state is None else int(self.random_state)
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x7F01)
        W0t = jax.random.uniform(key, (k, m), dtype=dtype, minval=0.1, maxval=0.9)

        if self.mesh is not None:
            # GSPMD fold-in: batch rows over the first mesh axis, features
            # over the second; XLA inserts the feature-axis psums of the
            # fold-in contraction automatically.
            from jax.sharding import NamedSharding, PartitionSpec as P

            # getattr: see fit() — pre-mesh_axes pickles lack the attribute.
            rows_ax, cols_ax = getattr(self, "mesh_axes", ("rows", "cols"))
            xsh = NamedSharding(self.mesh, P(rows_ax, cols_ax))
            Ym = jax.device_put(Ym, xsh)
            Ym2 = jax.device_put(Ym2, xsh)
            H = jax.device_put(H, NamedSharding(self.mesh, P(None, cols_ax)))
            W0t = jax.device_put(W0t, NamedSharding(self.mesh, P(None, rows_ax)))

        W = _transform_core(
            H, Ym, Ym2, W0t, jnp.asarray(1e-8, dtype=dtype), n_iter=50, precision=precision
        )
        return np.asarray(W)

    def inverse_transform(self, W):
        """Reconstruct data-space probabilities ``clip(W @ H, 0, 1)``
        (reference ``_base.py:201-210``)."""
        check_is_fitted(self, ["components_"])
        W = check_array(W, dtype=np.float64)
        return np.clip(W @ self.components_, 0.0, 1.0)

    # ---------------------------------------------------------------- score
    def score(self, X, mask=None):
        """Mean Bernoulli log-likelihood per observed entry of ``X`` under a
        reconstruction refit via ``transform`` (reference ``_base.py:212-247``,
        including the refit-from-scratch semantics and parity masking)."""
        check_is_fitted(self, ["components_"])
        X = check_array(X, accept_sparse="csr", dtype=np.float64)
        warn_large_sparse_densify(X, "score")
        X = densify(X)
        X_recon = self.inverse_transform(self.transform(X))
        eps = 1e-8
        if mask is None:
            log_lik = X * np.log(X_recon + eps) + (1 - X) * np.log(1 - X_recon + eps)
            n_obs = X.size
        else:
            warn_large_sparse_densify(mask, "score (mask)")
            mask = densify(mask)
            X_masked = X * mask
            log_lik = X_masked * np.log(X_recon + eps) + (1 - X_masked) * np.log(
                1 - X_recon + eps
            )
            n_obs = np.count_nonzero(mask)
        return float(np.sum(log_lik) / n_obs)

    def perplexity(self, X, mask=None):
        """``exp(-score(X, mask))`` (reference ``_base.py:249-265``)."""
        return float(np.exp(-self.score(X, mask)))


# Alias for backwards compatibility (reference _base.py:269).
NBMF = NBMFMM
