"""Input validation helpers (reference parity: ``src/nbmf_mm/_utils.py:3-9``
and the sklearn ``check_array`` usage in ``src/nbmf_mm/_base.py:83``).

sklearn is used when importable (it is an optional dependency, like in the
reference); otherwise a light fallback with equivalent semantics for our use
cases (dense/CSR float64 conversion, NaN/inf rejection, 2-D enforcement).
"""

from __future__ import annotations

import warnings

import numpy as np

__all__ = ["check_is_fitted", "check_array", "densify"]

# Entry count above which densifying a sparse input warrants a warning:
# 2**27 f64 entries is ~1 GB of dense materialization.  `fit` never hits
# this (packed routings ingest sparse structure directly and the dense
# routings' memory is the solve's own working set), but `transform`/`score`
# densify the WHOLE batch in one piece by contract (the seeded W0 draw
# spans the full batch), which can silently allocate many GB.
SPARSE_DENSIFY_WARN_ENTRIES = 1 << 27


def warn_large_sparse_densify(X, where: str) -> None:
    """Emit a ``UserWarning`` when a scipy.sparse input about to be densified
    whole would materialize more than ``SPARSE_DENSIFY_WARN_ENTRIES`` dense
    entries (~1 GB f64).  Chunking inside ``transform`` would change the
    seeded ``W0`` draw and therefore results, so the densification itself is
    by contract — but it should never be silent at scale."""
    if not hasattr(X, "toarray"):
        return
    m, n = X.shape
    n_entries = int(m) * int(n)
    if n_entries >= SPARSE_DENSIFY_WARN_ENTRIES:
        warnings.warn(
            f"{where} densifies sparse input whole: {m}x{n} = {n_entries:.3g} "
            f"entries (~{8 * n_entries / 1e9:.1f} GB as float64). This is by "
            "contract (the seeded fold-in W0 draw spans the full batch), but "
            "for large sparse request batches prefer "
            "nbmf_mm_jax.models.serving.FoldInServer, which accepts "
            "scipy.sparse and stages one bucket-chunk at a time.",
            UserWarning,
            stacklevel=3,
        )

try:  # pragma: no cover - exercised implicitly
    from sklearn.utils import check_array as _sk_check_array
except Exception:  # pragma: no cover
    _sk_check_array = None


def check_is_fitted(estimator, attributes):
    """Raise ``ValueError`` if ``estimator`` lacks fitted attributes
    (reference ``_utils.py:3-9``, including the exact message)."""
    if isinstance(attributes, str):
        attributes = [attributes]
    for attr in attributes:
        if not hasattr(estimator, attr):
            raise ValueError(
                f"This {type(estimator).__name__} instance is not fitted yet."
            )


def check_array(X, accept_sparse="csr", dtype=np.float64):
    """Validate an array-like: 2-D, finite, converted to ``dtype``.

    Sparse inputs are accepted (and later densified by the caller, matching
    reference ``_base.py:86-87``).
    """
    if _sk_check_array is not None:
        return _sk_check_array(X, accept_sparse=accept_sparse, dtype=dtype)
    if hasattr(X, "toarray"):
        return X  # sparse: caller densifies
    X = np.asarray(X, dtype=dtype)
    if X.ndim != 2:
        raise ValueError(f"Expected 2D array, got {X.ndim}D")
    if not np.all(np.isfinite(X)):
        raise ValueError("Input contains NaN or infinity")
    return X


def densify(X):
    """Convert scipy sparse matrices to dense ndarrays (reference pattern
    ``hasattr(X, 'toarray')``, ``_base.py:86-87`` / ``_solver.py:106-107``)."""
    return X.toarray() if hasattr(X, "toarray") else X
