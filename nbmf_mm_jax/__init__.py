"""nbmf-mm-jax: mean-parameterized Bernoulli (binary) matrix factorization
via Majorization-Minimization in JAX.

A ground-up JAX/XLA/Pallas re-architecture of the capabilities of the
reference library ``siddC/nbmf_mm`` (P. Magron and C. Fevotte, "A
majorization-minimization algorithm for nonnegative binary matrix
factorization," IEEE Signal Processing Letters, 2022):

- the MM solver is a single compiled ``lax.while_loop`` running entirely
  on-device (:mod:`nbmf_mm_jax.solver`);
- the hot sweep math lives in :mod:`nbmf_mm_jax.ops`: an XLA path and fused
  Pallas kernels for the GPU (Triton route);
- ``n_init`` restarts are ``vmap``-batched and large factorizations shard
  across device meshes (:mod:`nbmf_mm_jax.parallel`);
- the public scikit-learn-style API matches the reference exactly
  (:mod:`nbmf_mm_jax.models`): ``NBMF``/``NBMFMM`` with
  ``fit/transform/fit_transform/inverse_transform/score/perplexity``, both
  orientations, masked completion, seeded reproducibility.

Public import surface mirrors the reference (``src/nbmf_mm/__init__.py:17``):
``NBMFMM``, ``NBMF``, ``nbmf_mm_solver`` — plus the richer :func:`solve`.
"""

try:
    # Written by setuptools_scm at build time (version_file in
    # pyproject.toml); the committed copy is a dev fallback.
    from ._version import __version__
except ImportError:  # pragma: no cover
    __version__ = "0.0.0.dev0"
from .models.estimator import NBMF, NBMFMM
from .ops.packed import (
    PackedMatrix,
    pack_matrix,
    pack_matrix_chunked,
    pack_matrix_sparse,
)
from .solver.driver import SolverResult, nbmf_mm_solver, solve

__all__ = [
    "NBMFMM",
    "NBMF",
    "nbmf_mm_solver",
    "solve",
    "SolverResult",
    "PackedMatrix",
    "pack_matrix",
    "pack_matrix_chunked",
    "pack_matrix_sparse",
    "__version__",
]
