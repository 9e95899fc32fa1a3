"""Drop-in compatibility shim: ``import nbmf_mm_compat as nbmf_mm``.

Exposes exactly the reference library's public import surface
(``siddC/nbmf_mm`` ``src/nbmf_mm/__init__.py:17``: ``NBMFMM``, ``NBMF``,
``nbmf_mm_solver`` plus ``__version__``), re-exported from the JAX
implementation, so reference user code can switch with a one-line import
change (or an ``nbmf_mm = nbmf_mm_compat`` alias in ``conftest``/bootstrap).
"""

from nbmf_mm_jax import NBMF, NBMFMM, __version__, nbmf_mm_solver

__all__ = ["NBMFMM", "NBMF", "nbmf_mm_solver"]
