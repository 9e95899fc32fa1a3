"""Reference-internal module shim: some reference tests import
``from nbmf_mm._utils import generate_synthetic_binary_data`` / fitted checks
(reference ``src/nbmf_mm/_utils.py``)."""

from nbmf_mm_jax.utils.synth import generate_synthetic_binary_data
from nbmf_mm_jax.utils.validation import check_is_fitted

__all__ = ["generate_synthetic_binary_data", "check_is_fitted"]
