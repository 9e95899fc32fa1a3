"""Direct numerical parity against the reference implementation.

With identical explicit initializations (bypassing both libraries' RNGs) the
MM trajectory is fully deterministic, so our f64 results must match the
reference's NumPy results to accumulation-order rounding.  These tests import
the reference package from its read-only mount and auto-skip when absent.
"""

import os
import sys

import numpy as np
import pytest

_REF_SRC = os.environ.get("NBMF_REFERENCE_SRC", "/root/reference/src")

ref = None
if os.path.isdir(_REF_SRC):
    sys.path.insert(0, _REF_SRC)
    try:
        import nbmf_mm as ref  # the reference package
    except Exception:  # pragma: no cover
        ref = None

pytestmark = pytest.mark.skipif(ref is None, reason="reference package unavailable")


def _setup(m=40, n=30, k=4, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.random((m, n)) < 0.3).astype(float)
    W0 = rng.uniform(0.1, 0.9, (m, k))
    H0 = rng.uniform(0.1, 0.9, (k, n))
    return X, W0, H0


@pytest.mark.parametrize("alpha,beta", [(1.2, 1.2), (2.0, 0.5)])
def test_trajectory_parity_unmasked(alpha, beta):
    from nbmf_mm_jax import nbmf_mm_solver

    X, W0, H0 = _setup()
    rW, rH, rlosses, _, rn = ref.nbmf_mm_solver(
        X, 4, max_iter=25, tol=0.0, alpha=alpha, beta=beta,
        W_init=W0.copy(), H_init=H0.copy(),
    )
    oW, oH, olosses, _, on = nbmf_mm_solver(
        X, 4, max_iter=25, tol=0.0, alpha=alpha, beta=beta,
        W_init=W0, H_init=H0,
    )
    assert on == rn
    np.testing.assert_allclose(olosses, rlosses, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(oW, rW, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(oH, rH, rtol=1e-8, atol=1e-10)


def test_trajectory_parity_masked():
    from nbmf_mm_jax import nbmf_mm_solver

    X, W0, H0 = _setup(seed=3)
    mask = (np.random.default_rng(5).random(X.shape) < 0.85).astype(float)
    rW, rH, rlosses, _, _ = ref.nbmf_mm_solver(
        X, 4, max_iter=25, tol=0.0, mask=mask, W_init=W0.copy(), H_init=H0.copy()
    )
    oW, oH, olosses, _, _ = nbmf_mm_solver(
        X, 4, max_iter=25, tol=0.0, mask=mask, W_init=W0, H_init=H0
    )
    np.testing.assert_allclose(olosses, rlosses, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(oW, rW, rtol=1e-8, atol=1e-10)


def test_trajectory_parity_dir_beta():
    from nbmf_mm_jax import nbmf_mm_solver

    X, W0, H0 = _setup(seed=7)
    rW, rH, rlosses, _, _ = ref.nbmf_mm_solver(
        X, 4, max_iter=25, tol=0.0, orientation="dir-beta",
        W_init=W0.copy(), H_init=H0.copy(),
    )
    oW, oH, olosses, _, _ = nbmf_mm_solver(
        X, 4, max_iter=25, tol=0.0, orientation="dir-beta", W_init=W0, H_init=H0
    )
    np.testing.assert_allclose(olosses, rlosses, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(oW, rW, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(oH, rH, rtol=1e-8, atol=1e-10)


def test_convergence_decision_parity():
    """Same tol => same stopping iteration and final loss."""
    from nbmf_mm_jax import nbmf_mm_solver

    X, W0, H0 = _setup(seed=11)
    _, _, rlosses, _, rn = ref.nbmf_mm_solver(
        X, 4, max_iter=500, tol=1e-6, W_init=W0.copy(), H_init=H0.copy()
    )
    _, _, olosses, _, on = nbmf_mm_solver(
        X, 4, max_iter=500, tol=1e-6, W_init=W0, H_init=H0
    )
    assert on == rn
    assert len(olosses) == len(rlosses)
    np.testing.assert_allclose(olosses[-1], rlosses[-1], rtol=1e-10)
