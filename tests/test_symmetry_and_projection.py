"""Orientation transpose symmetry (reference tests/test_symmetry.py:5-27) and
Duchi simplex projection properties (implemented for real here; the reference
removed its duchi path — SURVEY.md §4 historical note)."""

import numpy as np
import pytest

from nbmf_mm_jax import NBMF
from nbmf_mm_jax.ops.projection import project_columns_simplex_duchi, project_simplex_duchi


def _toy(m=40, n=30, p=0.3, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < p).astype(float)


def test_orientation_transpose_symmetry():
    """dir-beta on X reconstructs like (beta-dir on X.T).T"""
    X = _toy()
    m1 = NBMF(n_components=4, orientation="dir-beta", max_iter=200, tol=1e-8, random_state=0).fit(X)
    m2 = NBMF(n_components=4, orientation="beta-dir", max_iter=200, tol=1e-8, random_state=0).fit(X.T)
    R1 = m1.W_ @ m1.components_
    R2 = (m2.W_ @ m2.components_).T
    np.testing.assert_allclose(R1, R2, atol=5e-3, rtol=5e-3)


def test_duchi_projection_simplex_properties():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(8, 100)) * 3.0
    P = np.asarray(project_columns_simplex_duchi(X))
    np.testing.assert_allclose(P.sum(axis=0), 1.0, atol=1e-9)
    assert np.all(P >= 0)


def test_duchi_projection_identity_on_simplex():
    rng = np.random.default_rng(1)
    X = rng.random((5, 50))
    X = X / X.sum(axis=0, keepdims=True)
    P = np.asarray(project_columns_simplex_duchi(X))
    np.testing.assert_allclose(P, X, atol=1e-9)


def test_duchi_projection_matches_bruteforce():
    """Compare against a direct epsilon-free reference implementation."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(6, 20))

    def proj_one(v):
        u = np.sort(v)[::-1]
        css = np.cumsum(u)
        rho = np.nonzero(u * np.arange(1, len(v) + 1) > (css - 1))[0][-1]
        tau = (css[rho] - 1) / (rho + 1.0)
        return np.maximum(v - tau, 0)

    expected = np.stack([proj_one(X[:, j]) for j in range(X.shape[1])], axis=1)
    got = np.asarray(project_columns_simplex_duchi(X))
    np.testing.assert_allclose(got, expected, atol=1e-10)


def test_project_simplex_axis_variant():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(10, 6))
    P = np.asarray(project_simplex_duchi(X, axis=1))
    np.testing.assert_allclose(P.sum(axis=1), 1.0, atol=1e-9)


@pytest.mark.parametrize("orientation", ["beta-dir", "dir-beta"])
def test_duchi_solver_keeps_simplex_and_finite(orientation):
    X = _toy()
    m = NBMF(
        n_components=4,
        orientation=orientation,
        projection="duchi",
        max_iter=60,
        random_state=0,
    ).fit(X)
    assert np.all(np.isfinite(m.loss_curve_))
    if orientation == "beta-dir":
        np.testing.assert_allclose(m.W_.sum(axis=1), 1.0, atol=1e-6)
        assert np.all(m.W_ >= 0)
    else:
        np.testing.assert_allclose(m.components_.sum(axis=0), 1.0, atol=1e-6)
        assert np.all(m.components_ >= 0)


def test_invalid_projection_rejected():
    with pytest.raises(ValueError, match="projection"):
        NBMF(n_components=3, projection="euclid").fit(_toy(10, 8))


def test_dir_beta_custom_init_swap_parity():
    """dir-beta with explicit inits equals beta-dir on X.T with swapped
    inits (reference _solver.py:113-123 swap semantics), exactly."""
    from nbmf_mm_jax import nbmf_mm_solver

    rng = np.random.default_rng(0)
    X = (rng.random((20, 30)) < 0.3).astype(float)
    W0 = rng.uniform(0.1, 0.9, (20, 4))
    H0 = rng.uniform(0.1, 0.9, (4, 30))
    Wd, Hd, ld, _, _ = nbmf_mm_solver(
        X, 4, max_iter=15, tol=0.0, orientation="dir-beta", W_init=W0, H_init=H0
    )
    Wb, Hb, lb, _, _ = nbmf_mm_solver(
        X.T, 4, max_iter=15, tol=0.0, orientation="beta-dir", W_init=H0.T, H_init=W0.T
    )
    np.testing.assert_allclose(Wd, Hb.T)
    np.testing.assert_allclose(Hd, Wb.T)
    np.testing.assert_allclose(ld, lb)


def test_dir_beta_single_init_clear_error():
    """Only one init in dir-beta: the reference silently mis-assigns it
    (square data) or fails with a confusing broadcast error; we reject the
    lone factor up front with a clear message."""
    from nbmf_mm_jax import nbmf_mm_solver

    X = (np.random.default_rng(1).random((20, 30)) < 0.3).astype(float)
    W0 = np.full((20, 4), 0.5)
    with pytest.raises(ValueError, match="requires BOTH"):
        nbmf_mm_solver(X, 4, max_iter=5, orientation="dir-beta", W_init=W0)
