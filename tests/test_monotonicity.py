"""Monotone MM descent of the MAP objective — the core algorithmic guarantee
(reference test_mm_equivalence.py:16-36 at 1e-12, test_api.py:39-55 at 1e-8,
test_monotonic_objective.py).  Run in float64 on CPU (conftest enables x64)."""

import numpy as np
import pytest

from nbmf_mm_jax import NBMF, nbmf_mm_solver


def _toy(m=60, n=80, p=0.25, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < p).astype(float)


@pytest.mark.parametrize("orientation", ["beta-dir", "dir-beta"])
def test_monotone_descent_tight(orientation):
    X = _toy()
    model = NBMF(
        n_components=5, orientation=orientation, max_iter=120, tol=1e-7, random_state=0
    ).fit(X)
    hist = np.asarray(model.objective_history_, dtype=float)
    diffs = np.diff(hist)
    assert np.all(diffs <= 1e-12), f"max increase {diffs.max():.3e}"
    assert hist[-1] <= hist[0]


@pytest.mark.parametrize("orientation", ["beta-dir", "dir-beta"])
def test_monotone_descent_masked(orientation):
    """Masked parity-mode descent, pinned to the reference's own masked
    contract: 30 sweeps strictly monotone (tests/test_one_step_and_masking.py
    :32-54 there).  The reference's asymmetric masking is not a true MM
    scheme and admits ~1e-6 late-stage increases (verified against the
    reference implementation itself); the corrected mode below carries the
    full-guarantee test."""
    X = _toy(50, 40, 0.3, seed=5)
    mask = (np.random.default_rng(9).random(X.shape) < 0.85).astype(float)
    model = NBMF(
        n_components=4, orientation=orientation, max_iter=30, tol=1e-8, random_state=1
    ).fit(X, mask=mask)
    hist = np.asarray(model.objective_history_, dtype=float)
    assert np.all(np.diff(hist) <= 1e-12)


def test_monotone_descent_corrected_masking():
    """The corrected (fully-consistent) masking mode is also a valid MM scheme
    and must descend monotonically."""
    X = _toy(50, 40, 0.3, seed=5)
    mask = (np.random.default_rng(9).random(X.shape) < 0.85).astype(float)
    model = NBMF(
        n_components=4, max_iter=100, tol=1e-8, random_state=1, mask_mode="corrected"
    ).fit(X, mask=mask)
    hist = np.asarray(model.objective_history_, dtype=float)
    assert np.all(np.diff(hist) <= 1e-12)


@pytest.mark.parametrize("alpha,beta", [(0.5, 3.0), (3.0, 0.5), (1.0, 1.0), (2.0, 2.0)])
def test_monotone_across_hyperparams(alpha, beta):
    X = _toy(40, 30, 0.3, seed=2)
    model = NBMF(
        n_components=4, alpha=alpha, beta=beta, max_iter=80, tol=1e-8, random_state=0
    ).fit(X)
    hist = np.asarray(model.objective_history_, dtype=float)
    assert np.all(np.diff(hist) <= 1e-12)


def test_beta_prior_direction_effect():
    """alpha > beta pushes the Beta factor up; alpha < beta pushes it down
    (reference test_algorithm_correctness.py:83-107)."""
    X = _toy(50, 40, 0.4, seed=4)
    m_hi = NBMF(n_components=4, alpha=4.0, beta=1.0, max_iter=80, random_state=0).fit(X)
    m_lo = NBMF(n_components=4, alpha=1.0, beta=4.0, max_iter=80, random_state=0).fit(X)
    assert m_hi.components_.mean() > m_lo.components_.mean()


def test_solver_function_contract():
    """Public solver returns (W, H, losses, time, n_iter) with real wall time
    (reference returns hard-coded 0.0 — documented deviation)."""
    X = _toy(30, 20, 0.3)
    W, H, losses, t, n_iter = nbmf_mm_solver(X, 4, max_iter=50, random_state=0)
    assert W.shape == (30, 4) and H.shape == (4, 20)
    assert len(losses) == n_iter
    assert t >= 0.0
    assert np.all(np.diff(losses) <= 1e-12)


def test_box_constraints_beta_factor():
    X = _toy(40, 30, 0.3)
    m = NBMF(n_components=4, max_iter=60, random_state=0).fit(X)
    H = m.components_
    eps = 1e-8
    assert np.all(H >= eps * 0.999) and np.all(H <= 1 - eps * 0.999)


def test_confidence_weighted_training():
    """Continuous per-entry confidence weights (WALS-style) pass through the
    mask parameter; the weighted objective is still an MM scheme in
    corrected mode (fully monotone).  Parity mode's asymmetric masking is
    only meaningful for binary masks."""
    rng = np.random.default_rng(0)
    X = (rng.random((60, 40)) < 0.3).astype(float)
    conf = rng.uniform(0.2, 2.0, X.shape)
    r = NBMF(
        n_components=4, max_iter=150, tol=1e-9, random_state=0,
        mask_mode="corrected",
    ).fit(X, mask=conf)
    hist = np.asarray(r.loss_curve_)
    assert np.all(np.diff(hist) <= 1e-12)
    np.testing.assert_allclose(r.W_.sum(axis=1), 1.0, atol=1e-9)
