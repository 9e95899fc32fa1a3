"""n_init restart parallelism (vmapped batched solves) — a capability the
reference README promises (README.md:134,144) but never implements."""

import numpy as np
import pytest

from nbmf_mm_jax import NBMF, solve


def _toy(m=40, n=30, p=0.3, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < p).astype(float)


def test_n_init_picks_best_restart():
    X = _toy()
    res = solve(X, 4, max_iter=80, random_state=0, n_init=8)
    assert res.all_final_losses is not None and res.all_final_losses.shape == (8,)
    assert np.isclose(res.losses[-1], res.all_final_losses.min())
    assert 0 <= res.best_restart < 8


def test_n_init_never_worse_than_single():
    X = _toy(seed=3)
    single = solve(X, 4, max_iter=120, random_state=0, n_init=1)
    multi = solve(X, 4, max_iter=120, random_state=0, n_init=6)
    assert multi.losses[-1] <= single.losses[-1] + 1e-9


def test_n_init_estimator_and_reproducible():
    X = _toy(seed=1)
    m1 = NBMF(n_components=4, max_iter=60, random_state=5, n_init=4).fit(X)
    m2 = NBMF(n_components=4, max_iter=60, random_state=5, n_init=4).fit(X)
    np.testing.assert_array_equal(m1.W_, m2.W_)
    assert len(m1.loss_curve_) == m1.n_iter_
    hist = np.asarray(m1.loss_curve_)
    assert np.all(np.diff(hist) <= 1e-12)
    np.testing.assert_allclose(m1.W_.sum(axis=1), 1.0, atol=1e-9)


def test_n_init_with_custom_init_rejected():
    X = _toy()
    with pytest.raises(ValueError, match="n_init"):
        solve(X, 3, n_init=4, W_init=np.full((40, 3), 0.5))


def test_n_init_with_mask_monotone():
    X = _toy(seed=2)
    mask = (np.random.default_rng(4).random(X.shape) < 0.9).astype(float)
    res = solve(X, 3, max_iter=60, random_state=0, n_init=4, mask=mask)
    assert np.all(np.diff(res.losses) <= 1e-12)


def test_return_all_restarts():
    """return_all exposes every restart's model (the paper's 10-init
    protocol needs per-init factors, not just the best)."""
    X = _toy()
    res = solve(X, 3, max_iter=60, random_state=0, n_init=4, return_all=True)
    ex = res.extras
    assert ex["all_W"].shape == (4, 40, 3) and ex["all_H"].shape == (4, 3, 30)
    assert ex["all_n_iter"].shape == (4,) and ex["all_losses"].shape == (4, 60)
    # best restart's factors must equal the packaged result
    np.testing.assert_allclose(ex["all_W"][res.best_restart], res.W, atol=1e-9)
    # every restart satisfies the simplex constraint
    for i in range(4):
        np.testing.assert_allclose(ex["all_W"][i].sum(axis=1), 1.0, atol=1e-8)
    with pytest.raises(ValueError, match="return_all"):
        solve(X, 3, n_init=1, return_all=True)


def test_return_all_dir_beta_orientation():
    X = _toy(seed=7)
    res = solve(X, 3, max_iter=40, random_state=1, n_init=3,
                return_all=True, orientation="dir-beta")
    ex = res.extras
    assert ex["all_W"].shape == (3, 40, 3) and ex["all_H"].shape == (3, 3, 30)
    for i in range(3):
        np.testing.assert_allclose(ex["all_H"][i].sum(axis=0), 1.0, atol=1e-8)
