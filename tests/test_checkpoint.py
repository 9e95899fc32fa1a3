"""Checkpoint/resume (SURVEY.md §5: first-class save/restore of
(W, H, loss history, iter, seed); warm start == resume)."""

import numpy as np

from nbmf_mm_jax import NBMF
from nbmf_mm_jax.utils import (
    load_checkpoint,
    load_model,
    resume_fit,
    save_checkpoint,
    save_model,
)


def _toy(m=40, n=30, p=0.3, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < p).astype(float)


def test_checkpoint_roundtrip(tmp_path):
    path = tmp_path / "ckpt.npz"
    W = np.random.default_rng(0).random((10, 3))
    H = np.random.default_rng(1).random((3, 8))
    save_checkpoint(path, W, H, [1.0, 0.5], 2, seed=42, hyperparams={"alpha": 1.2})
    ckpt = load_checkpoint(path)
    np.testing.assert_array_equal(ckpt["W"], W)
    np.testing.assert_array_equal(ckpt["H"], H)
    assert ckpt["losses"] == [1.0, 0.5]
    assert ckpt["n_iter"] == 2
    assert ckpt["seed"] == 42
    assert ckpt["hyperparams"]["alpha"] == 1.2


def test_model_save_load_scores_identically(tmp_path):
    X = _toy()
    m = NBMF(n_components=3, max_iter=60, random_state=0).fit(X)
    path = tmp_path / "model.npz"
    save_model(path, m)
    m2 = load_model(path)
    np.testing.assert_array_equal(m2.W_, m.W_)
    np.testing.assert_array_equal(m2.components_, m.components_)
    assert m2.n_iter_ == m.n_iter_
    assert np.isclose(m2.score(X), m.score(X))


def test_resume_continues_descent(tmp_path):
    X = _toy(seed=2)
    partial_model = NBMF(n_components=3, max_iter=5, tol=1e-12, random_state=0).fit(X)
    path = tmp_path / "partial.npz"
    save_model(path, partial_model)
    resumed = resume_fit(path, X, max_iter=60)
    hist = np.asarray(resumed.loss_curve_)
    assert len(hist) == resumed.n_iter_
    assert len(hist) > 5
    # Resumed optimization keeps descending from the checkpointed state.
    assert np.all(np.diff(hist) <= 1e-12)
    assert hist[-1] <= hist[4]


def test_resume_with_fully_unobserved_sample(tmp_path):
    """Warm-starting from a checkpoint whose factors carry an all-zero
    simplex vector (the pinned contract for fully-unobserved samples) must
    not NaN: the init renorm is guarded like the in-loop simplex step, so
    the zero vector stays exactly zero and the resumed trajectory keeps
    descending (found by tools/stress_solve.py --backend estimator,
    seed 11 draw 86: the unguarded 0/0 renorm poisoned every factor)."""
    rng = np.random.default_rng(5)
    X = (rng.random((4, 33)) < 0.5).astype(float)
    mask = (rng.random((4, 33)) < 0.7).astype(float)
    mask[:, 25] = 0.0  # one fully-unobserved column
    model = NBMF(
        n_components=3, max_iter=26, tol=1e-4, alpha=3.46, beta=3.43,
        orientation="dir-beta", mask_mode="corrected", random_state=0,
        dtype="float64",
    ).fit(X, mask=mask)
    H = np.asarray(model.components_)
    assert H[:, 25].sum() == 0.0  # the zero simplex vector is present
    path = tmp_path / "unobserved.npz"
    save_model(path, model)
    resumed = resume_fit(path, X, mask=mask)
    hist = np.asarray(resumed.loss_curve_)
    assert np.all(np.isfinite(hist))
    assert np.all(np.isfinite(resumed.W_))
    assert np.all(np.isfinite(resumed.components_))
    # Descent carries across the checkpoint boundary and beyond.
    assert np.all(np.diff(hist[model.n_iter_ - 1:]) <= 1e-10)
    # The unobserved sample's simplex vector stays exactly zero.
    assert np.asarray(resumed.components_)[:, 25].sum() == 0.0


def test_warm_start_zero_simplex_row_direct_solve():
    """solve(W_init=prev.W, H_init=prev.H) with a boundary-zero simplex
    row (beta-dir orientation) is NaN-free too — the guard lives in the
    driver's init ingestion, not in resume_fit."""
    from nbmf_mm_jax import solve

    rng = np.random.default_rng(7)
    X = (rng.random((20, 12)) < 0.4).astype(float)
    mask = (rng.random((20, 12)) < 0.8).astype(float)
    mask[3, :] = 0.0  # one fully-unobserved row (beta-dir simplex side)
    first = solve(X, 3, mask=mask, mask_mode="corrected", max_iter=20,
                  tol=0.0, random_state=1, dtype="float64")
    W = np.asarray(first.W)
    assert W[3].sum() == 0.0
    second = solve(X, 3, W_init=first.W, H_init=first.H, mask=mask,
                   mask_mode="corrected", max_iter=10, tol=0.0,
                   dtype="float64")
    assert np.all(np.isfinite(np.asarray(second.losses)))
    assert np.all(np.isfinite(second.W)) and np.all(np.isfinite(second.H))
    assert np.asarray(second.W)[3].sum() == 0.0
    # Warm start descends from the checkpointed loss.
    assert np.asarray(second.losses)[0] <= np.asarray(first.losses)[-1] + 1e-10


def test_fit_checkpointed_segments(tmp_path):
    from nbmf_mm_jax.utils.checkpoint import fit_checkpointed, load_checkpoint

    X = _toy(seed=9)
    path = tmp_path / "segmented.npz"
    model = NBMF(n_components=3, max_iter=60, tol=1e-12, random_state=0)
    fitted = fit_checkpointed(model, X, path, every=20)
    assert fitted.n_iter_ == 60
    assert len(fitted.loss_curve_) == 60
    hist = np.asarray(fitted.loss_curve_)
    assert np.all(np.diff(hist) <= 1e-10)  # continues descending across segments
    ckpt = load_checkpoint(path)
    assert ckpt["n_iter"] == 60
    # trajectory ~= uninterrupted fit
    ref = NBMF(n_components=3, max_iter=60, tol=1e-12, random_state=0).fit(X)
    np.testing.assert_allclose(hist, ref.loss_curve_, rtol=1e-8)


def test_fit_checkpointed_early_convergence(tmp_path):
    from nbmf_mm_jax.utils.checkpoint import fit_checkpointed

    X = _toy(seed=10)
    model = NBMF(n_components=3, max_iter=500, tol=1e-3, random_state=0)
    fitted = fit_checkpointed(model, X, tmp_path / "c.npz", every=50)
    assert fitted.n_iter_ < 500
    assert len(fitted.loss_curve_) == fitted.n_iter_


def test_orbax_checkpoint_roundtrip(tmp_path):
    """The Orbax (async-capable, multi-host friendly) variant round-trips
    the same state dict as the npz path."""
    from nbmf_mm_jax.utils.checkpoint import (
        load_checkpoint_orbax,
        save_checkpoint_orbax,
    )

    state = {
        "W": np.random.default_rng(0).random((12, 3)),
        "H": np.random.default_rng(1).random((3, 9)),
        "losses": np.linspace(1.0, 0.5, 7),
        "n_iter": np.asarray(7),
    }
    path = save_checkpoint_orbax(str(tmp_path / "orbax"), state, step=7)
    if path is None:
        pytest.skip("orbax not available")
    restored = load_checkpoint_orbax(path)
    assert set(restored) == set(state)
    for k in state:
        np.testing.assert_allclose(np.asarray(restored[k]), state[k])


def test_fit_checkpointed_with_restarts(tmp_path):
    """n_init > 1 selects the best restart in segment 1; later segments
    warm-start that restart instead of crashing on the n_init/W_init
    conflict."""
    from nbmf_mm_jax.utils.checkpoint import fit_checkpointed

    X = _toy(seed=11)
    model = NBMF(n_components=3, max_iter=60, tol=1e-12, random_state=0,
                 n_init=3)
    fitted = fit_checkpointed(model, X, tmp_path / "r.npz", every=20)
    assert fitted.n_iter_ == 60
    hist = np.asarray(fitted.loss_curve_)
    assert np.all(np.diff(hist) <= 1e-10)
