"""Estimator attribute/validation contract (reference test_api.py /
test_api_basic.py / test_nbmf_mm.py property categories)."""

import numpy as np
import pytest

from nbmf_mm_jax import NBMF


def _toy(m=60, n=80, p=0.25, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < p).astype(float)


def test_attribute_contract():
    X = _toy()
    model = NBMF(n_components=8, max_iter=100, tol=1e-6, random_state=0).fit(X)
    assert model.W_.shape == (60, 8)
    assert model.components_.shape == (8, 80)
    assert isinstance(model.loss_curve_, list)
    assert model.objective_history_ is model.loss_curve_
    assert len(model.objective_history_) == model.n_iter_
    assert np.isfinite(model.objective_history_[-1])
    assert model.reconstruction_err_ == model.loss_curve_[-1]
    assert model.loss_ == model.loss_curve_[-1]


def test_orientation_aliases_roundtrip():
    X = _toy(20, 10, 0.3)
    for alias, canon in [
        ("Dir-Beta", "dir-beta"),
        ("Aspect Bernoulli", "dir-beta"),
        ("Dir Beta", "dir-beta"),
        ("Beta-Dir", "beta-dir"),
        ("Binary ICA", "beta-dir"),
        ("bICA", "beta-dir"),
    ]:
        m = NBMF(n_components=3, orientation=alias, max_iter=5, random_state=0).fit(X)
        assert m.orientation == canon
    with pytest.raises(ValueError):
        NBMF(n_components=3, orientation="Dir-Dir").fit(X)


def test_binary_validation():
    X = np.random.default_rng(0).random((20, 10)) + 1.5  # outside [0,1]
    with pytest.raises(ValueError, match="must be binary"):
        NBMF(n_components=3).fit(X)
    X2 = -np.ones((5, 5))
    with pytest.raises(ValueError, match="must be binary"):
        NBMF(n_components=3).fit(X2)


def test_custom_init_accepted():
    X = _toy(30, 20, 0.3)
    rng = np.random.default_rng(1)
    W0 = rng.uniform(0.1, 0.9, (30, 4))
    H0 = rng.uniform(0.1, 0.9, (4, 20))
    m = NBMF(n_components=4, W_init=W0, H_init=H0, max_iter=60, random_state=0).fit(X)
    assert m.W_.shape == (30, 4)
    assert np.isfinite(m.loss_)
    hist = np.asarray(m.loss_curve_)
    assert np.all(hist[1:] <= hist[:-1] + 1e-8)


def test_custom_init_wrong_shape_raises():
    X = _toy(30, 20, 0.3)
    with pytest.raises(ValueError, match="W_init"):
        NBMF(n_components=4, W_init=np.ones((3, 4)) * 0.5, max_iter=5).fit(X)


def test_convergence_speed_ordering():
    X = _toy(50, 40, 0.3, seed=3)
    loose = NBMF(n_components=4, tol=1e-2, max_iter=500, random_state=0).fit(X)
    tight = NBMF(n_components=4, tol=1e-9, max_iter=500, random_state=0).fit(X)
    assert loose.n_iter_ < 50
    assert tight.n_iter_ > loose.n_iter_


def test_not_fitted_errors():
    model = NBMF(n_components=3)
    with pytest.raises(ValueError, match="not fitted"):
        model.transform(np.zeros((4, 5)))
    with pytest.raises(ValueError, match="not fitted"):
        model.inverse_transform(np.zeros((4, 3)))
    with pytest.raises(ValueError, match="not fitted"):
        model.score(np.zeros((4, 5)))


def test_get_set_params_sklearn_compat():
    sklearn = pytest.importorskip("sklearn")
    from sklearn.base import clone

    m = NBMF(n_components=7, alpha=1.5, orientation="dir-beta")
    params = m.get_params()
    assert params["n_components"] == 7 and params["alpha"] == 1.5
    m2 = clone(m)
    assert m2.get_params()["orientation"] == "dir-beta"


def test_legacy_accel_flags_accepted():
    X = _toy(20, 10, 0.3)
    m = NBMF(
        n_components=3,
        max_iter=5,
        use_numexpr=True,
        use_numba=False,
        projection_backend="numpy",
    ).fit(X)
    assert hasattr(m, "W_")


def test_reconstruction_quality(tiny_clusters):
    """Thresholded reconstruction should beat random on structured data
    (reference tests/test_nbmf_mm.py:52-66)."""
    X = tiny_clusters
    m = NBMF(n_components=3, max_iter=300, tol=1e-7, random_state=0).fit(X)
    Xr = m.inverse_transform(m.W_)
    err = np.mean((Xr > 0.5).astype(float) != X)
    assert err < 0.4


def test_invalid_mask_mode_rejected_every_backend():
    """mask_mode typos must raise on every backend up front (ADVICE round 1:
    the Pallas path used to silently fall back to parity semantics)."""
    from nbmf_mm_jax import solve

    X = _toy(12, 9, 0.3)
    mask = np.ones_like(X)
    for backend in ("jnp", "pallas", "auto"):
        with pytest.raises(ValueError, match="mask_mode"):
            solve(X, 2, max_iter=3, mask=mask, mask_mode="correctd",
                  backend=backend, pallas_interpret=True)
    with pytest.raises(ValueError, match="mask_mode"):
        NBMF(n_components=2, max_iter=3, mask_mode="bogus").fit(X, mask=mask)


def test_estimator_backend_param():
    """The estimator exposes `backend` and forwards it to the solver; a
    forced interpret-mode check goes through solve() directly (the Pallas
    estimator path on CPU requires interpret, which fit doesn't expose)."""
    from nbmf_mm_jax import solve

    X = _toy(20, 15, 0.3)
    m_jnp = NBMF(n_components=3, max_iter=20, random_state=0, backend="jnp").fit(X)
    m_auto = NBMF(n_components=3, max_iter=20, random_state=0).fit(X)
    assert m_auto.backend == "auto"
    np.testing.assert_allclose(m_jnp.W_, m_auto.W_)  # auto == jnp on CPU
    with pytest.raises(ValueError, match="backend"):
        solve(X, 2, max_iter=3, backend="cuda")


def test_estimator_pickled_before_mesh_axes():
    """Estimators pickled before mesh_axes existed (no attribute in
    __dict__) must still fit/transform via the getattr fallback."""
    X = (np.random.default_rng(0).random((30, 20)) < 0.4).astype(float)
    m = NBMF(n_components=3, max_iter=30, random_state=0).fit(X)
    del m.mesh_axes  # simulate a pre-mesh_axes pickle
    m.fit(X)
    W = m.transform(X)
    assert W.shape == (30, 3)


def test_dir_beta_single_sided_init_rejected():
    """A lone W_init/H_init under dir-beta is rejected with a clear error
    (the reference silently mis-assigns it on square data)."""
    X = (np.random.default_rng(1).random((20, 20)) < 0.4).astype(float)
    H = np.random.default_rng(2).uniform(0.1, 0.9, (3, 20))
    with pytest.raises(ValueError, match="BOTH"):
        NBMF(n_components=3, orientation="dir-beta", H_init=H).fit(X)
