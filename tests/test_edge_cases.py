"""Degenerate and boundary inputs: the solver must stay finite and keep its
constraints where the reference would (and degrade gracefully where the
reference crashes)."""

import numpy as np
import pytest

from nbmf_mm_jax import NBMF, solve


def test_rank_one():
    X = (np.random.default_rng(0).random((30, 20)) < 0.4).astype(float)
    m = NBMF(n_components=1, max_iter=50, random_state=0).fit(X)
    np.testing.assert_allclose(m.W_, 1.0)  # 1-simplex rows are exactly 1
    assert np.all(np.isfinite(m.loss_curve_))
    assert np.all(np.diff(m.loss_curve_) <= 1e-12)


def test_rank_exceeds_dims():
    X = (np.random.default_rng(1).random((10, 8)) < 0.4).astype(float)
    m = NBMF(n_components=16, max_iter=30, random_state=0).fit(X)
    assert m.W_.shape == (10, 16)
    np.testing.assert_allclose(m.W_.sum(axis=1), 1.0, atol=1e-9)
    assert np.all(np.isfinite(m.loss_curve_))


@pytest.mark.parametrize("fill", [0.0, 1.0])
def test_constant_matrix(fill):
    X = np.full((20, 15), fill)
    m = NBMF(n_components=3, max_iter=50, random_state=0).fit(X)
    assert np.all(np.isfinite(m.loss_curve_))
    R = m.inverse_transform(m.W_)
    # reconstruction should approach the constant
    assert abs(R.mean() - fill) < 0.05


def test_continuous_values_in_unit_interval():
    """The reference accepts any X in [0,1], not just binary."""
    X = np.random.default_rng(2).random((40, 30))
    m = NBMF(n_components=4, max_iter=80, random_state=0).fit(X)
    assert np.all(np.diff(m.loss_curve_) <= 1e-12)


def test_single_row_and_column():
    X = (np.random.default_rng(3).random((1, 30)) < 0.4).astype(float)
    m = NBMF(n_components=2, max_iter=20, random_state=0).fit(X)
    assert m.W_.shape == (1, 2)
    Xc = X.T
    m2 = NBMF(n_components=2, max_iter=20, random_state=0).fit(Xc)
    assert m2.components_.shape == (2, 1)


def test_all_masked_out_column():
    """A fully-unobserved column must not produce NaNs."""
    X = (np.random.default_rng(4).random((30, 20)) < 0.4).astype(float)
    mask = np.ones_like(X)
    mask[:, 7] = 0.0
    r = solve(X, 3, max_iter=40, random_state=0, mask=mask)
    assert np.all(np.isfinite(r.W)) and np.all(np.isfinite(r.H))
    assert np.all(np.isfinite(r.losses))


def test_empty_mask_raises():
    """Pinned n_obs == 0 contract: an all-zero mask makes the per-entry
    objective undefined, so the solver raises a clear ValueError up front
    (the reference divides by zero silently, _solver.py:162)."""
    X = (np.random.default_rng(5).random((10, 8)) < 0.4).astype(float)
    mask = np.zeros_like(X)
    with pytest.raises(ValueError, match="no observed entries"):
        solve(X, 2, max_iter=5, random_state=0, mask=mask)
    # Same contract through the estimator path.
    with pytest.raises(ValueError, match="no observed entries"):
        NBMF(n_components=2, max_iter=5, random_state=0).fit(X, mask=mask)


def test_pallas_edge_shapes():
    """Tiny and prime-sized shapes through the padded Pallas path."""
    for shape in [(3, 5), (129, 257), (128, 128)]:
        X = (np.random.default_rng(6).random(shape) < 0.4).astype(float)
        a = solve(X, 2, max_iter=8, random_state=0, dtype="float32", backend="jnp")
        b = solve(
            X, 2, max_iter=8, random_state=0, dtype="float32",
            backend="pallas", pallas_interpret=True, block_m=64, block_n=64,
        )
        np.testing.assert_allclose(a.W, b.W, atol=3e-5, err_msg=str(shape))


def test_boundary_prior_f32_losses_finite():
    """alpha, beta < 1 push H to the boundary; in f32 the reference's
    1 - eps clip bound rounds to exactly 1.0 and XLA's reassociation of
    ``1 - H + eps`` then produced log(0) = -inf losses under jit.  The
    dtype-aware interior clip (ops.updates.clip_upper_interior) must keep
    every backend finite (regression for a 200-draw stress-sweep find)."""
    from nbmf_mm_jax import solve

    rng = np.random.default_rng(1499948972)
    X = (rng.random((10, 127)) < 0.4).astype(float)
    kw = dict(max_iter=16, tol=1e-6, alpha=0.44, beta=0.48, random_state=7,
              n_init=1)
    for extra in (
        dict(backend="jnp", dtype="float32"),
        dict(backend="pallas", pallas_interpret=True, dtype="float32",
             block_m=128, block_n=128),
        dict(backend="pallas", pallas_interpret=True, dtype="float32",
             block_m=128, block_n=128, packed=False),
    ):
        r = solve(X, 7, **kw, **extra)
        assert np.all(np.isfinite(np.asarray(r.losses)))
        assert np.all(np.isfinite(r.W)) and np.all(np.isfinite(r.H))
        # H stays strictly interior in its dtype
        assert r.H.max() < 1.0


def test_clip_upper_interior_dtypes():
    from nbmf_mm_jax.ops.updates import clip_upper_interior

    f32 = float(clip_upper_interior(1e-8, np.float32))
    assert f32 < 1.0  # NOT rounded up to 1.0
    f64 = float(clip_upper_interior(1e-8, np.float64))
    assert f64 == 1.0 - 1e-8  # reference-exact in f64


def test_all_masked_out_row_gives_zero_simplex_row():
    """A fully-unobserved ROW has an unidentifiable simplex weight; the
    zero-column guard returns an all-zero W row (the reference produces
    0/0 = NaN there).  All observed rows keep unit sums."""
    X = (np.random.default_rng(5).random((30, 20)) < 0.4).astype(float)
    mask = np.ones_like(X)
    mask[11, :] = 0.0
    r = solve(X, 3, max_iter=40, random_state=0, mask=mask)
    assert np.all(np.isfinite(r.W))
    sums = r.W.sum(axis=1)
    assert sums[11] == 0.0
    np.testing.assert_allclose(np.delete(sums, 11), 1.0, atol=1e-6)


def test_device_results_identical_and_on_device():
    """``device_results=True`` keeps W/H/losses as jax arrays (no host
    pull; the simplex safeguard runs on-device) and is bit-identical to
    the default host packaging — on every orientation/mask/restart
    routing.  Motivation: at flagship scale the 49 MB W retrieval can
    dominate the solve wall time on a slow host link
    (experiments/flagship_scale.py records it separately)."""
    import jax

    rng = np.random.default_rng(7)
    Y = (rng.random((60, 40)) < 0.4).astype(float)
    a = solve(Y, 5, max_iter=40, random_state=0)
    b = solve(Y, 5, max_iter=40, random_state=0, device_results=True)
    assert not isinstance(a.W, jax.Array)
    assert isinstance(b.W, jax.Array) and isinstance(b.H, jax.Array)
    np.testing.assert_array_equal(a.W, np.asarray(b.W))
    np.testing.assert_array_equal(a.H, np.asarray(b.H))
    np.testing.assert_array_equal(np.asarray(a.losses), np.asarray(b.losses))
    assert a.n_iter == b.n_iter and a.converged == b.converged
    assert len(b.losses) == b.n_iter  # history contract holds on-device

    mask = (rng.random((60, 40)) < 0.8).astype(float)
    c = solve(Y, 5, max_iter=30, random_state=1, orientation="dir-beta",
              mask=mask, n_init=3)
    d = solve(Y, 5, max_iter=30, random_state=1, orientation="dir-beta",
              mask=mask, n_init=3, device_results=True)
    np.testing.assert_array_equal(c.W, np.asarray(d.W))
    np.testing.assert_array_equal(c.H, np.asarray(d.H))
    assert c.best_restart == d.best_restart


def test_device_warm_start_matches_host_warm_start():
    """W_init/H_init may be device arrays (e.g. a previous
    solve(device_results=True)'s factors): no host round-trip, identical
    trajectory to the equivalent numpy warm start."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    Y = (rng.random((50, 30)) < 0.4).astype(float)
    W0 = rng.uniform(0.1, 0.9, (50, 4))
    H0 = rng.uniform(0.1, 0.9, (4, 30))
    a = solve(Y, 4, max_iter=25, W_init=W0, H_init=H0)
    b = solve(Y, 4, max_iter=25, W_init=jnp.asarray(W0), H_init=jnp.asarray(H0))
    np.testing.assert_array_equal(a.W, b.W)
    np.testing.assert_array_equal(a.H, b.H)
    np.testing.assert_array_equal(np.asarray(a.losses), np.asarray(b.losses))
