"""shard_map + fused-kernel solver: per-shard kernels with explicit psums
must match the single-device XLA path (8 virtual CPU devices, interpret-mode
kernels)."""

import jax
import numpy as np
import pytest

from nbmf_mm_jax import solve
from nbmf_mm_jax.parallel.sharding import make_mesh
from nbmf_mm_jax.solver.sharded import plan_shard_padding

F32 = dict(dtype="float32")


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_mesh(jax.devices()[:8], shape=(4, 2))


def _toy(m=70, n=50, p=0.3, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < p).astype(float)


def _sharded(mesh, X, **kw):
    return solve(
        X, 4, max_iter=15, random_state=0, backend="pallas",
        pallas_interpret=True, block_m=128, block_n=128, mesh=mesh, **F32, **kw,
    )


def _plain(X, **kw):
    return solve(X, 4, max_iter=15, random_state=0, backend="jnp", **F32, **kw)


def test_plan_shard_padding():
    # each shard's local block pads like a single-device problem
    assert plan_shard_padding(70, 50, 4, 2, None, None) == (4 * 32, 2 * 32)
    assert plan_shard_padding(10000, 10000, 2, 2, None, None) == (2 * 5120, 2 * 5056)
    assert plan_shard_padding(100, 100, 1, 1, 64, 64) == (128, 128)
    Mp, Np = plan_shard_padding(300, 200, 4, 2, 128, 128)
    assert (Mp // 4) % 32 == 0 and Mp >= 300 and Np >= 200


def test_sharded_pallas_matches_plain(mesh):
    X = _toy()
    a, b = _plain(X), _sharded(mesh, X)
    assert a.n_iter == b.n_iter
    np.testing.assert_allclose(a.W, b.W, atol=2e-5)
    np.testing.assert_allclose(a.losses, b.losses, atol=2e-5)


@pytest.mark.parametrize("mask_mode", ["parity", "corrected"])
def test_sharded_pallas_masked(mesh, mask_mode):
    X = _toy(seed=2)
    mask = (np.random.default_rng(3).random(X.shape) < 0.85).astype(float)
    a = _plain(X, mask=mask, mask_mode=mask_mode)
    b = _sharded(mesh, X, mask=mask, mask_mode=mask_mode)
    np.testing.assert_allclose(a.W, b.W, atol=2e-5)
    np.testing.assert_allclose(a.losses, b.losses, atol=2e-5)


def test_sharded_pallas_dir_beta_and_duchi(mesh):
    X = _toy(seed=4)
    a = _plain(X, orientation="dir-beta", projection="duchi")
    b = _sharded(mesh, X, orientation="dir-beta", projection="duchi")
    np.testing.assert_allclose(a.W, b.W, atol=2e-5)
    np.testing.assert_allclose(a.H, b.H, atol=2e-5)


def test_sharded_pallas_early_stop(mesh):
    X = _toy(seed=5)
    a = solve(X, 4, max_iter=200, tol=1e-3, random_state=0, backend="jnp", **F32)
    b = solve(
        X, 4, max_iter=200, tol=1e-3, random_state=0, backend="pallas",
        pallas_interpret=True, block_m=128, block_n=128, mesh=mesh, **F32,
    )
    assert a.converged and b.converged
    assert abs(a.n_iter - b.n_iter) <= 1  # f32 threshold noise only
    assert len(b.losses) == b.n_iter


def test_sharded_pallas_n_init(mesh):
    """Restart axis vmapped inside the shard_map matches plain vmapped
    restarts."""
    X = _toy(seed=7)
    a = _plain(X, n_init=4)
    b = _sharded(mesh, X, n_init=4)
    assert a.best_restart == b.best_restart
    np.testing.assert_allclose(a.all_final_losses, b.all_final_losses, atol=2e-5)
    np.testing.assert_allclose(a.W, b.W, atol=2e-5)


def test_sharded_packed_matches_sharded_dense(mesh):
    """The per-shard bitpacked kernels (auto on binary data) must be
    exactly equivalent to the dense per-shard kernels."""
    X = _toy(seed=8)
    mask = (np.random.default_rng(9).random(X.shape) < 0.8).astype(float)
    for kw in ({}, dict(mask=mask), dict(mask=mask, mask_mode="corrected")):
        a = _sharded(mesh, X, packed=False, **kw)
        b = _sharded(mesh, X, packed=None, **kw)
        np.testing.assert_array_equal(a.W, b.W)
        np.testing.assert_array_equal(a.H, b.H)
        np.testing.assert_array_equal(a.losses, b.losses)


def test_sharded_packed_true_rejects_continuous(mesh):
    X = _toy(seed=10)
    X[0, 0] = 0.5
    with pytest.raises(ValueError, match="packed=True requires exactly binary"):
        _sharded(mesh, X, packed=True)


@pytest.mark.parametrize("shape", [(2, 4), (8, 1), (1, 8), (2, 2)])
def test_sharded_mesh_shapes(shape):
    """Every 2-D factorization of the device count must give the same
    answer as the single-device XLA path (collectives are shape-agnostic)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    n_dev = shape[0] * shape[1]
    mesh = make_mesh(jax.devices()[:n_dev], shape=shape)
    X = _toy(seed=11)
    mask = (np.random.default_rng(12).random(X.shape) < 0.8).astype(float)
    a = _sharded(mesh, X, mask=mask)
    b = _plain(X, mask=mask)
    assert a.n_iter == b.n_iter
    np.testing.assert_allclose(a.W, b.W, atol=2e-5)
    np.testing.assert_allclose(a.losses, b.losses, atol=2e-5)


def test_sharded_pallas_return_all(mesh):
    """The 10-init protocol (return_all) runs on the shard_map multi-device
    fast path and matches the single-device run."""
    X = _toy(seed=6)
    plain = solve(
        X, 4, max_iter=15, random_state=0, n_init=3, return_all=True,
        backend="pallas", pallas_interpret=True, block_m=128, block_n=128,
        **F32,
    )
    sharded = _sharded(mesh, X, n_init=3, return_all=True)
    assert sharded.extras["all_W"].shape == plain.extras["all_W"].shape == (3, 70, 4)
    np.testing.assert_allclose(
        sharded.extras["all_W"], plain.extras["all_W"], atol=2e-5
    )
    np.testing.assert_allclose(
        sharded.extras["all_losses"], plain.extras["all_losses"], atol=2e-5
    )
    np.testing.assert_array_equal(
        sharded.extras["all_n_iter"], plain.extras["all_n_iter"]
    )
    assert sharded.best_restart == plain.best_restart


class TestSparseMeshPrepacked:
    """scipy.sparse input on the mesh fast path: per-shard stripe words are
    packed straight from the sparse structure (pack_words_for_mesh) and
    must be BIT-IDENTICAL to the mesh solve on the equivalent dense input
    (same kernels, same words)."""

    def _dense_kw(self):
        return dict(
            max_iter=12, random_state=0, backend="pallas",
            pallas_interpret=True, block_m=128, block_n=128, **F32,
        )

    def test_unmasked_bit_identical(self, mesh):
        import scipy.sparse as sp

        Y = (np.random.default_rng(51).random((300, 200)) < 0.07).astype(
            np.float32
        )
        kw = self._dense_kw()
        d = solve(Y, 4, mesh=mesh, **kw)
        s = solve(sp.csr_matrix(Y), 4, mesh=mesh, **kw)
        assert d.n_iter == s.n_iter
        np.testing.assert_array_equal(d.W, s.W)
        np.testing.assert_array_equal(d.H, s.H)
        np.testing.assert_array_equal(
            np.asarray(d.losses), np.asarray(s.losses)
        )

    @pytest.mark.parametrize("mask_mode", ["parity", "corrected"])
    def test_masked_bit_identical(self, mesh, mask_mode):
        import scipy.sparse as sp

        rng = np.random.default_rng(52)
        Y = (rng.random((300, 200)) < 0.07).astype(np.float32)
        mask = (rng.random((300, 200)) < 0.5).astype(np.float32)
        kw = dict(self._dense_kw(), mask_mode=mask_mode)
        d = solve(Y, 4, mask=mask, mesh=mesh, **kw)
        s = solve(
            sp.csr_matrix(Y), 4, mask=sp.csr_matrix(mask), mesh=mesh, **kw
        )
        np.testing.assert_array_equal(d.W, s.W)
        np.testing.assert_array_equal(d.H, s.H)
        np.testing.assert_array_equal(
            np.asarray(d.losses), np.asarray(s.losses)
        )

    def test_restarts_and_return_all(self, mesh):
        import scipy.sparse as sp

        Y = (np.random.default_rng(53).random((300, 200)) < 0.07).astype(
            np.float32
        )
        kw = dict(self._dense_kw(), n_init=3, return_all=True)
        d = solve(Y, 3, mesh=mesh, **kw)
        s = solve(sp.csr_matrix(Y), 3, mesh=mesh, **kw)
        assert d.best_restart == s.best_restart
        np.testing.assert_array_equal(d.W, s.W)
        np.testing.assert_array_equal(
            d.extras["all_W"], s.extras["all_W"]
        )

    def test_ineligible_falls_back_and_contract(self, mesh):
        import scipy.sparse as sp

        rng = np.random.default_rng(54)
        Y = (rng.random((300, 200)) < 0.07).astype(np.float32)
        S = sp.csr_matrix(Y)
        # dense mask with sparse Y on a mesh: densify fallback, equal results
        mask = (rng.random((300, 200)) < 0.6).astype(np.float32)
        kw = self._dense_kw()
        d = solve(Y, 3, mask=mask, mesh=mesh, **kw)
        s = solve(S, 3, mask=mask, mesh=mesh, **kw)
        np.testing.assert_array_equal(s.W, d.W)
        # packed=True + non-binary sparse values raises
        with pytest.raises(ValueError, match="binary"):
            solve(S * 2.0, 3, mesh=mesh, packed=True, **kw)

    def test_dense_binary_mask_with_sparse_Y_honors_packed_true(self, mesh):
        """Sparse Y + DENSE binary mask on a mesh has no sparse fast path,
        but must densify and honor packed=True exactly like dense input
        (regression: this used to raise)."""
        import scipy.sparse as sp

        rng = np.random.default_rng(55)
        Y = (rng.random((300, 200)) < 0.07).astype(np.float32)
        mask = (rng.random((300, 200)) < 0.6).astype(np.float32)
        kw = dict(self._dense_kw(), packed=True)
        d = solve(Y, 3, mask=mask, mesh=mesh, **kw)
        s = solve(sp.csr_matrix(Y), 3, mask=mask, mesh=mesh, **kw)
        np.testing.assert_array_equal(s.W, d.W)

    def test_stripe_shrink_geometry_stays_on_fast_path(self, mesh):
        """Local blocks smaller than the requested kernel block shrink the
        block (power of two, >= 32); the words of the whole padded matrix
        still split exactly at shard boundaries, so sparse input on a
        (4, 1) mesh stays on the packed fast path and matches dense."""
        import jax
        import scipy.sparse as sp

        from nbmf_mm_jax.parallel.sharding import make_mesh

        mesh41 = make_mesh(jax.devices()[:4], shape=(4, 1))
        Y = (np.random.default_rng(56).random((400, 200)) < 0.07).astype(
            np.float32
        )
        Mp, _ = plan_shard_padding(400, 200, 4, 1, 128, 128)
        assert (Mp // 4) % 32 == 0
        kw = dict(self._dense_kw(), packed=True)
        d = solve(Y, 4, mesh=mesh41, **kw)
        s = solve(sp.csr_matrix(Y), 4, mesh=mesh41, **kw)
        np.testing.assert_array_equal(s.W, d.W)
        np.testing.assert_array_equal(
            np.asarray(s.losses), np.asarray(d.losses)
        )
