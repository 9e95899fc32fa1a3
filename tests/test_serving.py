"""FoldInServer: shape-bucketed, precompiled fold-in for serving."""

import numpy as np
import pytest

from nbmf_mm_jax import NBMF
from nbmf_mm_jax.models.serving import FoldInServer


@pytest.fixture(scope="module")
def model():
    X = (np.random.default_rng(0).random((80, 40)) < 0.3).astype(float)
    return NBMF(n_components=4, max_iter=100, random_state=0).fit(X)


def test_fold_in_shapes_and_simplex(model):
    srv = FoldInServer(model, buckets=(8, 32))
    Xnew = (np.random.default_rng(1).random((5, 40)) < 0.3).astype(float)
    W, scores = srv.transform(Xnew)
    assert W.shape == (5, 4) and scores.shape == (5,)
    np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-6)
    assert np.all(np.isfinite(scores)) and np.all(scores <= 0)


def test_padding_does_not_change_real_rows(model):
    """Row-independence: the same rows give identical results whether they
    arrive alone-with-padding or alongside other rows (same bucket)."""
    srv = FoldInServer(model, buckets=(16,))
    rng = np.random.default_rng(2)
    X10 = (rng.random((10, 40)) < 0.3).astype(float)
    W10, s10 = srv.transform(X10)
    W3, s3 = srv.transform(X10[:3])
    np.testing.assert_allclose(W3, W10[:3], atol=1e-6)
    np.testing.assert_allclose(s3, s10[:3], atol=1e-6)


def test_chunking_beyond_top_bucket(model):
    srv = FoldInServer(model, buckets=(4, 8))
    Xnew = (np.random.default_rng(3).random((21, 40)) < 0.3).astype(float)
    W, s = srv.transform(Xnew)
    assert W.shape == (21, 4) and s.shape == (21,)


def test_masked_serving(model):
    srv = FoldInServer(model, buckets=(8,))
    rng = np.random.default_rng(4)
    Xnew = (rng.random((6, 40)) < 0.3).astype(float)
    mask = (rng.random((6, 40)) < 0.8).astype(float)
    W, s = srv.transform(Xnew, mask=mask)
    assert np.all(np.isfinite(s))
    np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-6)


def test_accepts_raw_H_and_warmup(model):
    srv = FoldInServer(model.components_, buckets=(8,)).warmup()
    Xnew = (np.random.default_rng(5).random((2, 40)) < 0.3).astype(float)
    W, _ = srv.transform(Xnew)
    assert W.shape == (2, 4)


def test_unfitted_estimator_rejected():
    with pytest.raises(ValueError, match="not fitted"):
        FoldInServer(NBMF(n_components=3))


def test_pallas_serving_matches_xla(model):
    """The fused-kernel serving path agrees with the XLA path at a non-toy
    shape, masked and unmasked.

    One fold-in iteration must match tightly (same kernel math).  After the
    full 50 iterations exact parity is NOT attainable by ANY two
    implementations: the multiplicative fold-in is chaotic for rows near
    basin boundaries (measured: XLA f32 vs XLA f64 from the same init
    drift up to 0.47 in W entries) — so the 50-iteration check asserts
    quality-level agreement of the per-row log-likelihoods instead.
    """
    rng = np.random.default_rng(6)
    Xnew = (rng.random((300, 40)) < 0.3).astype(float)
    mask = (rng.random((300, 40)) < 0.8).astype(float)

    def make(backend, n_iter=50):
        kw = dict(buckets=(512,), dtype="float32", n_iter=n_iter, backend=backend)
        if backend == "pallas":
            kw.update(pallas_interpret=True, block_m=128, block_n=128)
        return FoldInServer(model, **kw)

    # 1 iteration: tight kernel-math parity.
    for mk in (None, mask):
        Wx, sx = make("jnp", 1).transform(Xnew, mask=mk)
        Wp, sp = make("pallas", 1).transform(Xnew, mask=mk)
        np.testing.assert_allclose(Wp, Wx, atol=2e-5)
        np.testing.assert_allclose(sp, sx, atol=2e-5)

    # 50 iterations: equivalent fit quality.
    for mk in (None, mask):
        _, sx = make("jnp").transform(Xnew, mask=mk)
        Wp, sp = make("pallas").transform(Xnew, mask=mk)
        np.testing.assert_allclose(Wp.sum(axis=1), 1.0, atol=1e-5)
        assert float(np.mean(sp)) >= float(np.mean(sx)) - 2e-3
        assert np.mean(np.abs(sp - sx)) < 5e-3


def test_mesh_sharded_serving(model):
    """GSPMD serving: batch sharded over mesh rows, features over cols;
    results match the unsharded path."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    from nbmf_mm_jax.parallel.sharding import make_mesh

    mesh = make_mesh(jax.devices()[:4])
    rng = np.random.default_rng(7)
    Xnew = (rng.random((64, 40)) < 0.3).astype(float)
    mask = (rng.random((64, 40)) < 0.8).astype(float)
    # 1 iteration: tight parity (sharded reductions reorder sums; over the
    # full 50 chaotic iterations only quality-level agreement holds — see
    # test_pallas_serving_matches_xla).
    W, s = FoldInServer(model, buckets=(64,), n_iter=1).transform(Xnew, mask=mask)
    Wm, sm = FoldInServer(model, buckets=(64,), n_iter=1, mesh=mesh).transform(
        Xnew, mask=mask
    )
    np.testing.assert_allclose(Wm, W, atol=1e-9)
    np.testing.assert_allclose(sm, s, atol=1e-9)
    # 50 iterations: equivalent fit quality.
    _, s50 = FoldInServer(model, buckets=(64,)).transform(Xnew, mask=mask)
    Wm50, sm50 = FoldInServer(model, buckets=(64,), mesh=mesh).transform(
        Xnew, mask=mask
    )
    np.testing.assert_allclose(Wm50.sum(axis=1), 1.0, atol=1e-9)
    assert float(np.mean(sm50)) >= float(np.mean(s50)) - 2e-3


def test_mesh_sharded_estimator_transform(model):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    from nbmf_mm_jax.parallel.sharding import make_mesh

    X = (np.random.default_rng(8).random((64, 40)) < 0.3).astype(float)

    def mean_ll(W):
        R = np.clip(W @ model.components_, 1e-8, 1 - 1e-8)
        return float((X * np.log(R) + (1 - X) * np.log(1 - R)).mean())

    W_ref = model.transform(X)
    model.mesh = make_mesh(jax.devices()[:4])
    try:
        W_mesh = model.transform(X)
    finally:
        model.mesh = None
    # Sharded reductions reorder sums and the 50-iteration fold-in is
    # chaotic for boundary rows (see test_pallas_serving_matches_xla), so
    # assert equivalent fit quality rather than exact factors.
    np.testing.assert_allclose(W_mesh.sum(axis=1), 1.0, atol=1e-9)
    assert mean_ll(W_mesh) >= mean_ll(W_ref) - 2e-3


def test_packed_serving_bitwise_matches_dense(model):
    """Auto-packed serving chunks (binary data) must be bit-identical to
    the dense kernels, masked and unmasked."""
    rng = np.random.default_rng(7)
    Xnew = (rng.random((200, 40)) < 0.3).astype(float)
    mask = (rng.random((200, 40)) < 0.8).astype(float)
    kw = dict(buckets=(256,), dtype="float32", backend="pallas",
              pallas_interpret=True, block_m=128, block_n=128)
    for mk in (None, mask):
        Wd, sd = FoldInServer(model, packed=False, **kw).transform(Xnew, mask=mk)
        Wp, sp = FoldInServer(model, packed=None, **kw).transform(Xnew, mask=mk)
        np.testing.assert_array_equal(Wp, Wd)
        np.testing.assert_array_equal(sp, sd)


def test_packed_serving_continuous_fallback(model):
    """A confidence-weighted (continuous) mask makes the chunk ineligible:
    the auto rule must serve it through the dense kernels, same results."""
    rng = np.random.default_rng(8)
    Xnew = (rng.random((50, 40)) < 0.3).astype(float)
    w = rng.random((50, 40))
    kw = dict(buckets=(64,), dtype="float32", backend="pallas",
              pallas_interpret=True, block_m=128, block_n=128)
    Wd, _ = FoldInServer(model, packed=False, **kw).transform(Xnew, mask=w)
    Wa, _ = FoldInServer(model, packed=None, **kw).transform(Xnew, mask=w)
    np.testing.assert_array_equal(Wa, Wd)


def test_stage_fold_in_packs_binary_chunks():
    """Request staging: an exactly-binary chunk ships as words for
    X*mask and (1-X)*mask that unpack to exactly those operands, zero in
    the padding; a continuous mask ships dense; packed=True rejects it."""
    import jax.numpy as jnp

    from nbmf_mm_jax.models.serving import _stage_fold_in
    from nbmf_mm_jax.ops import pallas_sweep as ps

    rng = np.random.default_rng(9)
    X = (rng.random((5, 40)) < 0.3).astype(float)
    mask = (rng.random((5, 40)) < 0.8).astype(float)
    A, B, packed = _stage_fold_in(X, mask, 5, 32, 64, jnp.float32, None)
    assert packed and A.shape == B.shape == (1, 64)
    Ym = np.asarray(ps.unpack_bits(A))
    Ym2 = np.asarray(ps.unpack_bits(B))
    np.testing.assert_array_equal(Ym[:5, :40], X * mask)
    np.testing.assert_array_equal(Ym2[:5, :40], (1 - X) * mask)
    assert not Ym[5:].any() and not Ym2[:, 40:].any()
    A, B, packed = _stage_fold_in(X, mask * 0.5, 5, 32, 64, jnp.float32, None)
    assert not packed and A.shape == (32, 64)
    with pytest.raises(ValueError, match="exactly binary"):
        _stage_fold_in(X, mask * 0.5, 5, 32, 64, jnp.float32, True)


def test_warmup_covers_dense_variant(model):
    """warmup() must precompile the dense fallback too: a continuous-mask
    request after warmup serves through an already-working path."""
    srv = FoldInServer(model, buckets=(8,), dtype="float32", backend="pallas",
                       pallas_interpret=True, block_m=128, block_n=128).warmup()
    X = (np.random.default_rng(0).random((4, 40)) < 0.3).astype(float)
    w = np.random.default_rng(1).random((4, 40))
    W, _ = srv.transform(X, mask=w)
    assert np.isfinite(W).all()


def test_empty_batch(model):
    srv = FoldInServer(model, buckets=(8,))
    W, s = srv.transform(np.zeros((0, 40)))
    assert W.shape == (0, 4) and s.shape == (0,)


def test_packed_true_requires_pallas_route(model):
    with pytest.raises(ValueError, match="packed=True requires the Pallas"):
        FoldInServer(model, packed=True, backend="jnp")


def test_foldin_server_packed_true_rejects_nonbinary():
    """packed=True must not silently binarize non-binary chunks — same
    contract as solve(packed=True)."""
    import pytest as _pytest

    H = np.full((4, 160), 0.5)
    srv = FoldInServer(
        H, backend="pallas", pallas_interpret=True, packed=True,
        dtype="float32", buckets=(128,),
    )
    X = np.random.default_rng(0).random((64, 160))  # continuous, non-binary
    with _pytest.raises(ValueError, match="exactly binary"):
        srv.transform(X)


def test_fold_in_fused_matches_xla_transform():
    """The estimator's fused transform dispatch (backend='pallas') matches
    the XLA fold-in to f32 kernel tolerance — same seeded W0 draw."""
    from nbmf_mm_jax import NBMF

    rng = np.random.default_rng(5)
    X = (rng.random((150, 170)) < 0.35).astype(float)
    Xnew = (rng.random((90, 170)) < 0.35).astype(float)
    mask = (rng.random(Xnew.shape) < 0.8).astype(float)

    base = NBMF(n_components=4, max_iter=40, random_state=3, dtype="float32")
    base.fit(X)
    W_xla = base.transform(Xnew)
    W_xla_masked = base.transform(Xnew, mask=mask)

    fused = NBMF(
        n_components=4, max_iter=40, random_state=3, dtype="float32",
        backend="pallas", solver_options={"pallas_interpret": True},
    )
    # The kernels run interpreted on CPU (asked for through
    # solver_options); reuse the fitted factors instead of refitting
    # (transform only needs components_).
    fused.components_ = base.components_
    fused.W_ = base.W_
    fused.orientation = base.orientation
    W_fused = fused.transform(Xnew)
    W_fused_masked = fused.transform(Xnew, mask=mask)

    np.testing.assert_allclose(W_fused, W_xla, atol=5e-5)
    np.testing.assert_allclose(W_fused_masked, W_xla_masked, atol=5e-5)
    np.testing.assert_allclose(W_fused.sum(axis=1), 1.0, atol=1e-5)


def test_fold_in_fused_function_packed_matches_dense():
    """fold_in_fused: packed auto-dispatch is bit-identical to packed=False
    on exactly-binary data (the solve() packing contract, applied to the
    fold-in)."""
    from nbmf_mm_jax.models.serving import fold_in_fused

    rng = np.random.default_rng(7)
    H = rng.uniform(0.1, 0.9, (4, 200))
    X = (rng.random((140, 200)) < 0.4).astype(float)
    W_dense, s_dense = fold_in_fused(
        H, X, dtype="float32", interpret=True, packed=False
    )
    W_auto, s_auto = fold_in_fused(
        H, X, dtype="float32", interpret=True, packed=None
    )
    np.testing.assert_array_equal(W_dense, W_auto)
    np.testing.assert_array_equal(s_dense, s_auto)


def test_accepts_solver_result_device_handoff():
    """FoldInServer accepts a SolverResult; with device_results=True the
    handoff keeps H on-device (no host pull, asserted by identity of the
    underlying buffer dtype path) and serves identically to the numpy H."""
    import jax

    from nbmf_mm_jax import solve

    X = (np.random.default_rng(3).random((60, 40)) < 0.3).astype(float)
    res = solve(X, 4, max_iter=60, random_state=0, dtype="float32",
                device_results=True)
    assert isinstance(res.H, jax.Array)
    srv_dev = FoldInServer(res, buckets=(8,), dtype="float32")
    srv_np = FoldInServer(np.asarray(res.H), buckets=(8,), dtype="float32")
    Xnew = (np.random.default_rng(4).random((6, 40)) < 0.3).astype(float)
    W_dev, s_dev = srv_dev.transform(Xnew)
    W_np, s_np = srv_np.transform(Xnew)
    np.testing.assert_array_equal(W_dev, W_np)
    np.testing.assert_array_equal(s_dev, s_np)


def test_sparse_request_batches_match_dense(model):
    """scipy.sparse request batches densify per chunk and produce results
    identical to dense input — on both the XLA and fused-kernel paths,
    masked and unmasked, including chunking past the top bucket."""
    import scipy.sparse as sp

    rng = np.random.default_rng(11)
    Xnew = (rng.random((21, 40)) < 0.15).astype(float)
    mask = (rng.random((21, 40)) < 0.8).astype(float)
    S, M = sp.csr_matrix(Xnew), sp.csr_matrix(mask)
    for kw in (
        dict(backend="jnp"),
        dict(backend="pallas", pallas_interpret=True),
    ):
        srv = FoldInServer(model, buckets=(4, 8), **kw)
        Wd, sd = srv.transform(Xnew)
        Ws, ss = srv.transform(S)
        np.testing.assert_array_equal(Wd, Ws)
        np.testing.assert_array_equal(sd, ss)
        Wdm, sdm = srv.transform(Xnew, mask=mask)
        Wsm, ssm = srv.transform(S, mask=M)
        np.testing.assert_array_equal(Wdm, Wsm)
        np.testing.assert_array_equal(sdm, ssm)
    # empty sparse batch
    W0, s0 = srv.transform(sp.csr_matrix((0, 40)))
    assert W0.shape == (0, 4) and s0.shape == (0,)
