"""GPU tests (marked ``gpu``; they skip without a GPU).  Run them on the
card with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q``.

The default suite runs on the CPU backend (conftest.py); these tests
verify the device path end to end on the GPU: auto-selected fused kernels,
f32 monotone descent, bf16 data mode, fused-vs-XLA parity on the device,
precision tiers, serving, and a 10^9-entry packed fit.  Whether a GPU is
present is decided inside the ``gpu`` fixture, never at import, so every
test-runner worker collects the same tests.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend")


def _toy(m=160, n=120, p=0.3, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < p).astype(float)


def test_gpu_fit_monotone_f32(gpu):
    from nbmf_mm_jax import NBMF

    m = NBMF(n_components=6, max_iter=40, dtype="float32", random_state=0).fit(_toy())
    # TF32 products: descent holds to the rounding band of the products
    assert np.all(np.diff(m.loss_curve_) <= 1e-4)
    np.testing.assert_allclose(m.W_.sum(axis=1), 1.0, atol=1e-5)


def test_gpu_fused_vs_xla_parity(gpu):
    from nbmf_mm_jax import solve

    X = _toy(seed=2)
    a = solve(X, 4, max_iter=20, random_state=0, dtype="float32", backend="jnp")
    b = solve(X, 4, max_iter=20, random_state=0, dtype="float32", backend="pallas")
    np.testing.assert_allclose(a.losses, b.losses, atol=5e-4)
    np.testing.assert_allclose(a.W, b.W, atol=5e-3)


def test_gpu_bf16_mode(gpu):
    from nbmf_mm_jax import solve

    X = _toy(seed=3)
    f = solve(X, 4, max_iter=20, random_state=0, dtype="float32")
    b = solve(X, 4, max_iter=20, random_state=0, dtype="bfloat16")
    assert np.all(np.diff(b.losses) <= 1e-4)
    np.testing.assert_allclose(f.losses, b.losses, atol=5e-3)


def test_gpu_auto_backend_takes_fused_path(gpu):
    """'auto' routes fits and grids through the fused kernels on the GPU."""
    from nbmf_mm_jax.parallel.grid import grid_solve
    from nbmf_mm_jax.solver.driver import _resolve_backend

    assert _resolve_backend("auto", np.float32) is True
    X = _toy(seed=4)
    g_auto = grid_solve(X, 3, [1.0, 1.5], [1.0], max_iter=10,
                        random_state=0, dtype="float32")
    g_pallas = grid_solve(X, 3, [1.0, 1.5], [1.0], max_iter=10,
                          random_state=0, dtype="float32", backend="pallas")
    np.testing.assert_array_equal(g_auto["losses"], g_pallas["losses"])
    assert np.all(np.isfinite(g_auto["final_loss"]))


def test_gpu_serving_fused_path(gpu):
    from nbmf_mm_jax import NBMF
    from nbmf_mm_jax.models.serving import FoldInServer

    X = _toy(seed=5)
    model = NBMF(n_components=4, max_iter=60, dtype="float32", random_state=0).fit(X)
    srv = FoldInServer(model, buckets=(256,), dtype="float32")
    assert srv._use_pallas
    W, s = srv.transform(_toy(m=100, seed=6))
    assert W.shape == (100, 4) and np.all(np.isfinite(s))
    np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-5)


def test_gpu_flagship_1e9_packed_descent(gpu):
    """A >= 10^9-entry solve through PackedMatrix input (the data never
    exists dense anywhere) stays finite and monotone."""
    import jax
    import jax.numpy as jnp

    from nbmf_mm_jax import pack_matrix_chunked, solve

    M, N, K = 100_000, 10_000, 128
    key = jax.random.PRNGKey(0)

    def row_chunk(a, b):
        k2 = jax.random.fold_in(key, a)
        return jax.random.bernoulli(k2, 0.3, (b - a, N)).astype(jnp.float32)

    pm = pack_matrix_chunked(row_chunk, M, N, validate=False)
    assert M * N >= 10**9 and pm.nbytes <= (M * N) // 8 + 4 * N
    res = solve(pm, K, max_iter=12, tol=0.0, random_state=0)
    losses = np.asarray(res.losses)
    assert len(losses) == 12 and np.all(np.isfinite(losses))
    assert np.max(np.diff(losses)) <= 1e-4
    assert np.all(np.isfinite(res.W)) and np.all(np.isfinite(res.H))
    np.testing.assert_allclose(res.W.sum(axis=1), 1.0, atol=1e-4)


def test_gpu_precision_tiers(gpu):
    """DEFAULT (TF32 products) keeps descent within the TF32 band;
    precision="highest" (IEEE f32 products in the kernels) tracks the
    HIGHEST XLA path closely."""
    from nbmf_mm_jax import solve

    rng = np.random.default_rng(56)
    Y = (rng.random((25, 5)) < 0.25).astype(float)
    mask = (rng.random((25, 5)) < 0.55).astype(float)
    kw = dict(max_iter=15, tol=0.0, alpha=2.04, beta=3.03, mask=mask,
              random_state=0, orientation="dir-beta", dtype="float32")

    lo = solve(Y, 1, backend="pallas", **kw)
    hi = solve(Y, 1, backend="pallas", precision="highest", **kw)
    ref = solve(Y, 1, backend="jnp", **kw)  # jnp default = HIGHEST

    assert np.max(np.diff(np.asarray(lo.losses))) <= 2e-3
    assert np.max(np.diff(np.asarray(hi.losses))) <= 1e-4
    np.testing.assert_allclose(hi.losses, ref.losses, atol=2e-5)
    np.testing.assert_allclose(hi.W, ref.W, atol=2e-4)
