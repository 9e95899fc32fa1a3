"""Hypothesis property fuzzing of the solver invariants.

Randomized shapes/ranks/hyperparameters/sparsity/masks; every draw must keep
the core guarantees: monotone descent (corrected mode), simplex and box
constraints, finite losses, len(losses) == n_iter.  Deadlines are disabled
(first trace per shape compiles).
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from nbmf_mm_jax import solve


@st.composite
def problem(draw):
    m = draw(st.integers(4, 40))
    n = draw(st.integers(4, 40))
    k = draw(st.integers(1, 6))
    alpha = draw(st.floats(0.5, 3.0))
    beta = draw(st.floats(0.5, 3.0))
    p = draw(st.floats(0.05, 0.95))
    seed = draw(st.integers(0, 2**31 - 1))
    masked = draw(st.booleans())
    return m, n, k, alpha, beta, p, seed, masked


@given(problem())
@settings(max_examples=12, deadline=None, derandomize=True)
def test_solver_invariants_fuzz(args):
    m, n, k, alpha, beta, p, seed, masked = args
    rng = np.random.default_rng(seed)
    X = (rng.random((m, n)) < p).astype(float)
    mask = (rng.random((m, n)) < 0.9).astype(float) if masked else None
    r = solve(
        X, k, max_iter=25, tol=0.0, alpha=alpha, beta=beta,
        random_state=seed % 1000, mask=mask, mask_mode="corrected",
    )
    hist = np.asarray(r.losses)
    assert len(hist) == r.n_iter == 25
    assert np.all(np.isfinite(hist))
    assert np.all(np.diff(hist) <= 1e-10), f"ascent {np.diff(hist).max()}"
    np.testing.assert_allclose(r.W.sum(axis=1), 1.0, atol=1e-8)
    assert np.all((r.H > 0) & (r.H < 1))
    assert np.all(r.W >= 0)


@given(st.integers(0, 2**31 - 1), st.integers(1, 5))
@settings(max_examples=8, deadline=None, derandomize=True)
def test_duchi_projection_fuzz(seed, k):
    from nbmf_mm_jax.ops.projection import project_columns_simplex_duchi

    rng = np.random.default_rng(seed)
    X = rng.normal(scale=rng.uniform(0.1, 10), size=(k, 17))
    P = np.asarray(project_columns_simplex_duchi(X))
    np.testing.assert_allclose(P.sum(axis=0), 1.0, atol=1e-8)
    assert np.all(P >= 0)


def _fuzz_operands(args):
    """Padded kernel operands for a fuzz draw (f32, the kernels' blocks)."""
    import jax.numpy as jnp

    from nbmf_mm_jax.ops import pallas_sweep as ps

    m, n, k, alpha, beta, p, seed, masked = args
    rng = np.random.default_rng(seed)
    Mp, Np = ps.padded_dims(m, n)
    Yr = (rng.random((m, n)) < p).astype(np.float32)
    maskr = (rng.random((m, n)) < 0.8).astype(np.float32) if masked else None
    Ym = Yr * maskr if masked else Yr
    Ym2 = (1.0 - Yr) * maskr if masked else None
    pad = lambda A: None if A is None else jnp.asarray(ps.pad_to(A, Mp, Np))
    Wr = rng.uniform(0.1, 0.9, (k, m))
    Wr /= Wr.sum(0, keepdims=True)
    W = jnp.asarray(ps.pad_to(Wr.astype(np.float32), k, Mp))
    H = jnp.asarray(ps.pad_to(rng.uniform(0.1, 0.9, (k, n)).astype(np.float32), k, Np))
    return W, H, pad(Ym), pad(Ym2), (m, n)


@given(problem())
@settings(max_examples=8, deadline=None, derandomize=True)
def test_stripe_kernel_parity_fuzz(args):
    """Randomized shapes (any padding, k < 16 padded to the tensor-core
    minimum) through the fused kernels (interpret) must match the plain
    f64 formulas on the real region."""
    from nbmf_mm_jax.ops import pallas_sweep as ps

    W, H, Ymp, Ym2p, (m, n) = _fuzz_operands(args)
    Num, Den, ll = ps.hloss_terms(W, H, Ymp, None, m_real=m, n_real=n, interpret=True)
    T = ps.w_terms(W, H, Ymp, Ym2p, n_real=n, interpret=True)
    W64 = np.asarray(W, np.float64)[:, :m]
    H64 = np.asarray(H, np.float64)[:, :n]
    Ym = np.asarray(Ymp, np.float64)[:m, :n]
    Ym2 = (1.0 - Ym) if Ym2p is None else np.asarray(Ym2p, np.float64)[:m, :n]
    wh = W64.T @ H64
    a, b = wh + 1e-8, np.maximum(1.0 - wh, 0.0) + 1e-8
    np.testing.assert_allclose(np.asarray(Num)[:, :n], W64 @ (Ym / a), rtol=1e-4, atol=3e-5)
    np.testing.assert_allclose(np.asarray(Den)[:, :n], W64 @ ((1 - Ym) / b), rtol=1e-4, atol=3e-5)
    ll_ref = np.sum(Ym * np.log(a) + (1 - Ym) * np.log(b))
    assert abs(float(ll) - ll_ref) <= 1e-5 * abs(ll_ref) + 1e-3
    T_ref = H64 @ (Ym / a).T + (1 - H64) @ (Ym2 / b).T
    np.testing.assert_allclose(np.asarray(T)[:, :m], T_ref, rtol=1e-4, atol=3e-5)


@given(problem())
@settings(max_examples=8, deadline=None, derandomize=True)
def test_packed_kernel_bitwise_fuzz(args):
    """Randomized shapes through the kernels on packed words (interpret)
    must be BIT-IDENTICAL to the same kernels on dense data (one loader,
    the same arithmetic on exact 0/1 values)."""
    from nbmf_mm_jax.ops import pallas_sweep as ps

    W, H, Ymp, Ym2p, (m, n) = _fuzz_operands(args)
    Ypk = ps.pack_bits(Ymp)
    Ypk2 = ps.pack_bits(Ym2p) if Ym2p is not None else None
    kw = dict(m_real=m, n_real=n, interpret=True)

    # parity-mode hloss (complement in registers on both paths), then
    # corrected-mode hloss (explicit complement) when masked
    for yc, ycp in [(None, None)] + ([(Ym2p, Ypk2)] if Ym2p is not None else []):
        dense = ps.hloss_terms(W, H, Ymp, yc, **kw)
        packed = ps.hloss_terms(W, H, Ypk, ycp, packed=True, **kw)
        for d, q in zip(dense, packed):
            np.testing.assert_array_equal(np.asarray(d), np.asarray(q))
    T = ps.w_terms(W, H, Ymp, Ym2p, n_real=n, interpret=True)
    Tp = ps.w_terms(W, H, Ypk, Ypk2, n_real=n, packed=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(T), np.asarray(Tp))


@given(st.integers(0, 2**31 - 1), st.integers(2, 4))
@settings(max_examples=6, deadline=None, derandomize=True)
def test_return_all_consistency_fuzz(seed, n_init):
    """all_final_losses, all_W/all_H and the packaged best result must be
    mutually consistent for any seed/restart count."""
    rng = np.random.default_rng(seed)
    X = (rng.random((20, 15)) < 0.4).astype(float)
    r = solve(X, 3, max_iter=20, random_state=seed % 997, n_init=n_init,
              return_all=True)
    ex = r.extras
    assert ex["all_W"].shape == (n_init, 20, 3)
    best = int(np.argmin(r.all_final_losses))
    assert best == r.best_restart
    np.testing.assert_allclose(ex["all_W"][best], r.W, atol=1e-9)
    for i in range(n_init):
        np.testing.assert_allclose(ex["all_W"][i].sum(axis=1), 1.0, atol=1e-8)
        li = ex["all_losses"][i][: ex["all_n_iter"][i]]
        assert np.all(np.isfinite(li)) and np.all(np.diff(li) <= 1e-10)


@given(st.integers(0, 2**31 - 1), st.integers(1, 200), st.integers(1, 300))
@settings(max_examples=8, deadline=None, derandomize=True)
def test_host_pack_matches_device_pack_fuzz(seed, m, n):
    """pack_bits_host must produce bit-identical words to the device packer
    for every shape (rows not a multiple of 32 included), and unpack_bits
    must invert both."""
    import jax.numpy as jnp

    from nbmf_mm_jax.ops import pallas_sweep as ps

    rng = np.random.default_rng(seed)
    X = (rng.random((m, n)) < rng.uniform(0.1, 0.9)).astype(np.float32)
    host = ps.pack_bits_host(X)
    dev = np.asarray(ps.pack_bits(jnp.asarray(X)))
    np.testing.assert_array_equal(host, dev)
    np.testing.assert_array_equal(np.asarray(ps.unpack_bits(jnp.asarray(host)))[:m], X)
