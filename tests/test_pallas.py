"""Fused-kernel parity vs the XLA path (interpret mode on CPU, f32).

The compiled GPU execution of the same kernels is exercised by
chip_smoke.py and the gpu-marked tests; here we pin numerical equivalence
including padding (partial blocks), masking modes, projections, vmapped
restarts, the bitpacked word layout and the split-axis partial sums.
"""

import numpy as np
import pytest

from nbmf_mm_jax import solve

F32 = dict(dtype="float32")
PALLAS = dict(backend="pallas", pallas_interpret=True, block_m=64, block_n=64)


def _toy(m=70, n=50, p=0.3, seed=0):
    return (np.random.default_rng(seed).random((m, n)) < p).astype(float)


def _mask(shape, p=0.85, seed=1):
    return (np.random.default_rng(seed).random(shape) < p).astype(float)


def _compare(X, tol=2e-5, **kw):
    a = solve(X, 4, max_iter=15, random_state=0, backend="jnp", **F32, **kw)
    b = solve(X, 4, max_iter=15, random_state=0, **F32, **PALLAS, **kw)
    assert a.n_iter == b.n_iter
    np.testing.assert_allclose(a.W, b.W, atol=tol)
    np.testing.assert_allclose(a.H, b.H, atol=tol)
    np.testing.assert_allclose(a.losses, b.losses, atol=tol)


def test_pallas_parity_unmasked():
    _compare(_toy())


def test_pallas_parity_masked_parity_mode():
    X = _toy()
    _compare(X, mask=_mask(X.shape))


def test_pallas_parity_masked_corrected_mode():
    X = _toy()
    _compare(X, mask=_mask(X.shape), mask_mode="corrected")


def test_pallas_parity_duchi():
    _compare(_toy(), projection="duchi")


def test_pallas_parity_exact_block_multiple():
    # no padding at all: shapes are exact block multiples
    _compare(_toy(m=128, n=64))


def test_pallas_parity_dir_beta():
    _compare(_toy(), orientation="dir-beta")


def test_pallas_restarts_vmap():
    X = _toy(seed=3)
    a = solve(X, 3, max_iter=12, random_state=0, n_init=3, backend="jnp", **F32)
    b = solve(X, 3, max_iter=12, random_state=0, n_init=3, **F32, **PALLAS)
    assert a.best_restart == b.best_restart
    np.testing.assert_allclose(a.W, b.W, atol=2e-5)
    np.testing.assert_allclose(a.all_final_losses, b.all_final_losses, atol=2e-5)


def test_pallas_monotone_f32():
    X = _toy(seed=5)
    res = solve(X, 4, max_iter=40, random_state=0, **F32, **PALLAS)
    # f32 tolerance: the MM guarantee holds to rounding noise
    assert np.all(np.diff(res.losses) <= 1e-5)


def _compare_packed(X, **kw):
    """packed=True vs packed=False on the Pallas path must be bit-identical
    (select-form on exact 0/1 values; see ops/pallas_sweep.py)."""
    a = solve(X, 4, max_iter=15, random_state=0, packed=False, **F32, **PALLAS, **kw)
    b = solve(X, 4, max_iter=15, random_state=0, packed=True, **F32, **PALLAS, **kw)
    assert a.n_iter == b.n_iter
    np.testing.assert_array_equal(a.W, b.W)
    np.testing.assert_array_equal(a.H, b.H)
    np.testing.assert_array_equal(a.losses, b.losses)


def test_packed_bitwise_equal_unmasked():
    _compare_packed(_toy())


def test_packed_bitwise_equal_masked_parity():
    X = _toy()
    _compare_packed(X, mask=_mask(X.shape))


def test_packed_bitwise_equal_masked_corrected():
    X = _toy()
    _compare_packed(X, mask=_mask(X.shape), mask_mode="corrected")


def test_packed_bitwise_equal_duchi():
    _compare_packed(_toy(), projection="duchi")


def test_packed_restarts_vmap():
    X = _toy(seed=3)
    a = solve(X, 3, max_iter=12, random_state=0, n_init=3, packed=False, **F32, **PALLAS)
    b = solve(X, 3, max_iter=12, random_state=0, n_init=3, packed=True, **F32, **PALLAS)
    assert a.best_restart == b.best_restart
    np.testing.assert_array_equal(a.W, b.W)
    np.testing.assert_array_equal(a.all_final_losses, b.all_final_losses)


def test_packed_rejects_continuous_data():
    X = _toy()
    X[0, 0] = 0.5  # in [0,1] (valid input) but not exactly binary
    with pytest.raises(ValueError, match="packed=True requires"):
        solve(X, 4, max_iter=5, random_state=0, packed=True, **F32, **PALLAS)
    # auto mode falls back to the dense kernels and still matches XLA
    _compare(X)


def test_packed_rejects_continuous_mask():
    X = _toy()
    w = _mask(X.shape) * 0.7  # confidence-weighted mask: not binary
    with pytest.raises(ValueError, match="packed=True requires"):
        solve(X, 4, max_iter=5, random_state=0, mask=w, packed=True, **F32, **PALLAS)
    _compare(X, mask=w, mask_mode="corrected", tol=5e-5)


def test_pallas_mesh_n_init_supported():
    # mesh + pallas + restarts: vmapped inside the shard_map (full matrix in
    # tests/test_sharded_pallas.py); smoke-check the 2-device route here.
    import jax

    from nbmf_mm_jax.parallel.sharding import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    mesh = make_mesh(jax.devices()[:2], shape=(2, 1))
    res = solve(
        _toy(), 3, max_iter=10, random_state=0, n_init=2,
        backend="pallas", mesh=mesh, pallas_interpret=True,
        block_m=64, block_n=64, **F32,
    )
    assert res.all_final_losses.shape == (2,)
    assert np.isfinite(res.losses[-1])


def test_packed_true_rejects_non_pallas_backend():
    """packed=True is validated on EVERY routing, not just the Pallas one."""
    with pytest.raises(ValueError, match="packed=True requires the Pallas"):
        solve(_toy(), 4, max_iter=5, random_state=0, packed=True,
              backend="jnp", **F32)


def test_packed_true_rejects_bf16_mode():
    """Packing replaces the data stream, so combining it with an explicit
    bf16 data-storage request is contradictory."""
    with pytest.raises(ValueError, match="incompatible with dtype='bfloat16'"):
        solve(_toy(), 4, max_iter=5, random_state=0, packed=True,
              dtype="bfloat16", **PALLAS)


def test_bf16_mode_disables_auto_packing(monkeypatch):
    """dtype='bfloat16' is an explicit data-storage request; the packed auto
    rule must not silently override it (pack_bits must never run)."""
    from nbmf_mm_jax.ops import pallas_sweep as ps

    def _boom(*a, **k):
        raise AssertionError("pack_bits must not be called in bf16 mode")

    monkeypatch.setattr(ps, "pack_bits", _boom)
    r = solve(_toy(), 4, max_iter=5, random_state=0, dtype="bfloat16", **PALLAS)
    assert np.all(np.isfinite(r.losses))


def test_f32_auto_packing_engages(monkeypatch):
    """The auto rule (packed=None) does pack eligible binary f32 data —
    host inputs through the host packer, device inputs through the device
    packer."""
    import jax.numpy as jnp

    from nbmf_mm_jax.ops import pallas_sweep as ps

    calls = []
    for name in ("pack_bits", "pack_bits_host"):
        orig = getattr(ps, name)

        def _spy(A, _orig=orig, _name=name):
            calls.append(_name)
            return _orig(A)

        monkeypatch.setattr(ps, name, _spy)
    solve(_toy(), 4, max_iter=5, random_state=0, **F32, **PALLAS)
    assert "pack_bits_host" in calls, "host input did not host-pack"
    calls.clear()
    solve(jnp.asarray(_toy(), dtype=jnp.float32), 4, max_iter=5,
          random_state=0, **F32, **PALLAS)
    assert "pack_bits" in calls, "device input did not device-pack"


def test_host_and_device_inputs_bitwise_equal():
    """Host inputs are packed on the host and shipped as words; device
    inputs pack on-device — both must produce identical solves."""
    import jax.numpy as jnp

    X = _toy()
    mask = _mask(X.shape)
    for kw in ({}, dict(mask=mask)):
        a = solve(X, 4, max_iter=12, random_state=0, **F32, **PALLAS, **kw)
        dkw = {k: jnp.asarray(np.asarray(v, dtype=np.float32))
               for k, v in kw.items()}
        b = solve(jnp.asarray(np.asarray(X, dtype=np.float32)), 4,
                  max_iter=12, random_state=0, **F32, **PALLAS, **dkw)
        np.testing.assert_array_equal(a.W, b.W)
        np.testing.assert_array_equal(a.H, b.H)
        np.testing.assert_array_equal(a.losses, b.losses)


class TestPackedInput:
    """First-class PackedMatrix input: solve() on pre-packed words is
    bit-identical to solve() on the dense matrix it encodes (same kernels,
    same words), and the chunked packer reproduces the whole-matrix
    packing exactly."""

    def _toy(self, m=300, n=200, seed=11):
        return (np.random.default_rng(seed).random((m, n)) < 0.4).astype(float)

    def test_pack_matrix_roundtrip_and_chunked_equality(self):
        from nbmf_mm_jax import pack_matrix, pack_matrix_chunked

        Y = self._toy()
        pm = pack_matrix(Y)
        np.testing.assert_array_equal(np.asarray(pm.unpack()), Y)
        # chunked (host chunks; chunk_rows not a multiple of 32 gets rounded)
        pm2 = pack_matrix_chunked(lambda a, b: Y[a:b], *Y.shape, chunk_rows=100)
        np.testing.assert_array_equal(
            np.asarray(pm.words), np.asarray(pm2.words)
        )
        assert pm2.shape == (300, 200) and pm2.words.shape == (10, 200)
        # device chunks too
        import jax.numpy as jnp

        Yd = jnp.asarray(Y)
        pm3 = pack_matrix_chunked(
            lambda a, b: Yd[a:b], *Y.shape, chunk_rows=128, validate=False
        )
        np.testing.assert_array_equal(
            np.asarray(pm.words), np.asarray(pm3.words)
        )

    def test_solve_packed_input_bit_identical_to_dense(self):
        from nbmf_mm_jax import pack_matrix, solve

        Y = self._toy()
        kw = dict(
            max_iter=12, random_state=0, dtype="float32",
            backend="pallas", pallas_interpret=True,
        )
        dense = solve(Y, 4, **kw)  # auto-packs (binary + eligible)
        pm = pack_matrix(Y)
        packed = solve(pm, 4, **kw)
        np.testing.assert_array_equal(dense.W, packed.W)
        np.testing.assert_array_equal(dense.H, packed.H)
        np.testing.assert_array_equal(
            np.asarray(dense.losses), np.asarray(packed.losses)
        )

    def test_packed_input_contract_errors(self):
        from nbmf_mm_jax import pack_matrix, solve

        Y = self._toy(m=128, n=128)
        pm = pack_matrix(Y)
        kw = dict(backend="pallas", pallas_interpret=True)
        with pytest.raises(ValueError, match="beta-dir"):
            solve(pm, 3, orientation="dir-beta", **kw)
        with pytest.raises(ValueError, match="mask"):
            solve(pm, 3, mask=np.ones((128, 128)), **kw)
        with pytest.raises(ValueError, match="packed=False"):
            solve(pm, 3, packed=False, **kw)
        with pytest.raises(ValueError, match="float32"):
            solve(pm, 3, dtype="float64", **kw)
        with pytest.raises(ValueError, match="Pallas backend"):
            solve(pm, 3, backend="jnp")
        # words that do not encode the stated shape are caught
        from nbmf_mm_jax import PackedMatrix

        with pytest.raises(ValueError, match="PackedMatrix"):
            solve(PackedMatrix(words=pm.words, shape=(200, 128)), 3, **kw)
        with pytest.raises(ValueError, match="binary"):
            pack_matrix(Y + 0.5)

    def test_pack_matrix_sparse_matches_dense(self):
        """Sparse binary input packs bit-identically to the dense packer
        (and no full dense copy of the matrix is ever built — chunked)."""
        import scipy.sparse as sp

        from nbmf_mm_jax import pack_matrix, pack_matrix_sparse, solve

        Y = (np.random.default_rng(13).random((300, 200)) < 0.05).astype(
            np.float32
        )
        S = sp.csr_matrix(Y)
        pm_s = pack_matrix_sparse(S, chunk_rows=64)
        pm_d = pack_matrix(Y)
        np.testing.assert_array_equal(
            np.asarray(pm_s.words), np.asarray(pm_d.words)
        )
        assert pm_s.shape == (300, 200)
        # solves end-to-end like any PackedMatrix
        r = solve(pm_s, 4, max_iter=8, random_state=0, dtype="float32",
                  backend="pallas", pallas_interpret=True)
        assert np.all(np.isfinite(np.asarray(r.losses)))
        # contract errors
        with pytest.raises(ValueError, match="binary"):
            pack_matrix_sparse(sp.csr_matrix(Y * 3.0))
        with pytest.raises(TypeError, match="scipy.sparse"):
            pack_matrix_sparse(Y)
        # explicit stored zeros are legal (still exactly binary)
        S0 = S.copy().tolil()
        S0[0, 0] = 0.0  # explicit zero entry
        np.testing.assert_array_equal(
            np.asarray(pack_matrix_sparse(S0.tocsr()).words),
            np.asarray(pm_d.words),
        )
        # non-canonical duplicate entries SUM in the dense view (two stored
        # 1.0s at one position are dense 2.0) — must be rejected, not
        # silently packed as bit 1; and the input must not be mutated.
        Sd = sp.csr_matrix(
            (np.ones(2, np.float32), np.zeros(2, np.int32),
             np.array([0, 2] + [2] * 299, np.int32)),
            shape=(300, 200),
        )
        assert not Sd.has_canonical_format
        with pytest.raises(ValueError, match="binary"):
            pack_matrix_sparse(Sd)
        assert Sd.nnz == 2 and not Sd.has_canonical_format  # unmutated

    def test_solve_sparse_autoroutes_to_packed(self):
        """solve(scipy.sparse) on a packed-eligible routing is bit-identical
        to solve(dense) — the sparse matrix goes straight to bit-plane
        words; ineligible routings densify (same results as dense input)."""
        import scipy.sparse as sp

        from nbmf_mm_jax import solve

        Y = (np.random.default_rng(7).random((300, 200)) < 0.08).astype(
            np.float32
        )
        S = sp.csr_matrix(Y)
        kw = dict(
            max_iter=10, random_state=3, dtype="float32",
            backend="pallas", pallas_interpret=True,
        )
        dense = solve(Y, 4, **kw)
        sparse = solve(S, 4, **kw)
        np.testing.assert_array_equal(dense.W, sparse.W)
        np.testing.assert_array_equal(dense.H, sparse.H)
        # packed=True on the sparse route enforces the binaryness contract
        with pytest.raises(ValueError, match="binary"):
            solve(S * 3.0, 4, packed=True, **kw)
        # ineligible routing (mask) densifies and still matches dense input
        mask = (np.random.default_rng(8).random(Y.shape) < 0.9).astype(
            np.float32
        )
        dm = solve(Y, 4, mask=mask, **kw)
        sm = solve(S, 4, mask=mask, **kw)
        np.testing.assert_allclose(sm.W, dm.W, rtol=0, atol=0)
        # f64 jnp routing (CPU parity regime) densifies too
        d64 = solve(Y.astype(np.float64), 4, max_iter=10, random_state=3)
        s64 = solve(S, 4, max_iter=10, random_state=3)
        np.testing.assert_array_equal(d64.W, s64.W)


class TestWTermsCancellation:
    """Regression for the W-pass cancellation identity (round-3 hardware
    stress find): ``(1-H) @ Q.T`` must NOT be rewritten as
    ``colsum(Q) - H @ Q.T``.  The identity is exact in real arithmetic but
    q reaches ~1/eps ~ 1e8 wherever wh -> 1 on a Y=0 entry, and the two
    separately rounded 1e8-magnitude sums cancel to absolute errors far
    above the true result (negative T -> negative W -> NaN losses on the
    chip).  The two-matmul form keeps every product and partial sum >= 0,
    so T >= 0 holds structurally in ANY floating-point evaluation order.
    """

    K, M, N = 8, 128, 128  # exact block multiples: no padding interplay

    def _case(self):
        # Engineered worst case: H == 1.0 exactly on even columns makes
        # wh == 1 (f32) there, so b == eps and q == 1/eps ~ 1e8 on the
        # Y=0 entries of those columns; odd columns keep moderate values
        # so T also carries ordinary-magnitude structure.
        rng = np.random.default_rng(7)
        W = rng.uniform(0.1, 0.9, (self.K, self.M)).astype(np.float32)
        W /= W.sum(axis=0, keepdims=True)
        H = rng.uniform(0.1, 0.9, (self.K, self.N)).astype(np.float32)
        H[:, ::2] = 1.0
        Y = (rng.random((self.M, self.N)) < 0.3).astype(np.float32)
        Y[:, ::2] = 0.0
        return W, H, Y

    @staticmethod
    def _terms(W, H, Y, eps=1e-8):
        """The per-entry P/Q operands in float64 (kernel's shared-reciprocal
        form; see w_terms in ops/pallas_sweep.py)."""
        wh = W.T.astype(np.float64) @ H.astype(np.float64)
        a = wh + eps
        b = np.maximum(1.0 - wh, 0.0) + eps
        r = 1.0 / (a * b)
        p = Y * (b * r)
        q = (1.0 - Y) * (a * r)
        return p, q

    def test_case_defeats_the_rank1_identity(self):
        # Sanity that the case has teeth: the retired one-matmul form,
        # evaluated in plain f32 (kinder rounding than the MXU's bf16x3),
        # already yields large negative entries where the truth is >= 0.
        W, H, Y = self._case()
        p, q = self._terms(W, H, Y)
        t_old = H.astype(np.float32) @ (p - q).astype(np.float32).T + q.astype(
            np.float32
        ).sum(axis=1)[None, :]
        t_true = H.astype(np.float64) @ p.T + (1.0 - H.astype(np.float64)) @ q.T
        assert t_true.min() >= 0.0
        assert t_old.min() < -1.0  # catastrophic, not last-ulp, cancellation

    @pytest.mark.parametrize("variant", ["dense", "dense_unsplit", "packed"])
    def test_kernels_stay_nonnegative_and_accurate(self, variant, monkeypatch):
        from nbmf_mm_jax.ops import pallas_sweep as ps
        from nbmf_mm_jax.ops.pallas_sweep import pack_bits, w_terms

        W, H, Y = self._case()
        p, q = self._terms(W, H, Y)
        t_true = H.astype(np.float64) @ p.T + (1.0 - H.astype(np.float64)) @ q.T

        packed = variant == "packed"
        if variant == "dense_unsplit":
            monkeypatch.setattr(ps, "_TARGET_PROGRAMS", 1)
        t = w_terms(
            W, H, pack_bits(Y) if packed else Y, n_real=self.N, packed=packed,
            block_n=64, interpret=True,
        )
        t = np.asarray(t)
        assert t.min() >= 0.0
        # Entries reach ~(1/eps)*N ~ 1e10; f32 agreement is relative.
        np.testing.assert_allclose(t, t_true, rtol=5e-5, atol=1e-4)


def test_precision_plumbing_all_paths():
    """solve/grid/fold-in accept explicit matmul precision on the fused
    path (threaded into every kernel dot_general).  On CPU all tiers
    compute identical f32 products, so explicit precision must reproduce
    the default bit-for-bit; the GPU tiers are pinned in
    tests/test_gpu.py and compared with the reference by chip_smoke.py."""
    X = _toy()
    kw = dict(max_iter=10, random_state=0, **F32, **PALLAS)
    a = solve(X, 4, **kw)
    for prec in ("default", "highest"):
        b = solve(X, 4, precision=prec, **kw)
        np.testing.assert_array_equal(a.W, b.W)
        np.testing.assert_array_equal(np.asarray(a.losses), np.asarray(b.losses))

    from nbmf_mm_jax.models.serving import fold_in_fused
    from nbmf_mm_jax.parallel.grid import grid_solve

    g = grid_solve(X, 3, [1.5], [2.0], max_iter=5, backend="pallas",
                   pallas_interpret=True, precision="highest")
    assert np.all(np.isfinite(g["final_loss"]))
    W1, _ = fold_in_fused(a.H, X, n_iter=5, interpret=True)
    W2, _ = fold_in_fused(a.H, X, n_iter=5, interpret=True,
                          kernel_precision="highest")
    np.testing.assert_array_equal(W1, W2)


class TestEstimatorPackedAndSparse:
    """NBMF.fit accepts PackedMatrix and scipy.sparse inputs, matching the
    dense fit bit-for-bit on every routing (solver_options forwards the
    interpret/tile knobs to solve)."""

    def test_fit_matches_dense_on_all_input_kinds(self):
        import scipy.sparse as sp

        from nbmf_mm_jax import NBMF, pack_matrix

        Y = (np.random.default_rng(21).random((300, 200)) < 0.1).astype(
            np.float32
        )
        opts = dict(
            n_components=4, max_iter=10, random_state=5, dtype="float32",
            backend="pallas", solver_options={"pallas_interpret": True},
        )
        md = NBMF(**opts).fit(Y)
        ms = NBMF(**opts).fit(sp.csr_matrix(Y))
        mp = NBMF(**opts).fit(pack_matrix(Y))
        for m in (ms, mp):
            np.testing.assert_array_equal(md.W_, m.W_)
            np.testing.assert_array_equal(md.components_, m.components_)
            np.testing.assert_array_equal(
                np.asarray(md.loss_curve_), np.asarray(m.loss_curve_)
            )
            assert m.n_iter_ == md.n_iter_

    def test_fit_sparse_f64_matches_dense(self):
        """Ineligible routing (f64 CPU default): sparse densifies inside
        solve and the fit is bit-identical to dense input."""
        import scipy.sparse as sp

        from nbmf_mm_jax import NBMF

        Y = (np.random.default_rng(22).random((60, 40)) < 0.3).astype(float)
        md = NBMF(n_components=3, max_iter=15, random_state=1).fit(Y)
        ms = NBMF(n_components=3, max_iter=15, random_state=1).fit(
            sp.csr_matrix(Y)
        )
        np.testing.assert_array_equal(md.W_, ms.W_)
        np.testing.assert_array_equal(md.components_, ms.components_)

    def test_fit_input_contract_errors(self):
        import scipy.sparse as sp

        from nbmf_mm_jax import NBMF, pack_matrix

        Y = (np.random.default_rng(23).random((128, 128)) < 0.2).astype(
            np.float32
        )
        with pytest.raises(ValueError, match="binary"):
            NBMF(n_components=3).fit(sp.csr_matrix(Y * 2.0))
        pm = pack_matrix(Y)
        with pytest.raises(ValueError, match="mask"):
            NBMF(
                n_components=3, dtype="float32", backend="pallas",
                solver_options={"pallas_interpret": True},
            ).fit(pm, mask=np.ones_like(Y))


class TestSparseMaskedPacked:
    """Sparse Y + sparse mask pack both operands straight from the sparse
    structures (Ym = Y*mask, Ym2 = mask - Ym) — bit-identical to the dense
    masked solve on the same routing; ineligible cases densify."""

    def _data(self, m=300, n=200, seed=31):
        rng = np.random.default_rng(seed)
        Y = (rng.random((m, n)) < 0.1).astype(np.float32)
        mask = (rng.random((m, n)) < 0.5).astype(np.float32)
        return Y, mask

    @pytest.mark.parametrize("mask_mode", ["parity", "corrected"])
    def test_bit_identical_to_dense(self, mask_mode):
        import scipy.sparse as sp

        from nbmf_mm_jax import solve

        Y, mask = self._data()
        kw = dict(
            max_iter=10, random_state=2, dtype="float32", mask_mode=mask_mode,
            backend="pallas", pallas_interpret=True,
        )
        dense = solve(Y, 4, mask=mask, **kw)
        sparse = solve(sp.csr_matrix(Y), 4, mask=sp.csr_matrix(mask), **kw)
        np.testing.assert_array_equal(dense.W, sparse.W)
        np.testing.assert_array_equal(dense.H, sparse.H)
        np.testing.assert_array_equal(
            np.asarray(dense.losses), np.asarray(sparse.losses)
        )
        assert dense.n_iter == sparse.n_iter

    def test_restarts_and_estimator(self):
        import scipy.sparse as sp

        from nbmf_mm_jax import NBMF, solve

        Y, mask = self._data(seed=32)
        kw = dict(
            max_iter=8, random_state=0, dtype="float32",
            backend="pallas", pallas_interpret=True,
        )
        d = solve(Y, 3, mask=mask, n_init=3, **kw)
        s = solve(sp.csr_matrix(Y), 3, mask=sp.csr_matrix(mask), n_init=3, **kw)
        assert d.best_restart == s.best_restart
        np.testing.assert_array_equal(d.W, s.W)
        md = NBMF(n_components=3, max_iter=8, random_state=0, dtype="float32",
                  backend="pallas",
                  solver_options={"pallas_interpret": True})
        ms = NBMF(n_components=3, max_iter=8, random_state=0, dtype="float32",
                  backend="pallas",
                  solver_options={"pallas_interpret": True})
        md.fit(Y, mask=mask)
        ms.fit(sp.csr_matrix(Y), mask=sp.csr_matrix(mask))
        np.testing.assert_array_equal(md.W_, ms.W_)

    def test_ineligible_and_contract(self):
        import scipy.sparse as sp

        from nbmf_mm_jax import solve

        Y, mask = self._data(seed=33)
        kw = dict(
            max_iter=6, random_state=1, dtype="float32",
            backend="pallas", pallas_interpret=True,
        )
        S, M = sp.csr_matrix(Y), sp.csr_matrix(mask)
        # continuous (non-binary) sparse mask: densify fallback matches dense
        Mw = M * 0.5
        d = solve(Y, 3, mask=mask * 0.5, mask_mode="corrected", **kw)
        s = solve(S, 3, mask=Mw, mask_mode="corrected", **kw)
        np.testing.assert_array_equal(d.W, s.W)
        # packed=True + non-binary sparse mask raises
        with pytest.raises(ValueError, match="binary"):
            solve(S, 3, mask=Mw, packed=True, **kw)
        # all-zero sparse mask is rejected like a dense all-zero mask
        with pytest.raises(ValueError, match="no observed entries"):
            solve(S, 3, mask=sp.csr_matrix(Y.shape, dtype=np.float32), **kw)
        # sparse Y + DENSE mask keeps the existing dense-staging path
        d2 = solve(Y, 3, mask=mask, **kw)
        s2 = solve(S, 3, mask=mask, **kw)
        np.testing.assert_array_equal(d2.W, s2.W)

    def test_packed_true_wide_masked_sparse_packs(self):
        """packed=True on a wide masked sparse problem (no shape is too wide
        for the kernels: they loop over blocks) packs both operands from the
        sparse structures and matches the dense masked solve bit for bit."""
        import scipy.sparse as sp

        from nbmf_mm_jax import solve

        rng = np.random.default_rng(3)
        Y = (rng.random((40, 3000)) < 0.01).astype(np.float32)
        M = np.maximum((rng.random((40, 3000)) < 0.2), Y > 0).astype(np.float32)
        kw = dict(max_iter=3, random_state=0, dtype="float32",
                  backend="pallas", pallas_interpret=True, packed=True)
        dense = solve(Y, 3, mask=M, **kw)
        sparse = solve(sp.csr_matrix(Y), 3, mask=sp.csr_matrix(M), **kw)
        np.testing.assert_array_equal(dense.W, sparse.W)
        np.testing.assert_array_equal(dense.H, sparse.H)

    def test_warm_start_and_checkpoint_compose_with_packed_input(self):
        """W_init/H_init warm starts and segmented checkpointed fits work on
        PackedMatrix and sparse inputs just like dense (same routing)."""
        import scipy.sparse as sp

        from nbmf_mm_jax import NBMF, pack_matrix, solve
        from nbmf_mm_jax.utils.checkpoint import fit_checkpointed

        Y = (np.random.default_rng(41).random((300, 200)) < 0.1).astype(
            np.float32
        )
        pm = pack_matrix(Y)
        kw = dict(max_iter=6, random_state=0, dtype="float32",
                  backend="pallas", pallas_interpret=True)
        first = solve(pm, 4, **kw)
        dense_first = solve(Y, 4, **kw)
        # warm-start continuation on the packed input == dense continuation
        cont_p = solve(pm, 4, W_init=first.W, H_init=first.H, **kw)
        cont_d = solve(Y, 4, W_init=dense_first.W, H_init=dense_first.H, **kw)
        np.testing.assert_array_equal(cont_p.W, cont_d.W)
        np.testing.assert_array_equal(cont_p.H, cont_d.H)
        # segmented checkpointed fit accepts sparse input end-to-end
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            m1 = NBMF(n_components=4, max_iter=9, random_state=0,
                      dtype="float32", backend="pallas",
                      solver_options={"pallas_interpret": True})
            fitted = fit_checkpointed(
                m1, sp.csr_matrix(Y), td + "/ck.npz", every=4
            )
            assert fitted.n_iter_ <= 9
            assert np.all(np.isfinite(fitted.loss_curve_))
            assert np.all(np.diff(np.asarray(fitted.loss_curve_)) <= 1e-5)

    def test_pack_sparse_words_chunk_boundaries_bit_equal(self):
        """pack_sparse_words must be bit-identical to pack_bits_host on the
        padded dense equivalent for ANY chunking — including chunk sizes
        that split the matrix mid-way —
        for both the plain and complement forms."""
        import scipy.sparse as sp

        from nbmf_mm_jax.ops import pallas_sweep as ps
        from nbmf_mm_jax.ops.packed import pack_sparse_words

        rng = np.random.default_rng(61)
        for m, n, Mp, Np in [
            (300, 200, 384, 256),
            (400, 130, 512, 256),
            (100, 50, 128, 128),    # single chunk, heavy padding
        ]:
            Y = (rng.random((m, n)) < 0.1).astype(np.float32)
            S = sp.csr_matrix(Y)
            dense = np.zeros((Mp, Np), dtype=np.uint8)
            dense[:m, :n] = Y
            comp = np.zeros((Mp, Np), dtype=np.uint8)
            comp[:m, :n] = 1 - Y[:m, :n]
            for chunk_rows in (None, 96, 256):
                w = pack_sparse_words(S, Mp, Np, chunk_rows=chunk_rows)
                np.testing.assert_array_equal(
                    w, ps.pack_bits_host(dense),
                    err_msg=f"{(m, n, Mp, Np, chunk_rows)}",
                )
                wc = pack_sparse_words(
                    S, Mp, Np, complement=True, chunk_rows=chunk_rows
                )
                np.testing.assert_array_equal(
                    wc, ps.pack_bits_host(comp),
                    err_msg=f"complement {(m, n, Mp, Np, chunk_rows)}",
                )

    def test_sparse_device_results_stays_on_device(self):
        """solve(sparse, device_results=True) composes: factors come back
        as device arrays (ready for FoldInServer handoff), bit-identical
        to the dense solve's."""
        import jax
        import scipy.sparse as sp

        from nbmf_mm_jax import solve

        Y = (np.random.default_rng(71).random((300, 200)) < 0.08).astype(
            np.float32
        )
        kw = dict(max_iter=8, random_state=1, dtype="float32",
                  backend="pallas", pallas_interpret=True)
        d = solve(Y, 4, **kw)
        s = solve(sp.csr_matrix(Y), 4, device_results=True, **kw)
        assert isinstance(s.W, jax.Array) and isinstance(s.H, jax.Array)
        np.testing.assert_array_equal(d.W, np.asarray(s.W))
        np.testing.assert_array_equal(d.H, np.asarray(s.H))


def test_artifact_configs_stay_pack_eligible():
    """Every shape the launchers run (chip_smoke.py, bench.py,
    experiments/flagship_scale.py) pads to rows that are a multiple of 32
    (so the words cover them exactly) and to a multiple of each pass's
    power-of-two blocks."""
    from nbmf_mm_jax.ops import pallas_sweep as ps

    for M, N in [(10_000, 10_000), (100_000, 10_000), (400_000, 10_000),
                 (1_000_000, 10_000), (8_192, 10_000), (4_096, 10_000)]:
        Mp, Np = ps.padded_dims(M, N)
        assert Mp % 32 == 0 and Mp - M < 128 and Np - N < 64, (M, N)
        for bm, bn, _, _ in (ps.HLOSS_BLOCKS, ps.W_BLOCKS):
            assert Mp % ps.block_size(Mp, bm) == 0
            assert Np % ps.block_size(Np, bn) == 0


# --------------------------------------------------------------------------
# Kernel-level cases: each pass against the plain reference, the word
# layout, block padding, the split-axis partial sums, and kernel routing.


def _kernel_case(m=90, n=70, k=5, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    Y = (rng.random((m, n)) < 0.3).astype(np.float32)
    mask = (rng.random((m, n)) < 0.8).astype(np.float32) if masked else None
    W = rng.uniform(0.1, 0.9, (k, m)).astype(np.float32)
    W /= W.sum(axis=0, keepdims=True)
    H = rng.uniform(0.1, 0.9, (k, n)).astype(np.float32)
    return Y, mask, W, H


def _padded_operands(Y, mask, W, H, mode):
    """Pad to the kernels' blocks; return the kernel operands plus the
    XLA-reference operands (ops.updates.precompute_masked_terms)."""
    import jax.numpy as jnp

    from nbmf_mm_jax.ops import pallas_sweep as ps
    from nbmf_mm_jax.ops.updates import precompute_masked_terms

    m, n = Y.shape
    Mp, Np = ps.padded_dims(m, n)
    Ym, Ym2, Yc = precompute_masked_terms(
        jnp.asarray(Y), None if mask is None else jnp.asarray(mask), mode
    )
    pad = lambda A: ps.pad_to(A, Mp, Np)
    ops = dict(
        W=ps.pad_to(jnp.asarray(W), W.shape[0], Mp),
        H=ps.pad_to(jnp.asarray(H), H.shape[0], Np),
        Ym=pad(Ym),
        Ym2=None if mask is None else pad(Ym2),
        Yc=pad(Yc) if (mask is not None and mode == "corrected") else None,
    )
    return ops, (Ym, Ym2, Yc)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("mode", ["unmasked", "parity", "corrected"])
def test_hloss_pass_matches_reference(packed, mode):
    """H+loss pass (interpret) vs the plain f64 reference formulas of
    ops/updates.py on the real region, for dense and packed loaders."""
    from nbmf_mm_jax.ops import pallas_sweep as ps

    Y, mask, W, H = _kernel_case(masked=mode != "unmasked", seed=1)
    ops, (Ym, _, Yc) = _padded_operands(Y, mask, W, H, "parity" if mode == "unmasked" else mode)
    pk = ps.pack_bits if packed else (lambda A: A)
    m, n = Y.shape
    Num, Den, ll = ps.hloss_terms(
        ops["W"], ops["H"], pk(ops["Ym"]),
        None if ops["Yc"] is None else pk(ops["Yc"]),
        m_real=m, n_real=n, packed=packed, interpret=True,
    )
    wh = W.T.astype(np.float64) @ H.astype(np.float64)
    a, b = wh + 1e-8, np.maximum(1 - wh, 0) + 1e-8
    Ym, Yc = np.asarray(Ym, np.float64), np.asarray(Yc, np.float64)
    np.testing.assert_allclose(np.asarray(Num)[:, :n], W @ (Ym / a), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(Den)[:, :n], W @ (Yc / b), rtol=2e-5)
    ll_ref = np.sum(Ym * np.log(a) + Yc * np.log(b))
    np.testing.assert_allclose(float(ll), ll_ref, rtol=2e-6)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_w_pass_matches_reference(packed, masked):
    """W pass (interpret) vs the plain f64 reference of ops/updates.py."""
    from nbmf_mm_jax.ops import pallas_sweep as ps

    Y, mask, W, H = _kernel_case(masked=masked, seed=2)
    ops, (Ym, Ym2, _) = _padded_operands(Y, mask, W, H, "parity")
    pk = ps.pack_bits if packed else (lambda A: A)
    m, n = Y.shape
    T = ps.w_terms(
        ops["W"], ops["H"], pk(ops["Ym"]),
        None if ops["Ym2"] is None else pk(ops["Ym2"]),
        n_real=n, packed=packed, interpret=True,
    )
    wh = W.T.astype(np.float64) @ H.astype(np.float64)
    a, b = wh + 1e-8, np.maximum(1 - wh, 0) + 1e-8
    Ym, Ym2 = np.asarray(Ym, np.float64), np.asarray(Ym2, np.float64)
    T_ref = H @ (Ym / a).T + (1 - H) @ (Ym2 / b).T
    np.testing.assert_allclose(np.asarray(T)[:, :m], T_ref, rtol=2e-5)


@pytest.mark.parametrize("m,n", [(32, 7), (95, 33), (128, 64), (1, 1)])
def test_pack_layout_round_trip(m, n):
    """Word row w, bit b holds data row 32w + b: the device packer, the host
    packer and the sparse packer give the same words, and unpacking
    inverts them (rows beyond m unpack as zeros)."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from nbmf_mm_jax.ops import pallas_sweep as ps
    from nbmf_mm_jax.ops.packed import pack_sparse_words

    Y = (np.random.default_rng(m * n).random((m, n)) < 0.4).astype(np.float32)
    host = ps.pack_bits_host(Y)
    assert host.shape == (-(-m // 32), n) and host.dtype == np.int32
    np.testing.assert_array_equal(np.asarray(ps.pack_bits(jnp.asarray(Y))), host)
    Mp = host.shape[0] * 32
    np.testing.assert_array_equal(pack_sparse_words(sp.csr_matrix(Y), Mp, n), host)
    back = np.asarray(ps.unpack_bits(jnp.asarray(host)))
    np.testing.assert_array_equal(back[:m], Y)
    assert not back[m:].any()
    # bit b of word row w is data row 32w + b
    r = int(np.argmax(Y[:, 0])) if Y[:, 0].any() else None
    if r is not None:
        assert (int(host[r // 32, 0]) >> (r % 32)) & 1 == 1


@pytest.mark.parametrize(
    "m,n,block_m,block_n,want",
    [
        (10_000, 10_000, None, None, (10_112, 10_048)),
        (70, 50, None, None, (128, 64)),
        (70, 50, 64, 64, (128, 64)),
        (5, 3, None, None, (32, 32)),
        (300, 200, 48, 100, (320, 256)),  # blocks round up to powers of two
    ],
)
def test_padding_to_power_of_two_blocks(m, n, block_m, block_n, want):
    from nbmf_mm_jax.ops import pallas_sweep as ps

    assert ps.padded_dims(m, n, block_m, block_n) == want
    Mp, Np = want
    for b in (block_m or 64, block_m or 128):
        bs = ps.block_size(Mp, b)
        assert bs & (bs - 1) == 0 and bs >= 32 and Mp % bs == 0


@pytest.mark.parametrize(
    "precision,stages",
    [(None, 3), ("default", 3), ("highest", 2), (("highest", "highest"), 2)],
)
def test_pass_config_stages_follow_precision(precision, stages):
    """The W pass pipelines three stages at TF32 and two with IEEE f32
    products, whose larger tiles would exceed a block's shared memory."""
    import jax

    from nbmf_mm_jax.ops import pallas_sweep as ps

    prec = (
        tuple(jax.lax.Precision(p) for p in precision)
        if isinstance(precision, tuple)
        else None if precision is None else jax.lax.Precision(precision)
    )
    bm, bn, params = ps._config(10_112, 10_048, None, None, prec, ps.W_BLOCKS)
    assert (bm, bn, params.num_warps, params.num_stages) == (128, 64, 8, stages)
    _, _, hparams = ps._config(10_112, 10_048, None, None, prec, ps.HLOSS_BLOCKS)
    assert hparams.num_stages == 2


@pytest.mark.parametrize("target,n_split", [(10, 2), (20, 4), (30, 4), (80, 7)])
def test_split_axis_partial_sums(target, n_split, monkeypatch):
    """Splitting the loop axis over a second grid dimension and adding the
    partials in XLA gives the unsplit results to f32 rounding, for both
    passes (small blocks give several loop blocks to split; the split
    count follows the program target)."""
    import jax.numpy as jnp

    from nbmf_mm_jax.ops import pallas_sweep as ps

    Y, _, W, H = _kernel_case(m=200, n=150, k=4, seed=3)
    Mp, Np = ps.padded_dims(200, 150, 32, 32)  # (224, 160): 7 x 5 blocks
    Wp = ps.pad_to(jnp.asarray(W), 4, Mp)
    Hp = ps.pad_to(jnp.asarray(H), 4, Np)
    Yp = ps.pad_to(jnp.asarray(Y), Mp, Np)
    kw = dict(block_m=32, block_n=32, interpret=True)
    monkeypatch.setattr(ps, "_TARGET_PROGRAMS", 1)
    assert ps._split(5, 7) == (1, 7)
    ref = ps.hloss_terms(Wp, Hp, Yp, m_real=200, n_real=150, **kw)
    T1 = ps.w_terms(Wp, Hp, Yp, n_real=150, **kw)
    monkeypatch.setattr(ps, "_TARGET_PROGRAMS", target)
    assert ps._split(5, 7)[0] == n_split  # no split left empty
    got = ps.hloss_terms(Wp, Hp, Yp, m_real=200, n_real=150, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5)
    Ts = ps.w_terms(Wp, Hp, Yp, n_real=150, **kw)
    np.testing.assert_allclose(np.asarray(Ts), np.asarray(T1), rtol=1e-5)


@pytest.mark.parametrize(
    "platform,dtype,precision,want",
    [
        ("gpu", "float32", None, True),
        ("gpu", "bfloat16", "default", True),
        ("gpu", "float64", None, False),
        ("gpu", "float32", "highest", False),
        ("cpu", "float32", None, False),
        ("METAL", "float32", None, False),
    ],
)
def test_resolve_backend_picks_kernels_only_on_gpu(monkeypatch, platform, dtype, precision, want):
    import jax

    from nbmf_mm_jax.solver.driver import _resolve_backend

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert _resolve_backend("auto", dtype, precision) is want
    assert _resolve_backend("pallas", dtype, precision) is True
    assert _resolve_backend("jnp", dtype, precision) is False
    with pytest.raises(ValueError, match="backend must be"):
        _resolve_backend("mosaic", dtype)
