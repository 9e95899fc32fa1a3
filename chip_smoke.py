#!/usr/bin/env python3
"""End-to-end smoke test of nbmf_mm_jax on one NVIDIA GPU at full width.

    python chip_smoke.py               # phases 0-6 on one card
    python chip_smoke.py --four-cards  # only the four-card mesh phase

Phases (any failure raises, and the exit code is non-zero):

0. device check: JAX must run on a GPU; prints the card's name and power
   limit, its device kind and the XLA flags in effect;
1. main path: ``NBMF(n_components=128).fit`` on a seeded 10^4 x 10^4
   Bernoulli(0.3) matrix through ``backend="auto"``;
2. masked completion at the same width, 90 % observed, parity and
   corrected modes;
3. fold-in: ``model.transform`` on 4,096 new rows and
   ``FoldInServer(model).transform`` on an 8,192-row batch;
4. a packed 10^5 x 10^4 (10^9-entry) fit from ``pack_matrix_chunked``;
5. each fused pass compiled for the card against the plain reference
   (``ops/updates.py``, f32 at HIGHEST), dense and packed;
6. steady sweeps/s of the fused loop (dense and packed) and of the XLA loop
   at DEFAULT and HIGHEST (informational).

With ``--four-cards`` only the mesh phase runs: a GSPMD solve and a
shard_map solve on a 2 x 2 mesh of four cards, each against the same solve
on one card.  The last line of standard output is one JSON object naming the
device as JAX reports it.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

M = N = 10_000
K = 128
SWEEPS = 50
MF = 100_000  # rows of the packed 10^9-entry fit


def log(msg):
    print(msg, flush=True)


def check_fit(name, losses, W, H, *, band=1e-4):
    """Finite losses, MM descent within ``band`` (TF32 products leave the
    descent exact only up to their rounding), simplex rows of W within
    1e-5, and H strictly inside (0, 1)."""
    losses = np.asarray(losses, dtype=np.float64)
    W, H = np.asarray(W), np.asarray(H)
    assert losses.size and np.all(np.isfinite(losses)), f"{name}: non-finite losses"
    rise = float(np.max(np.diff(losses))) if losses.size > 1 else 0.0
    assert rise <= band, f"{name}: loss rose by {rise:.3g} (> {band})"
    dev = float(np.max(np.abs(W.sum(axis=1) - 1.0)))
    assert dev <= 1e-5, f"{name}: W rows off the simplex by {dev:.3g}"
    assert np.all((H > 0) & (H < 1)), f"{name}: H leaves (0, 1)"
    log(f"[{name}] ok: {losses.size} sweeps, loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}, max rise {rise:.3g}, simplex dev {dev:.3g}")


def peak_gib(jax):
    from nbmf_mm_jax.utils.profiling import device_memory_stats

    return device_memory_stats().get("peak_bytes_in_use", 0) / 2**30


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def phase_main(jax, V):
    from nbmf_mm_jax import NBMF
    from nbmf_mm_jax.solver.driver import _resolve_backend

    fused = _resolve_backend("auto", np.float32)
    log(f"[1 main] route: {'fused kernels, packed words' if fused else 'XLA'} "
        "(backend='auto', binary data)")
    assert fused, "backend='auto' must reach the fused kernels on the GPU"
    kw = dict(n_components=K, dtype="float32", max_iter=SWEEPS, tol=0, random_state=0)
    t0 = time.perf_counter()
    model = NBMF(**kw).fit(V)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    NBMF(**kw).fit(V)  # same shapes: compiled programs are reused
    warm = time.perf_counter() - t0
    check_fit("1 main", model.loss_curve_, model.W_, model.components_)
    log(f"[1 main] wall {cold:.3f} s cold, {warm:.3f} s warm; compile ~"
        f"{cold - warm:.3f} s; {SWEEPS / warm:.2f} sweeps/s end to end "
        f"(host staging and retrieval included); peak {peak_gib(jax):.2f} GiB")
    return model


def phase_masked(jax, V):
    from nbmf_mm_jax import NBMF

    mask = (np.random.default_rng(1).random(V.shape) < 0.9).astype(np.float32)
    for mode in ("parity", "corrected"):
        t0 = time.perf_counter()
        m = NBMF(n_components=K, dtype="float32", max_iter=SWEEPS, tol=0,
                 random_state=0, mask_mode=mode).fit(V, mask=mask)
        dt = time.perf_counter() - t0
        check_fit(f"2 masked {mode}", m.loss_curve_, m.W_, m.components_)
        log(f"[2 masked {mode}] wall {dt:.3f} s (compile included); "
            f"peak {peak_gib(jax):.2f} GiB")


def phase_fold_in(jax, model):
    from nbmf_mm_jax.models.serving import FoldInServer

    rng = np.random.default_rng(2)
    X = (rng.random((4096, N)) < 0.3).astype(np.float32)
    t0 = time.perf_counter()
    W = model.transform(X)
    dt = time.perf_counter() - t0
    assert W.shape == (4096, K) and np.all(np.isfinite(W))
    dev = float(np.max(np.abs(W.sum(axis=1) - 1.0)))
    assert dev <= 1e-5 and np.all(W >= 0), f"transform rows off the simplex ({dev:.3g})"
    log(f"[3 fold-in] transform 4096 rows: {dt:.3f} s (compile included), "
        f"simplex dev {dev:.3g}")
    X = (rng.random((8192, N)) < 0.3).astype(np.float32)
    srv = FoldInServer(model)
    assert srv._use_pallas, "FoldInServer must serve through the fused kernel"
    t0 = time.perf_counter()
    W, scores = srv.transform(X)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    W, scores = srv.transform(X)
    warm = time.perf_counter() - t0
    dev = float(np.max(np.abs(W.sum(axis=1) - 1.0)))
    assert W.shape == (8192, K) and dev <= 1e-5, f"server rows off the simplex ({dev:.3g})"
    assert np.all(np.isfinite(scores)) and np.all(scores <= 0)
    log(f"[3 fold-in] FoldInServer 8192 rows: {cold:.3f} s cold, {warm:.3f} s "
        f"warm, mean row log-lik {float(np.mean(scores)):.6f}")


def phase_packed_1e9(jax):
    import jax.numpy as jnp

    from nbmf_mm_jax import pack_matrix_chunked, solve

    Mf = MF
    key = jax.random.PRNGKey(0)

    def row_chunk(a, b):
        return jax.random.bernoulli(jax.random.fold_in(key, a), 0.3, (b - a, N)).astype(
            jnp.float32
        )

    t0 = time.perf_counter()
    pm = pack_matrix_chunked(row_chunk, Mf, N, validate=False)
    jax.block_until_ready(pm.words)
    t_pack = time.perf_counter() - t0
    assert pm.nbytes <= Mf * N // 8 + 4 * N  # 32 entries per int32 word
    t0 = time.perf_counter()
    res = solve(pm, K, max_iter=12, tol=0.0, random_state=0)
    dt = time.perf_counter() - t0
    assert len(res.losses) == 12
    check_fit("4 packed 1e9", res.losses, res.W, res.H)
    log(f"[4 packed 1e9] {Mf}x{N} ({Mf * N:.3g} entries): pack {t_pack:.3f} s, words "
        f"{pm.nbytes / 2**20:.1f} MiB, solve {dt:.3f} s for 12 sweeps "
        f"(compile included); peak {peak_gib(jax):.2f} GiB")


def phase_parity(jax):
    import jax.numpy as jnp

    from nbmf_mm_jax.ops import pallas_sweep as ps
    from nbmf_mm_jax.ops.updates import h_contractions, log_likelihood, w_contraction

    HI = jax.lax.Precision.HIGHEST
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    Y = jax.random.bernoulli(k1, 0.3, (M, N)).astype(jnp.float32)
    W = jax.random.uniform(k2, (K, M), minval=0.1, maxval=0.9)
    W = W / W.sum(axis=0)
    H = jax.random.uniform(k3, (K, N), minval=0.1, maxval=0.9)
    ref = jax.jit(lambda W, H, Y: (
        *h_contractions(W, H, Y, 1.0 - Y, 1e-8, HI),
        log_likelihood(W, H, Y, 1.0 - Y, 1e-8, HI),
        w_contraction(W, H, Y, 1.0 - Y, 1e-8, HI),
    ))(W, H, Y)
    Mp, Np = ps.padded_dims(M, N)
    Wp, Hp, Yp = ps.pad_to(W, K, Mp), ps.pad_to(H, K, Np), ps.pad_to(Y, Mp, Np)
    words = jax.jit(ps.pack_bits)(Yp)

    def fused(data, packed, precision):
        Num, Den, ll = jax.jit(lambda W, H, D: ps.hloss_terms(
            W, H, D, m_real=M, n_real=N, packed=packed, precision=precision))(Wp, Hp, data)
        T = jax.jit(lambda W, H, D: ps.w_terms(
            W, H, D, n_real=N, packed=packed, precision=precision))(Wp, Hp, data)
        return Num[:, :N], Den[:, :N], ll, T[:, :M]

    # HIGHEST: IEEE f32 products, so only the summation order differs from
    # the reference -> 1e-5 relative.  DEFAULT: TF32 products keep about 10
    # mantissa bits, summed over 10^4 terms -> 2e-3 relative.
    for prec, tol in ((HI, 1e-5), (None, 2e-3)):
        name = "HIGHEST" if prec is not None else "DEFAULT(TF32)"
        dense = fused(Yp, False, prec)
        packed = fused(words, True, prec)
        errs = [rel_err(a, b) for a, b in zip(dense, ref)]
        log(f"[5 parity {name}] Num {errs[0]:.3g} Den {errs[1]:.3g} ll {errs[2]:.3g} "
            f"T {errs[3]:.3g} (relative, limit {tol:g})")
        assert max(errs) <= tol, f"{name}: fused passes off the reference"
        # Packed words must be bit-identical to dense data: the same
        # arithmetic runs on exact 0/1 values.
        for a, b, nm in zip(packed, dense, ("Num", "Den", "ll", "T")):
            assert np.array_equal(np.asarray(a), np.asarray(b)), f"{name}: packed {nm} != dense"
        log(f"[5 parity {name}] packed == dense bit for bit")


def phase_timing(jax):
    import jax.numpy as jnp

    from nbmf_mm_jax.ops import pallas_sweep as ps
    from nbmf_mm_jax.solver.driver import _solve_core, _solve_core_pallas

    rng = np.random.default_rng(0)
    Y = jnp.asarray(rng.random((M, N)) < 0.3, dtype=jnp.float32)
    W0 = jnp.asarray(rng.uniform(0.1, 0.9, (K, M)), dtype=jnp.float32)
    W0 = W0 / W0.sum(axis=0, keepdims=True)
    H0 = jnp.asarray(rng.uniform(0.1, 0.9, (K, N)), dtype=jnp.float32)
    f32 = lambda x: jnp.asarray(x, dtype=jnp.float32)
    hyp = (f32(1.2), f32(1.2), f32(0.0))
    Mp, Np = ps.padded_dims(M, N)
    W0p, H0p, Yp = ps.pad_to(W0, K, Mp), ps.pad_to(H0, K, Np), ps.pad_to(Y, Mp, Np)
    words = jax.jit(ps.pack_bits)(Yp)
    pkw = dict(max_iter=SWEEPS, projection="normalize", verbose=0, eps=1e-8,
               m_real=M, n_real=N, block_m=None, block_n=None)
    xkw = dict(max_iter=SWEEPS, projection="normalize", verbose=0)
    variants = {
        "fused dense f32": lambda: _solve_core_pallas(
            Yp, None, None, W0p, H0p, *hyp, f32(M * N), **pkw),
        "fused packed": lambda: _solve_core_pallas(
            words, None, None, W0p, H0p, *hyp, f32(M * N), packed=True, **pkw),
        "XLA DEFAULT": lambda: _solve_core(
            Y, 1.0 - Y, 1.0 - Y, W0, H0, *hyp, f32(1e-8), f32(M * N), f32(N),
            precision=jax.lax.Precision.DEFAULT, **xkw),
        "XLA HIGHEST": lambda: _solve_core(
            Y, 1.0 - Y, 1.0 - Y, W0, H0, *hyp, f32(1e-8), f32(M * N), f32(N),
            precision=jax.lax.Precision.HIGHEST, **xkw),
    }
    for name, run in variants.items():
        out = run()
        float(out[4])  # compile and finish
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            out = run()
            float(out[4])
            best = min(best, time.perf_counter() - t0)
        losses = np.asarray(out[2])
        assert int(out[3]) == SWEEPS and np.all(np.isfinite(losses))
        log(f"[6 timing] {name}: {SWEEPS / best:.2f} sweeps/s "
            f"({1e3 * best / SWEEPS:.3f} ms/sweep over a {SWEEPS}-sweep solve), "
            f"final loss {float(losses[-1]):.6f}")


def phase_four_cards(jax, V):
    from nbmf_mm_jax import solve
    from nbmf_mm_jax.parallel.sharding import make_mesh

    devices = jax.devices()
    assert len(devices) >= 4, f"--four-cards needs 4 GPUs, JAX sees {len(devices)}"
    mesh = make_mesh(devices[:4], shape=(2, 2))
    kw = dict(dtype="float32", max_iter=30, tol=0, precision="highest", random_state=0)
    t0 = time.perf_counter()
    one = solve(V, K, **kw)
    log(f"[7 four cards] one card (XLA HIGHEST): {time.perf_counter() - t0:.3f} s")
    check_fit("7 one card", one.losses, one.W, one.H)
    for route, extra in (("GSPMD", {}), ("shard_map fused", {"backend": "pallas"})):
        t0 = time.perf_counter()
        res = solve(V, K, mesh=mesh, **kw, **extra)
        dt = time.perf_counter() - t0
        check_fit(f"7 {route}", res.losses, res.W, res.H)
        dW = float(np.max(np.abs(np.asarray(res.W) - one.W)))
        dH = float(np.max(np.abs(np.asarray(res.H) - one.H)))
        dl = float(np.max(np.abs(np.asarray(res.losses) - np.asarray(one.losses))))
        log(f"[7 four cards] {route} on a 2x2 mesh: {dt:.3f} s (compile "
            f"included); max |dW| {dW:.3g}, |dH| {dH:.3g}, |dloss| {dl:.3g} vs one card")
        assert max(dW, dH) <= 1e-4, f"{route}: factors differ from one card"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args()

    import jax

    from nbmf_mm_jax.utils.cache import enable_compilation_cache
    from nbmf_mm_jax.utils.profiling import gpu_card, require_gpu

    devices = require_gpu()  # phase 0: never runs on the CPU
    enable_compilation_cache()
    log(f"[0 device] {gpu_card()}")
    log(f"[0 device] JAX {jax.__version__}: {len(devices)} x {devices[0].device_kind}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")

    V = (np.random.default_rng(0).random((M, N)) < 0.3).astype(np.float32)
    if args.four_cards:
        phase_four_cards(jax, V)
    else:
        model = phase_main(jax, V)
        phase_masked(jax, V)
        phase_fold_in(jax, model)
        phase_packed_1e9(jax)
        phase_parity(jax)
        phase_timing(jax)
    devices = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)


if __name__ == "__main__":
    main()
