#!/usr/bin/env python
"""Headline benchmark: MM sweep throughput at M=N=10^4, K=128 on one GPU,
versus the reference's NumPy/BLAS CPU implementation (f64, as the
reference's sklearn validation forces — `_base.py:83`).

Prints ONE JSON line:
  {"metric": ..., "value": sweeps/s, "unit": "sweeps/s", "vs_baseline": ratio}
and exits non-zero when JAX finds no GPU.

The measured unit of work is one full solver iteration — H update, W update,
objective, convergence test — executed inside the compiled `lax.while_loop`
(tol=0 so no early exit), i.e. exactly what `NBMF.fit` runs per iteration.

The headline `value` is the path `backend="auto"` takes for binary f32 data
(`solver.driver._resolve_backend`): on the GPU, the fused kernels on packed
words.  NBMF_BENCH_FULL=1 adds the dense and bf16-data fused variants and
the XLA path at DEFAULT and HIGHEST.

Baseline: a from-scratch NumPy expression of the same sweep+loss math (f64),
measured at full size on the host.  Set NBMF_BENCH_PROBE_BASELINE=1 to use a
fast 2500x2500 probe scaled linearly instead (optimistic for NumPy, i.e.
conservative for the ratio).

Timing: each variant runs at TWO sweep counts and the reported rate is the
SLOPE — (t_hi - t_lo) / (hi - lo) — which cancels the per-solve constant
(dispatch, the final loss pass).  Completion is forced by pulling a scalar
result to the host.
"""

import json
import os
import sys
import time

import numpy as np

M = N = int(os.environ.get("NBMF_BENCH_MN", 10000))
K = int(os.environ.get("NBMF_BENCH_K", 128))
SWEEPS = int(os.environ.get("NBMF_BENCH_SWEEPS", 50))
PROBE = 2500
# Default run: headline + full-size NumPy baseline.  NBMF_BENCH_FULL=1 adds
# the dense/bf16 fused and the XLA variants.
FULL = os.environ.get("NBMF_BENCH_FULL") == "1"


def numpy_baseline_sweep_seconds(full: bool = True) -> float:
    """Reference-equivalent NumPy sweep+loss (f64), seconds per sweep at MxN."""
    eps, a, b = 1e-8, 1.2, 1.2
    size = M if full else PROBE

    rng = np.random.default_rng(0)
    Y = (rng.random((size, size)) < 0.3).astype(np.float64)
    W = rng.uniform(0.1, 0.9, (K, size))
    W /= W.sum(0, keepdims=True)
    H = rng.uniform(0.1, 0.9, (K, size))

    def sweep(W, H):
        WH = W.T @ H
        num = H * (W @ (Y / (WH + eps))) + (a - 1)
        den = (1 - H) * (W @ ((1 - Y) / (1 - WH + eps))) + (b - 1)
        Hn = np.clip(num / (num + den + eps), eps, 1 - eps)
        WHn = W.T @ Hn
        T = Hn @ (Y / (WHn + eps)).T + (1 - Hn) @ ((1 - Y) / (1 - WHn + eps)).T
        Wn = W * T / size
        Wn /= Wn.sum(0, keepdims=True)
        WH2 = Wn.T @ Hn
        ll = (Y * np.log(WH2 + eps) + (1 - Y) * np.log(1 - WH2 + eps)).sum()
        loss = -(ll + (a - 1) * np.log(Hn + eps).sum() + (b - 1) * np.log(1 - Hn + eps).sum()) / Y.size
        return Wn, Hn, loss

    sweep(W, H)  # warm BLAS
    reps = 1 if full else 2
    t0 = time.perf_counter()
    for _ in range(reps):
        W, H, _ = sweep(W, H)
    dt = (time.perf_counter() - t0) / reps
    if not full:
        dt *= (M * N) / (PROBE * PROBE)  # linear scaling (conservative)
    return dt


def _time_variant(fn, args, kw):
    """Slope-based steady-state timing with forced host sync.

    Times the compiled solver at SWEEPS and 3*SWEEPS iterations and reports
    the per-sweep slope (cancels the per-solve constant).  Primary
    estimator: MEDIAN of 5 per-round pairwise slopes.  If the median comes
    out non-positive (sweeps too fast for the timing noise), fall back to a
    min-per-count slope over more repeats, and raise rather than report a
    bogus number if even that is non-positive.  Returns (sweeps_per_sec,
    losses) and validates MM descent on the long run.
    """
    import statistics

    def sync(out):
        # Works for the single-init (scalar final loss) and the vmapped
        # n_init-batched cores ((b,) final losses) alike.
        return float(np.asarray(out[4]).sum())

    lo, hi = SWEEPS, 3 * SWEEPS
    kw_lo = dict(kw, max_iter=lo)
    kw_hi = dict(kw, max_iter=hi)
    out = fn(*args, **kw_lo)
    sync(out)  # materialize => device completed (compile lo)
    out = fn(*args, **kw_hi)
    sync(out)  # compile hi

    slopes = []
    for _ in range(5):
        t0 = time.perf_counter()
        r = fn(*args, **kw_lo)
        sync(r)
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = fn(*args, **kw_hi)
        sync(out)
        t_hi = time.perf_counter() - t0
        slopes.append((t_hi - t_lo) / (hi - lo))
    slope = statistics.median(slopes)
    if slope <= 0:
        t_lo = t_hi = np.inf
        for _ in range(6):
            t0 = time.perf_counter()
            r = fn(*args, **kw_lo)
            sync(r)
            t_lo = min(t_lo, time.perf_counter() - t0)
            t0 = time.perf_counter()
            out = fn(*args, **kw_hi)
            sync(out)
            t_hi = min(t_hi, time.perf_counter() - t0)
        slope = (t_hi - t_lo) / (hi - lo)
    if slope <= 0:
        raise RuntimeError(
            f"non-positive timing slope ({slope:.3g}s/sweep): dispatch "
            "variance exceeds the sweep time at this problem size — raise "
            "NBMF_BENCH_MN/NBMF_BENCH_SWEEPS"
        )
    losses = np.asarray(out[2], dtype=np.float64)
    if not np.all(np.asarray(out[3]) == hi):
        raise RuntimeError(f"bench ran {np.asarray(out[3])} sweeps, expected {hi}")
    if not np.all(np.isfinite(losses)):
        raise RuntimeError("non-finite losses in bench run")
    if not np.all(np.diff(losses, axis=-1) <= 1e-4):
        raise RuntimeError("MM descent violated in bench run")
    return 1.0 / slope, losses


def main():
    import jax
    import jax.numpy as jnp

    from nbmf_mm_jax import pack_matrix_chunked
    from nbmf_mm_jax.ops import pallas_sweep as ps
    from nbmf_mm_jax.ops.updates import precompute_masked_terms
    from nbmf_mm_jax.solver.driver import (
        _resolve_backend,
        _solve_core,
        _solve_core_pallas,
    )
    from nbmf_mm_jax.utils import enable_compilation_cache
    from nbmf_mm_jax.utils.profiling import gpu_card, require_gpu

    dev = require_gpu()[0]
    card = gpu_card()
    sys.stderr.write(f"bench: {card}\n")
    enable_compilation_cache()
    rng = np.random.default_rng(0)
    Y = jnp.asarray((rng.random((M, N)) < 0.3), dtype=jnp.float32)
    W0 = jnp.asarray(rng.uniform(0.1, 0.9, (K, M)), dtype=jnp.float32)
    W0 = W0 / W0.sum(axis=0, keepdims=True)
    H0 = jnp.asarray(rng.uniform(0.1, 0.9, (K, N)), dtype=jnp.float32)
    f32 = lambda x: jnp.asarray(x, dtype=jnp.float32)
    hyp = (f32(1.2), f32(1.2), f32(0.0))

    results = {}
    fused = _resolve_backend("auto", jnp.float32)
    Mp, Np = ps.padded_dims(M, N)
    W0p, H0p = ps.pad_to(W0, K, Mp), ps.pad_to(H0, K, Np)
    pkw = dict(max_iter=SWEEPS, projection="normalize", verbose=0, eps=1e-8,
               m_real=M, n_real=N, block_m=None, block_n=None)
    Yp = ps.pad_to(Y, Mp, Np)

    if fused:
        # Headline = the library's default fit path on binary data: the
        # fused kernels on packed words (solve() packs; bit-identical math).
        Ypk = jax.jit(ps.pack_bits)(Yp)
        pargs = (Ypk, None, None, W0p, H0p, *hyp, f32(M * N))
        results["pallas_f32"], losses = _time_variant(
            _solve_core_pallas, pargs, dict(pkw, packed=True)
        )

        # Batched-restart throughput: the whole compiled loop vmapped over
        # B16 restarts sharing one packed data stream, reported as AGGREGATE
        # restart-sweeps/s.
        B16 = int(os.environ.get("NBMF_BENCH_NINIT", 16))
        if B16 > 0:
            from functools import partial as _partial

            kb_w, kb_h = jax.random.split(jax.random.PRNGKey(123))
            W16 = jax.random.uniform(kb_w, (B16, K, M), jnp.float32, 0.1, 0.9)
            W16 = jnp.pad(W16 / W16.sum(axis=1, keepdims=True),
                          ((0, 0), (0, 0), (0, Mp - M)))
            H16 = jnp.pad(
                jax.random.uniform(kb_h, (B16, K, N), jnp.float32, 0.1, 0.9),
                ((0, 0), (0, 0), (0, Np - N)),
            )

            def run16(*a, max_iter):
                core = _partial(
                    _solve_core_pallas, **dict(pkw, packed=True, max_iter=max_iter)
                )
                return jax.vmap(
                    core, in_axes=(None, None, None, 0, 0, None, None, None, None),
                )(*a)

            rate16, _ = _time_variant(run16, (Ypk, None, None, W16, H16) + pargs[5:], {})
            results["n_init16"] = rate16 * B16
            del W16, H16

        if FULL:
            dargs = (Yp,) + pargs[1:]
            results["pallas_f32_dense"], _ = _time_variant(_solve_core_pallas, dargs, pkw)
            results["pallas_bf16"], _ = _time_variant(
                _solve_core_pallas, (Yp.astype(jnp.bfloat16),) + pargs[1:], pkw
            )

        if os.environ.get("NBMF_BENCH_FLAGSHIP", "1") == "1" and M == 10000:
            # Flagship scale: 10^5 x 10^4 = 10^9 entries, packed (125 MB of
            # words vs 4 GB dense f32), generated on the device.
            Mf = 100_000
            Mfp, _ = ps.padded_dims(Mf, N)
            kf = jax.random.PRNGKey(7)
            Wf = jax.random.uniform(jax.random.fold_in(kf, 1), (K, Mf), jnp.float32, 0.1, 0.9)
            Wf = ps.pad_to(Wf / Wf.sum(axis=0, keepdims=True), K, Mfp)
            Hf = H0p
            pm = pack_matrix_chunked(
                lambda a, b: jax.random.bernoulli(jax.random.fold_in(kf, a), 0.3, (b - a, N)),
                Mf, N, validate=False,
            )
            words = ps.pad_to(pm.words, Mfp // ps.WORD_BITS, Np)
            fargs = (words, None, None, Wf, Hf, *hyp, f32(Mf * N))
            fkw = dict(pkw, packed=True, m_real=Mf)
            lo_hi = (6, 26)
            times = {c: np.inf for c in lo_hi}
            for c in lo_hi:  # compile both counts
                float(np.asarray(_solve_core_pallas(*fargs, **dict(fkw, max_iter=c))[4]))
            for _ in range(3):
                for c in lo_hi:
                    t0 = time.perf_counter()
                    float(np.asarray(_solve_core_pallas(*fargs, **dict(fkw, max_iter=c))[4]))
                    times[c] = min(times[c], time.perf_counter() - t0)
            f_slope = (times[lo_hi[1]] - times[lo_hi[0]]) / (lo_hi[1] - lo_hi[0])
            results["flagship_1e9_ms_per_sweep"] = 1000 * f_slope
            del fargs, Wf, words, pm

    if not fused or FULL:
        Ym, Ym2, Yc = precompute_masked_terms(Y, None)
        jargs = (Ym, Ym2, Yc, W0, H0, *hyp, f32(1e-8), f32(M * N), f32(N))
        for name, prec in (("xla_f32", jax.lax.Precision.HIGHEST),
                           ("xla_f32_default", jax.lax.Precision.DEFAULT)):
            jkw = dict(max_iter=SWEEPS, projection="normalize", precision=prec, verbose=0)
            results[name], xla_losses = _time_variant(_solve_core, jargs, jkw)
            if not fused and name == "xla_f32":
                losses = xla_losses

    headline = results.get("pallas_f32", results.get("xla_f32"))
    base_dt = numpy_baseline_sweep_seconds(
        full=os.environ.get("NBMF_BENCH_PROBE_BASELINE") != "1"
    )
    baseline_sweeps_per_sec = 1.0 / base_dt

    print(json.dumps({
        "metric": f"mm_sweeps_per_sec_M{M}_N{N}_K{K}_f32",
        "value": round(headline, 3),
        "unit": "sweeps/s",
        "vs_baseline": round(headline / baseline_sweeps_per_sec, 2),
        "baseline_sweeps_per_sec": round(baseline_sweeps_per_sec, 5),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "final_loss": float(losses[-1]),
        **{k: round(v, 3) for k, v in results.items()},
    }))


if __name__ == "__main__":
    sys.exit(main())
