#!/usr/bin/env python
"""Flagship-scale single-device artifact: converged bitpacked solves at
>= 10^9 entries on one GPU, recorded to ``outputs/flagship_scale_gpu.csv``.

Bitpacking cuts the data stream AND the data's device footprint 32x; this
script makes that scale story a reproducible artifact:

- data is synthesized on the device in row chunks from a known low-rank
  Bernoulli ground truth and packed chunk by chunk
  (:func:`nbmf_mm_jax.pack_matrix_chunked`) — no dense copy of the matrix
  ever exists anywhere (host or device), so the solvable size is set by the
  PACKED footprint;
- each config runs ``solve(PackedMatrix, ..., device_results=True)`` to
  convergence twice (the first run pays the compile; the second is timed),
  recording throughput, the full descent check, the final objective against
  the generator's oracle NLL, and the device allocator's peak memory.

``device_results=True`` makes ``solve_s`` the DEVICE solve time: the
factors stay on the device and the ``W`` pull is timed separately as
``retrieve_s``.  Every row names the card and its power limit.

Usage (on a GPU host)::

    python experiments/flagship_scale.py             # headline 1e9 config
    python experiments/flagship_scale.py --ceiling   # + memory-ceiling probes

The reference cannot run at these sizes at all (single-process NumPy with
~6 dense (m, n) temporaries per sweep, ``src/nbmf_mm/_solver.py:22-57``).
"""

from __future__ import annotations

import argparse
import csv
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

OUT = Path(__file__).resolve().parent.parent / "outputs" / "flagship_scale_gpu.csv"

CARD = None  # the card's name and power limit (nvidia-smi), set in main()

# (name, M, N, K, K_true, max_iter)
CONFIGS = [
    ("headline_1e9", 100_000, 10_000, 128, 16, 300),
]
CEILING = [
    # Larger M at the same (k, N) geometry: the packed data grows linearly
    # in M while the dense equivalent outgrows device memory (4e9 entries =
    # 16 GB dense f32 vs 0.5 GB packed).  Iteration budgets sized to
    # CONVERGE (tol=1e-5), so these rows are quality claims.
    ("ceiling_4e9", 400_000, 10_000, 64, 16, 600),
    ("ceiling_1e10", 1_000_000, 10_000, 32, 16, 800),
]
# (name, M, N, K, density, max_iter) — scipy.sparse host ingestion.
# The row's point is ingestion throughput, but the budget is still sized
# to CONVERGE (tol=1e-5) so the CSV carries no converged=False rows
# (headline geometry converges < 300; unstructured 3 % noise is quicker).
SPARSE = [
    ("sparse_3pct_1e9", 100_000, 10_000, 128, 0.03, 600),
]


def synth_packed(key, M, N, K_true, K_solve):
    """Chunked on-device synthesis: Y ~ Bernoulli(W* @ H*) packed as it is
    generated; also accumulates the oracle per-entry NLL of Y under the
    ground-truth P* (the quality floor an ideal rank-K_true model attains).
    """
    import jax
    import jax.numpy as jnp

    from nbmf_mm_jax import pack_matrix_chunked

    kw, kh, kb = jax.random.split(key, 3)
    Wt = jax.random.uniform(kw, (M, K_true), jnp.float32, 0.05, 1.0)
    Wt = Wt / Wt.sum(axis=1, keepdims=True)
    Ht = jax.random.uniform(kh, (K_true, N), jnp.float32, 0.05, 0.95)

    ll_sum = [0.0]

    @jax.jit
    def make_chunk(Wc, seed):
        P = jnp.clip(Wc @ Ht, 1e-6, 1.0 - 1e-6)
        Y = jax.random.bernoulli(jax.random.fold_in(kb, seed), P).astype(
            jnp.float32
        )
        ll = jnp.sum(Y * jnp.log(P) + (1.0 - Y) * jnp.log1p(-P))
        return Y, ll

    def row_chunk(a, b):
        Y, ll = make_chunk(Wt[a:b], a)
        ll_sum[0] += float(ll)
        return Y

    pm = pack_matrix_chunked(
        row_chunk, M, N, chunk_rows=(1 << 27) // N, validate=False
    )
    return pm, -ll_sum[0] / (M * N)


def peak_gb():
    """The device allocator's peak bytes in use, in GiB."""
    from nbmf_mm_jax.utils.profiling import device_memory_stats

    return round(device_memory_stats()["peak_bytes_in_use"] / 2**30, 3)


def run_config(name, M, N, K, K_true, max_iter, writer, f):
    import jax

    print(f"[{name}] synthesizing {M}x{N} (K_true={K_true}) packed ...", flush=True)
    t0 = time.perf_counter()
    pm, oracle_nll = synth_packed(jax.random.PRNGKey(0), M, N, K_true, K)
    pm.words.block_until_ready()
    gen_s = time.perf_counter() - t0
    _solve_and_record(name, pm, oracle_nll, gen_s, K, max_iter, writer, f)


def run_sparse_config(name, M, N, K, density, max_iter, writer, f):
    """Sparse-ingestion flagship: a host-side ``scipy.sparse`` binary matrix
    at ``density`` packs through :func:`nbmf_mm_jax.pack_matrix_sparse` —
    the real-world large-binary-data shape (user-item interactions), never
    staged dense on host or device.  Data is i.i.d. Bernoulli(density), so
    the oracle per-entry NLL is its entropy — the floor any rank-K fit of
    structureless data can approach."""
    import scipy.sparse as sp

    from nbmf_mm_jax import pack_matrix_sparse

    print(f"[{name}] building {M}x{N} csr at {density:.0%} ...", flush=True)
    rng = np.random.default_rng(0)
    nnz = int(density * M * N)
    S = sp.csr_matrix(
        (
            np.ones(nnz, dtype=np.float32),
            (rng.integers(0, M, nnz), rng.integers(0, N, nnz)),
        ),
        shape=(M, N),
    )
    S.data[:] = 1.0  # collisions summed at construction; rebinarize
    p_eff = S.nnz / (M * N)
    oracle_nll = -(p_eff * np.log(p_eff) + (1 - p_eff) * np.log1p(-p_eff))
    t0 = time.perf_counter()
    pm = pack_matrix_sparse(S)
    pm.words.block_until_ready()
    ingest_s = time.perf_counter() - t0
    print(
        f"[{name}] sparse->words ingest {pm.nbytes / 2**20:.0f} MB in "
        f"{ingest_s:.1f}s ({M * N / ingest_s / 1e6:.0f} Mentries/s)",
        flush=True,
    )
    _solve_and_record(name, pm, oracle_nll, ingest_s, K, max_iter, writer, f)


def _solve_and_record(name, pm, oracle_nll, gen_s, K, max_iter, writer, f):
    import jax

    from nbmf_mm_jax import solve

    M, N = pm.shape
    packed_mb = pm.nbytes / 2**20
    print(
        f"[{name}] packed {packed_mb:.0f} MB in {gen_s:.1f}s "
        f"(oracle NLL {oracle_nll:.5f}); solving K={K} ...",
        flush=True,
    )

    kw = dict(
        max_iter=max_iter, tol=1e-5, random_state=0, alpha=1.2, beta=1.2,
        device_results=True,
    )
    res = solve(pm, K, **kw)  # compile + warm
    jax.block_until_ready((res.W, res.H))
    t0 = time.perf_counter()
    res = solve(pm, K, **kw)  # steady-state timed run (device only)
    jax.block_until_ready((res.W, res.H))
    solve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.asarray(res.W)  # the full factor pull, timed separately
    retrieve_s = time.perf_counter() - t0
    losses = np.asarray(res.losses)
    assert np.all(np.isfinite(losses)), "non-finite losses at scale"
    worst = float(np.max(np.diff(losses))) if len(losses) > 1 else 0.0
    assert worst <= 1e-4, f"MM descent violated at scale: {worst}"
    sweeps_per_sec = res.n_iter / solve_s
    row = dict(
        config=name, M=M, N=N, K=K, entries=M * N,
        packed_mb=round(packed_mb, 1), n_iter=res.n_iter,
        converged=res.converged, final_loss=round(float(losses[-1]), 6),
        oracle_nll=round(float(oracle_nll), 6),
        sweeps_per_sec=round(sweeps_per_sec, 2),
        ms_per_sweep=round(1000 * solve_s / res.n_iter, 2),
        solve_s=round(solve_s, 2), retrieve_s=round(retrieve_s, 2),
        gen_pack_s=round(gen_s, 1),
        worst_descent_violation=f"{worst:.2e}",
        peak_gb=peak_gb(), device=jax.devices()[0].device_kind,
        card=CARD,
    )
    if writer[0] is None:
        writer[0] = csv.DictWriter(f, fieldnames=list(row))
        writer[0].writeheader()
    writer[0].writerow(row)
    f.flush()
    print(f"[{name}] {row}", flush=True)
    del pm, res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ceiling", action="store_true",
                    help="also run the memory-ceiling probes (4e9 and 1e10 entries)")
    ap.add_argument("--only", default=None, help="run a single named config")
    ap.add_argument("--sparse", action="store_true",
                    help="also run the scipy.sparse host-ingestion config")
    ap.add_argument("--append", action="store_true",
                    help="append rows to an existing CSV instead of rewriting "
                         "it (targeted --only retries)")
    args = ap.parse_args()

    from experiments._env import force_platform

    global CARD
    force_platform("gpu")  # raises without a GPU: this script measures the card

    from nbmf_mm_jax.utils import enable_compilation_cache
    from nbmf_mm_jax.utils.profiling import gpu_card

    CARD = gpu_card()
    print(CARD, flush=True)
    # The timed quantity is the second, in-process-warm call; the cache
    # only spares repeat runs their compiles.
    enable_compilation_cache()

    configs = CONFIGS + (CEILING if args.ceiling else [])
    sparse_cfgs = SPARSE if args.sparse else []
    if args.only:
        configs = [c for c in configs + CEILING if c[0] == args.only]
        sparse_cfgs = [c for c in SPARSE if c[0] == args.only]
    OUT.parent.mkdir(parents=True, exist_ok=True)
    appending = args.append and OUT.exists() and OUT.stat().st_size > 0
    writer = [None]
    if appending:  # reuse the existing header (column sets must match)
        with open(OUT, newline="") as f0:
            writer = [csv.DictWriter(sys.stdout, next(csv.reader(f0)))]
    with open(OUT, "a" if appending else "w", newline="") as f:
        if appending:
            writer = [csv.DictWriter(f, writer[0].fieldnames)]
        for cfg in configs:
            run_config(*cfg, writer, f)
        for cfg in sparse_cfgs:
            run_sparse_config(*cfg, writer, f)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
