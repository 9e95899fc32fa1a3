#!/usr/bin/env python
"""Render figures from the reproduction CSVs (analogue of the reference's
``examples/display_reproduced_results.py``): Figure-1 validation-perplexity
heatmaps, Figure-2 comparison bars, Figure-3 perplexity-vs-K curves, and a
summary table.

Reads ``outputs/figure*_*.csv`` written by ``reproduce_magron2022.py`` and
writes PNGs next to them.  Requires matplotlib (gated: exits gracefully if
unavailable).
"""

from __future__ import annotations

import csv
import sys
from pathlib import Path

import numpy as np

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except Exception:  # pragma: no cover
    print("matplotlib unavailable; skipping figure rendering")
    sys.exit(0)

OUTDIR = Path(sys.argv[1]) if len(sys.argv) > 1 else Path(__file__).parent.parent / "outputs"
DATASETS = ("animals", "lastfm", "paleo")


def _coerce(key, value):
    if key == "dataset":
        return value
    if value in ("True", "False"):
        return value == "True"
    try:
        return float(value)
    except ValueError:
        return value


def _read_csv(path: Path):
    with open(path) as f:
        return [{k: _coerce(k, v) for k, v in row.items()} for row in csv.DictReader(f)]


def figure1_heatmaps():
    paths = [OUTDIR / f"figure1_{ds}_results.csv" for ds in DATASETS]
    avail = [(ds, p) for ds, p in zip(DATASETS, paths) if p.exists()]
    if not avail:
        return
    fig, axes = plt.subplots(1, len(avail), figsize=(5 * len(avail), 4))
    axes = np.atleast_1d(axes)
    for ax, (ds, path) in zip(axes, avail):
        rows = _read_csv(path)
        alphas = sorted({r["alpha"] for r in rows})
        betas = sorted({r["beta"] for r in rows})
        grid = np.full((len(alphas), len(betas)), np.nan)
        for r in rows:
            grid[alphas.index(r["alpha"]), betas.index(r["beta"])] = r["val_perplexity"]
        im = ax.imshow(grid, origin="lower", aspect="auto", cmap="viridis")
        ax.set_xticks(range(len(betas)), [f"{b:g}" for b in betas])
        ax.set_yticks(range(len(alphas)), [f"{a:g}" for a in alphas])
        ax.set_xlabel("beta")
        ax.set_ylabel("alpha")
        ax.set_title(f"{ds}: validation perplexity")
        fig.colorbar(im, ax=ax)
        i, j = np.unravel_index(np.nanargmin(grid), grid.shape)
        ax.plot(j, i, "r*", markersize=14)
    fig.tight_layout()
    fig.savefig(OUTDIR / "figure1_heatmaps.png", dpi=120)
    print(f"wrote {OUTDIR / 'figure1_heatmaps.png'}")


def figure2_bars():
    path = OUTDIR / "figure2_results.csv"
    if not path.exists():
        return
    rows = _read_csv(path)
    ds = [r["dataset"] for r in rows]
    ours = [r["test_perplexity"] for r in rows]
    magron = [r["magron_best_val_perplexity"] for r in rows]
    x = np.arange(len(ds))
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar(x - 0.2, ours, 0.4, label="nbmf-mm-jax (test)")
    ax.bar(x + 0.2, magron, 0.4, label="Magron 2022 (best val)")
    ax.set_xticks(x, ds)
    ax.set_ylabel("perplexity (exp form)")
    ax.set_title("Test perplexity at best hyperparameters")
    ax.legend()
    fig.tight_layout()
    fig.savefig(OUTDIR / "figure2_bars.png", dpi=120)
    print(f"wrote {OUTDIR / 'figure2_bars.png'}")


def figure2_protocol_bars():
    """10-init protocol comparison (test per-entry NLL, mean +- std over 10
    random inits) of all three methods against the original paper author's
    stored artifact means — the direct analogue of the paper's Figure 2."""
    path = OUTDIR / "figure2_results.csv"
    if not path.exists():
        return
    rows = _read_csv(path)
    if "mm10_test_nll_mean" not in rows[0]:
        return
    methods = [
        ("NBMF-MM", "mm10_test_nll_mean", "mm10_test_nll_std", "magron_mm_test_nll_mean"),
        ("NBMF-EM", "nbmf_em_test_nll_mean", "nbmf_em_test_nll_std",
         "magron_nbmf_em_test_nll_mean"),
        ("logPCA", "logpca_test_nll_mean", "logpca_test_nll_std",
         "magron_logpca_test_nll_mean"),
    ]
    ds = [r["dataset"] for r in rows]
    fig, axes = plt.subplots(1, len(ds), figsize=(4 * len(ds), 4), squeeze=False)
    for ax, r in zip(axes[0], rows):
        names = [m[0] for m in methods if m[1] in r]
        ours = [r[m[1]] for m in methods if m[1] in r]
        errs = [r[m[2]] for m in methods if m[1] in r]
        refs = [r[m[3]] for m in methods if m[1] in r]
        x = np.arange(len(names))
        ax.bar(x - 0.2, ours, 0.4, yerr=errs, capsize=3, label="nbmf-mm-jax")
        ax.bar(x + 0.2, refs, 0.4, label="Magron 2022 artifacts")
        ax.set_xticks(x, names)
        ax.set_ylabel("test NLL / observed entry")
        ax.set_title(f"{r['dataset']}: 10-init protocol")
        ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(OUTDIR / "figure2_protocol.png", dpi=120)
    print(f"wrote {OUTDIR / 'figure2_protocol.png'}")


def figure3_curves():
    paths = [(ds, OUTDIR / f"figure3_{ds}_results.csv") for ds in DATASETS]
    avail = [(ds, p) for ds, p in paths if p.exists()]
    if not avail:
        return
    fig, ax = plt.subplots(figsize=(7, 4))
    for ds, path in avail:
        rows = _read_csv(path)
        ax.plot([r["k"] for r in rows], [r["test_perplexity"] for r in rows], "o-", label=ds)
    ax.set_xlabel("n_components (K)")
    ax.set_ylabel("test perplexity")
    ax.set_xscale("log", base=2)
    ax.set_title("Perplexity vs rank")
    ax.legend()
    fig.tight_layout()
    fig.savefig(OUTDIR / "figure3_curves.png", dpi=120)
    print(f"wrote {OUTDIR / 'figure3_curves.png'}")


def summary_table():
    print("\nSummary")
    for name in sorted(OUTDIR.glob("figure*_results.csv")):
        rows = _read_csv(name)
        key = "val_perplexity" if "figure1" in name.name else "test_perplexity"
        if rows and key in rows[0]:
            best = min(rows, key=lambda r: r[key])
            print(f"  {name.name}: best {key}={best[key]:.4f}")


if __name__ == "__main__":
    figure1_heatmaps()
    figure2_bars()
    figure2_protocol_bars()
    figure3_curves()
    summary_table()
