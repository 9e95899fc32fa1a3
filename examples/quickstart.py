#!/usr/bin/env python
"""Quickstart: fit NBMF-MM on synthetic binary data (README walkthrough).

Run: python examples/quickstart.py
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nbmf_mm_jax import NBMF
from nbmf_mm_jax.utils import generate_synthetic_binary_data

# Synthetic binary matrix with known low-rank structure.
X, W_true, H_true = generate_synthetic_binary_data(
    n_samples=100, n_features=500, n_components=6, random_state=0
)

model = NBMF(n_components=6, alpha=1.2, beta=1.2, tol=1e-6, random_state=0)
W = model.fit_transform(X)

print(f"fit: {model.n_iter_} sweeps, final objective {model.loss_:.6f} "
      f"({model.fit_time_:.2f}s)")
print(f"W {W.shape} rows sum to {W.sum(axis=1)[:3].round(6)} (simplex)")
print(f"H {model.components_.shape} in (0,1): "
      f"[{model.components_.min():.3g}, {model.components_.max():.3g}]")
print(f"perplexity: {model.perplexity(X):.4f}")

# Matrix completion: hide 15% of entries, score the holdout on the fitted
# reconstruction (the reproduction pipeline's metric; `model.perplexity`
# instead refits W via `transform`, preserving the reference's semantics).
rng = np.random.default_rng(1)
observed = (rng.random(X.shape) < 0.85).astype(float)
model = NBMF(n_components=6, random_state=0, mask_mode="corrected")
model.fit(X, mask=observed)
recon = model.W_ @ model.components_
holdout = (1 - observed)
eps = 1e-8
ll = holdout * (X * np.log(recon + eps) + (1 - X) * np.log(1 - recon + eps))
print(f"holdout perplexity: {np.exp(-ll.sum() / holdout.sum()):.4f}")

# Batched restarts: best of 8 initializations in one device program.
model = NBMF(n_components=6, n_init=8, random_state=0).fit(X)
print(f"n_init=8: best restart {model.solver_result_.best_restart}, "
      f"objective {model.loss_:.6f}")
