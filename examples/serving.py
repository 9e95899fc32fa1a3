#!/usr/bin/env python
"""Serving: fold new rows into a trained model with FoldInServer.

The estimator's ``transform`` recompiles per request shape; FoldInServer
pads requests into a small set of precompiled shape buckets, runs the
fold-in entirely on-device, and — for binary data — bitpacks each chunk on
the host so it crosses the host-device link at 1/32 the bytes
(docs/performance.md "Serving fold-in").

Run: python examples/serving.py
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nbmf_mm_jax import NBMF
from nbmf_mm_jax.models.serving import FoldInServer
from nbmf_mm_jax.utils import generate_synthetic_binary_data

# Train once.
X, _, _ = generate_synthetic_binary_data(
    n_samples=400, n_features=300, n_components=8, random_state=0
)
model = NBMF(n_components=8, random_state=0, tol=1e-6).fit(X)
print(f"trained: {model.n_iter_} sweeps, objective {model.loss_:.5f}")

# Serve streams of new rows against the fixed components_.
server = FoldInServer(model, buckets=(64, 256, 1024)).warmup()

rng = np.random.default_rng(1)
for batch_rows in (3, 70, 900):
    X_new = (rng.random((batch_rows, 300)) < 0.35).astype(float)
    W_new, scores = server.transform(X_new)
    print(f"batch {batch_rows:4d}: W {W_new.shape}, "
          f"mean per-row loglik {scores.mean():.4f}")

# Masked serving: score only the observed entries of partially-known rows.
X_part = (rng.random((10, 300)) < 0.35).astype(float)
observed = (rng.random((10, 300)) < 0.5).astype(float)
W_part, scores_part = server.transform(X_part, mask=observed)
print(f"masked batch: W {W_part.shape}, "
      f"mean observed loglik {scores_part.mean():.4f}")

# On-device fit -> serve pipeline: with device_results=True the factors
# never visit the host — hand the SolverResult straight to FoldInServer
# (useful when the host link is slow or the factors are large).
from nbmf_mm_jax import solve

result = solve(X, 8, random_state=0, tol=1e-6, device_results=True)
server2 = FoldInServer(result, buckets=(64,))
W2, s2 = server2.transform(X_new[:3])
print(f"device-handoff server: W {W2.shape}, loglik {s2.mean():.4f}")
