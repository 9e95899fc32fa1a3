#!/usr/bin/env python
"""Sparse binary data at scale: scipy.sparse in, bitpacked words on device.

The common real-world shape of large binary data is a sparse matrix
(user-item interactions; the paper's lastfm matrix is ~3% dense).  Its
dense f32 staging is what blows the memory ceiling that bitpacking
removes — so the sparse structure packs STRAIGHT to int32 bit-plane words
(1/32 the dense bytes) and the matrix is never materialized dense, host or
device:

- `solve(S, k)` / `NBMF().fit(S)` accept `scipy.sparse` directly: f32
  beta-dir routings on the fused kernels pack from the sparse rows chunk
  by chunk; every other routing densifies as before.
- `pack_matrix_sparse(S)` builds the `PackedMatrix` explicitly (same
  thing `solve` does internally) for reuse across calls.
- `FoldInServer.transform` accepts sparse request batches (densified one
  bucket-chunk at a time).

Run: python examples/sparse_input.py   (GPU; on a CPU the same kernels run
                                        interpreted at a smaller size)
"""

import sys
from pathlib import Path

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

from nbmf_mm_jax import NBMF, pack_matrix_sparse, solve
from nbmf_mm_jax.models.serving import FoldInServer

on_gpu = jax.default_backend() == "gpu"
# Off the GPU, drive the same kernels interpreted (slow, exact) at a
# smaller size.
interp = {} if on_gpu else {"pallas_interpret": True}

# A sparse binary "interactions" matrix (~3% dense, lastfm-like).
rng = np.random.default_rng(0)
m, n, k = (4096, 1024, 16) if on_gpu else (512, 256, 8)
rows = rng.integers(0, m, size=int(0.03 * m * n))
cols = rng.integers(0, n, size=rows.size)
S = sp.csr_matrix(
    (np.ones(rows.size, dtype=np.float32), (rows, cols)), shape=(m, n)
)
S.data[:] = 1.0  # collisions summed at construction; rebinarize
print(f"S: {S.shape}, {S.nnz} nonzeros ({S.nnz / (m * n):.1%} dense), "
      f"{S.data.nbytes + S.indices.nbytes + S.indptr.nbytes:,} bytes sparse "
      f"vs {4 * m * n:,} dense f32")

# Explicit packing: 1/32 the dense bytes cross to the device.
pm = pack_matrix_sparse(S)
print(f"packed: {pm.words.shape} int32 words = {pm.nbytes:,} bytes "
      f"({4 * m * n / pm.nbytes:.0f}x smaller than dense f32)")

# solve() takes the sparse matrix directly (packs internally when the
# routing is packed-eligible — beta-dir, f32, fused backend).
mi = 50 if on_gpu else 12
res = solve(S, k, max_iter=mi, random_state=0, dtype="float32",
            backend="pallas", **interp)
print(f"solve(sparse): {res.n_iter} sweeps, final loss {res.losses[-1]:.6f}")

# The estimator API accepts sparse (and PackedMatrix) the same way.
model = NBMF(n_components=k, max_iter=mi, random_state=0, dtype="float32",
             backend="pallas", solver_options=interp or None).fit(S)
print(f"NBMF.fit(sparse): {model.n_iter_} sweeps, loss {model.loss_:.6f}")

# Serving: sparse request batches fold in chunk-by-chunk.
srv = FoldInServer(model, buckets=(256, 1024), n_iter=mi, **interp)
requests = S[:256]  # sparse slice, stays sparse until its chunk is staged
W, scores = srv.transform(requests)
print(f"fold-in: W {W.shape}, mean per-row loglik {scores.mean():.4f}")
