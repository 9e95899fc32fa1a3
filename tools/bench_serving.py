#!/usr/bin/env python
"""Serving fold-in benchmark: packed vs dense kernels, on-device rate and
end-to-end request latency.

Two measurements per variant:

1. *On-device per-iteration rate*: the fold-in ``fori_loop`` carries W
   through every iteration (naturally hoist-immune), so timing one jitted
   call at two ``n_iter`` values and taking the slope cancels the constant
   dispatch + transfer cost exactly.
2. *End-to-end request latency*: wall time of ``FoldInServer.transform``
   on a fresh host batch — includes padding, (host) packing, the
   host-device transfer, and the result transfer back.  This is the number
   a serving deployment sees; host-side bitpacking cuts the transferred
   bytes 32x.

Usage: python tools/bench_serving.py [--rows 8192] [--features 10000]
       [--k 128] [--repeats 5]
"""
import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=8192)
    ap.add_argument("--features", type=int, default=10000)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--lo", type=int, default=50)
    ap.add_argument("--hi", type=int, default=250)
    args = ap.parse_args()

    import jax

    from nbmf_mm_jax.models.serving import FoldInServer

    rng = np.random.default_rng(0)
    H = rng.uniform(0.05, 0.95, (args.k, args.features)).astype(np.float32)
    X = (rng.random((args.rows, args.features)) < 0.3).astype(np.float32)
    from nbmf_mm_jax.utils.profiling import gpu_card, require_gpu

    require_gpu()
    print(f"{gpu_card()}; device: {jax.devices()[0].device_kind}, batch "
          f"{args.rows} x {args.features}, k={args.k}")

    def e2e(srv):
        srv.transform(X[: args.rows])  # warm the bucket
        ts = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            W, s = srv.transform(X)
            float(W[0, 0])
            ts.append(time.perf_counter() - t0)
        return min(ts)

    def per_iter(packed):
        # slope over n_iter: two servers sharing bucket geometry
        ts = {}
        for n_iter in (args.lo, args.hi):
            srv = FoldInServer(
                H, buckets=(args.rows,), dtype="float32", n_iter=n_iter,
                packed=packed,
            )
            srv.transform(X)  # compile + first transfer
            best = np.inf
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                W, _ = srv.transform(X)
                float(W[0, 0])
                best = min(best, time.perf_counter() - t0)
            ts[n_iter] = best
        return (ts[args.hi] - ts[args.lo]) / (args.hi - args.lo)

    for packed in (False, None):
        name = "packed" if packed is None else "dense"
        srv = FoldInServer(H, buckets=(args.rows,), dtype="float32",
                           packed=packed)
        lat = e2e(srv)
        slope = per_iter(packed)
        rows_s = args.rows / lat
        print(f"{name:>7}: e2e {lat*1e3:8.1f} ms ({rows_s:9.0f} rows/s at "
              f"n_iter=50) | fold-in slope {slope*1e3:7.3f} ms/iteration")


if __name__ == "__main__":
    main()
