#!/usr/bin/env python3
"""Time the retrieval variants on one device and print a table: the fused
segment-max path's phase 2 {rescore, gather} x {unsorted, sorted} and the
two-phase path, for int8 and bf16 storage. On a card the two-phase path is a
yardstick: autotune never serves it there.

This is ``RetrievalIndex.autotune()`` at benchmark scale (default
1,048,576 x 256, 16 queries x top-50: the reference model's width and the
engine's smallest encode batch), so the numbers printed are the ones
``ttr-torch-serve --autotune-retrieval`` acts on. Each variant is timed
with CUDA events around ``--iters`` calls after one warm-up call.

Usage:
    ttr-torch-bench-retrieval [--n 1048576] [--dim 256] [--batch 16] [--k 50]
        [--iters 40] [--dtypes int8,bfloat16] [--device cuda]

``--device cpu`` times the plain versions on the host clock: a check of
the harness, whose times say nothing about a card.
"""

import argparse

import numpy as np

# H100 SXM HBM3 bandwidth (NVIDIA's data sheet); the speed-of-light column
# is the corpus bytes over it, a floor for any variant's scan
HBM_BYTES_PER_S = 3.35e12
_STORAGE_BYTES = {"int8": 1, "bfloat16": 2, "float32": 4}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--dtypes", default="int8,bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex, variant_name

    rng = np.random.default_rng(args.seed)
    docs = rng.standard_normal((args.n, args.dim), dtype=np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    where = (f"{torch.cuda.get_device_name(0)}" if args.device.startswith("cuda")
             else "the host (plain versions)")
    for dtype in (d.strip() for d in args.dtypes.split(",")):
        index = RetrievalIndex(docs, storage_dtype=dtype, device=args.device, use_kernel=True)
        print(f"== {dtype}  N={args.n} H={args.dim} B={args.batch} k={args.k} on {where} ==",
              flush=True)
        timings = index.autotune(B=args.batch, k=args.k, iters=args.iters)
        if ("two_phase", False) not in timings:  # a card index never serves it: a yardstick
            timings[("two_phase", False)] = index._time_variant(
                "two_phase", False, args.batch, min(args.k, args.n), args.iters)
        sol = args.n * args.dim * _STORAGE_BYTES[dtype] / HBM_BYTES_PER_S
        for (phase2, srt), t in sorted(timings.items(), key=lambda kv: kv[1]):
            print(f"  {variant_name(phase2, srt):16s} {t * 1e3:8.3f} ms"
                  f"   ({sol / max(t, 1e-12) * 100:5.1f}% of the {sol * 1e3:.3f} ms corpus read"
                  f" at 3.35 TB/s)", flush=True)
        best = ("two-phase" if not index.kernel_on()
                else variant_name(index.phase2, index.sort_candidates))
        print(f"  -> serving choice: {best}", flush=True)
        del index


if __name__ == "__main__":
    main()
