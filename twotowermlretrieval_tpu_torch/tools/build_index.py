#!/usr/bin/env python3
"""Offline IVF index builder, behind ``ttr-torch-build-index``: the port of
the JAX package's ``tools/build_index.py``, with the same flags.

Reads an artifact directory (``document_embeddings.npy`` from training),
clusters the corpus into the IVF index (``ops/ivf.py``) on the card (or
``--device cpu``) and writes ``ivf_index.npz`` next to the other artifacts.
Serving then starts with ``--index-type ivf`` and no k-means
(``ttr-torch-serve`` loads the file through ``load_artifacts``). With
``--target-recall`` it measures the smallest nprobe meeting that recall@k
against exact search and persists it in ``retrieval_tuning.json``, where a
later ``ttr-torch-serve --index-type ivf`` takes it unless ``--nprobe``
says otherwise.

Usage:
    ttr-torch-build-index artifacts/<run> \\
        [--storage-dtype bfloat16|int8|float32] [--clusters 0] [--iters 10] \\
        [--target-recall 0.99] [--device cuda]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build the serving-side IVF index offline")
    parser.add_argument("artifacts", help="artifact directory from training")
    parser.add_argument("--storage-dtype", default="bfloat16",
                        choices=["float32", "bfloat16", "int8"])
    parser.add_argument("--clusters", type=int, default=0, help="0 = sqrt(N) heuristic")
    parser.add_argument("--iters", type=int, default=10, help="Lloyd iterations")
    parser.add_argument("--kmeans-sample", type=int, default=0,
                        help=">0: run the Lloyd iterations on this many sampled rows")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--target-recall", type=float, default=0.0,
                        help=">0: after building, measure recall@k against exact search "
                             "on sampled queries and persist the smallest nprobe meeting "
                             "this target (ttr-torch-serve --index-type ivf then uses it)")
    parser.add_argument("--tune-k", type=int, default=50,
                        help="k for the --target-recall measurement")
    parser.add_argument("--tune-queries", type=int, default=256,
                        help="sampled probe queries for --target-recall")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu: where the k-means and the "
                             "recall measurement run")
    args = parser.parse_args(argv)

    art = Path(args.artifacts)
    emb_file = art / "document_embeddings.npy"
    if not emb_file.exists():
        print(f"FATAL: {emb_file} not found; train first "
              "(python -m twotowermlretrieval_tpu_torch.train.loop --config <json>)")
        sys.exit(1)

    from twotowermlretrieval_tpu_torch.ops.ivf import (
        IVF_INDEX_FILE,
        build_ivf,
        pick_nprobe,
        save_ivf,
    )
    from twotowermlretrieval_tpu_torch.serve.index import save_retrieval_tuning
    from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device

    dev = resolve_device(args.device)
    doc_embeddings = np.load(emb_file).astype(np.float32)
    print(f"clustering {doc_embeddings.shape[0]} docs x {doc_embeddings.shape[1]} dims "
          f"({args.storage_dtype} blocks) on {dev}...")
    t0 = time.time()
    index = build_ivf(doc_embeddings, num_clusters=args.clusters, iters=args.iters,
                      storage_dtype=args.storage_dtype, seed=args.seed,
                      kmeans_sample=args.kmeans_sample, device=dev)
    out = art / IVF_INDEX_FILE
    save_ivf(out, index)
    print(f"wrote {out} ({index.docs.shape[0]} blocks x cap {index.cap}) "
          f"in {time.time() - t0:.1f}s")

    if args.target_recall > 0:
        nprobe, recall = pick_nprobe(index, doc_embeddings, k=args.tune_k,
                                     target_recall=args.target_recall,
                                     num_queries=args.tune_queries, seed=args.seed)
        verdict = "meets" if recall >= args.target_recall else "BEST AVAILABLE under"
        print(f"nprobe={nprobe} {verdict} recall@{args.tune_k} target {args.target_recall} "
              f"(measured {recall:.4f}); serve with ttr-torch-serve --index-type ivf "
              f"(nprobe persisted; override with --nprobe)")
        # persisted with the artifacts: a later boot takes it without measuring
        save_retrieval_tuning(art, {
            "nprobe": int(nprobe),
            "nprobe_recall": {"k": args.tune_k, "target": args.target_recall,
                              "measured": float(recall)},
            "nprobe_signature": {
                "num_docs": int(doc_embeddings.shape[0]),
                "dim": int(doc_embeddings.shape[1]),
                "storage_dtype": args.storage_dtype,
                "index_type": "ivf",
                "backend": dev.type,
            },
        })


if __name__ == "__main__":
    main()
