#!/usr/bin/env python3
"""Time the f32 route of the scans: ``segmax`` and the running top-k (k=50)
over f32 unit rows, each held against its plain version (max |diff|, two
calls bit-identical, the top-k's ids scoring their values) and timed with
CUDA events (medians of single calls) beside its library call and its byte
bound; then the served f32 top-50, ``RetrievalIndex(storage_dtype=
"float32").search`` over the export's 70,000 rows at B=1 and 16, which is
what ``ttr-torch-serve --storage-dtype float32`` runs for a dense search.

    python3 twotowermlretrieval_tpu_torch/tools/bench_f32_scans.py [CHECKOUT]
        [--layouts] [--out FILE] [--device cuda]

CHECKOUT: time that checkout's package (default: this one's), so that one
call on one card can time two trees in turns (another commit unpacked
beside this one with ``git archive``). ``--layouts`` also times every
(stages, blocks a SM) the f32 plan could take at each shape, the chosen one
marked (needs a checkout whose f32 plans ride the ring). Each record is
printed as a JSON line and, with ``--out``, written as a JSON list.
``--device cpu`` runs the plain versions at toy sizes on the host clock: a
check of the harness, whose times say nothing about a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)
SMEM_LIMIT, SM_SMEM = 232_448, 233_472  # a block's shared memory; a SM's
# (rows, H, batch sizes): the served width over 1M rows and one shard of
# 524,288, the widest tower's over 262,144 rows
SHAPES = ((1 << 20, 256, (1, 16, 32)), (524_288, 256, (16,)), (262_144, 3200, (32,)))
CPU_SHAPES = ((4096, 64, (1, 16)), (2048, 320, (32,)))
SERVED_ROWS, K = 70_000, 50


def _import_port(checkout: Path):
    sys.path.insert(0, str(checkout))
    import twotowermlretrieval_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parent.parent != checkout:
        raise SystemExit(f"the package came from {pkg.__file__}, not {checkout}")
    from twotowermlretrieval_tpu_torch.ops import topk
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

    return topk, RetrievalIndex


def _timer(torch, dev):
    if dev.type == "cpu":
        def time_ms(fn, reps=3, warmup=1):
            for _ in range(warmup):
                fn()
            out = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                out.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(out)
        return time_ms

    def time_ms(fn, reps=15, warmup=3):
        for _ in range(warmup):
            fn()
        out = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return statistics.median(out)
    return time_ms


def _unit_rows(torch, gen, n, h, dev):
    out = torch.empty((n, h), device=dev)
    for i in range(0, n, 1 << 17):
        x = torch.randn((min(1 << 17, n - i), h), generator=gen, device=dev)
        out[i : i + (1 << 17)] = x / x.norm(dim=1, keepdim=True)
    return out


def _layouts(topk, B, H, k):
    """Every (stages, blocks a SM) the f32 route could take at (B, H, k),
    as plans; the kernels' launch bounds cap the blocks (segmax 4, top-k 3)."""
    import torch

    base = topk.scan_plan(B, H, torch.float32, k)
    extra = base["smem"] - base["stages"] * base["stage_bytes"]
    for stages in (2, 3, 4):
        smem = stages * base["stage_bytes"] + extra
        if smem > SMEM_LIMIT:
            continue
        for per_sm in range(1, min(4 if k is None else 3, SM_SMEM // (smem + 1024)) + 1):
            yield dict(base, stages=stages, smem=smem, blocks_per_sm=per_sm), (
                (stages, per_sm) == (base["stages"], base["blocks_per_sm"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkout", nargs="?", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--layouts", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    topk, RetrievalIndex = _import_port(Path(args.checkout).resolve())
    import numpy as np
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to check the harness")
        torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products in the yardsticks
        card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    else:
        card = "the host (plain versions)"
    time_ms = _timer(torch, dev)
    recs = []

    def emit(rec):
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        recs.append(rec)

    with torch.inference_mode():
        for rows, H, batches in SHAPES if dev.type == "cuda" else CPU_SHAPES:
            gen = torch.Generator(device=dev).manual_seed(rows + H)
            docs = _unit_rows(torch, gen, rows, H, dev)
            n_valid = rows - 1001
            for B in batches:
                q = _unit_rows(torch, gen, B, H, dev)
                full = torch.matmul(q, docs.T)
                seg = lambda: topk.segmax(q, docs, n_valid)[0]  # noqa: E731
                top = lambda: topk.topk_stream(q, docs, K, n_valid)  # noqa: E731
                got, vals, ids = seg(), *top()
                again, (a_vals, a_ids) = seg(), top()
                r_vals, r_ids = topk.topk_stream_reference(q, docs, K, n_valid)
                nbytes = topk.segmax_bound(B, H, rows, 4)[0]
                rec = {
                    "rows": rows, "H": H, "B": B,
                    "segmax_err": (got - topk.segmax_reference(q, docs, n_valid)[0])
                    .abs().max().item(),
                    "topk_err": max((vals - r_vals).abs().max().item(),
                                    (full.gather(1, ids.long()) - vals).abs().max().item()),
                    "topk_ids_equal_plain": (ids == r_ids).float().mean().item(),
                    "bitwise_repeatable": bool(torch.equal(got, again) and torch.equal(
                        vals, a_vals) and torch.equal(ids, a_ids)),
                    "segmax_ms": time_ms(seg),
                    "segmax_library_ms": time_ms(
                        lambda: torch.matmul(docs, q.T).view(-1, 128, B).amax(dim=1)),
                    "topk_ms": time_ms(top),
                    "topk_library_ms": time_ms(lambda: torch.topk(
                        torch.matmul(q, docs[:n_valid].T), K)),
                    "segmax_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "topk_bound_ms": topk.topk_stream_bound(B, H, rows, K, 4)[0]
                    / HBM_BYTES_PER_S * 1e3,
                }
                before = topk.segmax.launches
                seg()
                rec["segmax_launches_a_call"] = topk.segmax.launches - before
                before = topk.topk_stream.launches
                top()
                rec["topk_launches_a_call"] = topk.topk_stream.launches - before
                emit(rec)
                if args.layouts:
                    orig = topk.scan_plan
                    try:
                        for name, k, fn in (("segmax", None, seg), ("topk_stream", K, top)):
                            for plan, chosen in list(_layouts(topk, B, H, k)):
                                topk.scan_plan = lambda *a, plan=plan, **kw: plan
                                emit({"layout": name, "rows": rows, "H": H, "B": B,
                                      "stages": plan["stages"],
                                      "blocks_per_sm": plan["blocks_per_sm"],
                                      "chosen": chosen, "ms": time_ms(fn)})
                                topk.scan_plan = orig
                    finally:
                        topk.scan_plan = orig
                del full
            del docs
            if dev.type == "cuda":
                torch.cuda.empty_cache()

        rng = np.random.default_rng(7)
        n = SERVED_ROWS if dev.type == "cuda" else 3000
        x = rng.standard_normal((n, 256)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        index = RetrievalIndex(x, device=dev, storage_dtype="float32")
        for B in (1, 16):
            qn = x[:B] + 0.05 * rng.standard_normal((B, 256)).astype(np.float32)
            index.search(qn, K)
            ts = []
            for _ in range(20):
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                index.search(qn, K)  # ends in the host fetch of the results
                ts.append((time.perf_counter() - t0) * 1e3)
            emit({"served_f32_top50": True, "rows": n, "B": B,
                  "ms_median": statistics.median(ts), "ms_min": min(ts)})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
