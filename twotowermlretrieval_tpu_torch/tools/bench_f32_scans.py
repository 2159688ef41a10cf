#!/usr/bin/env python3
"""Time the scans over one storage dtype: ``segmax`` and the running top-k
(k=50) over unit rows stored in f32 (the default), bf16 or per-row int8
(``--storage``), each held against its plain version (max |diff|, two calls
bit-identical, the top-k's ids scoring their values), a SHA-256 digest of
its outputs (so two checkouts' bits can be compared), its launches a call
and the layout it took, timed with CUDA events (medians of single calls)
beside its library call and its bound; then, at f32, the served top-50,
``RetrievalIndex(storage_dtype="float32").search`` over the export's
70,000 rows at B=1 and 16, which is what ``ttr-torch-serve --storage-dtype
float32`` runs for a dense search.

    python3 twotowermlretrieval_tpu_torch/tools/bench_f32_scans.py [CHECKOUT]
        [--storage f32|bf16|int8] [--layouts] [--out FILE] [--device cuda]

CHECKOUT: time that checkout's package (default: this one's), so that one
call on one card can time two trees in turns (another commit unpacked
beside this one with ``git archive``). ``--layouts`` also times every layout
the scan can take at each shape (each route of the query fragments,
resident in shared memory or riding the ring, each ring depth and each
count of blocks a SM up to the most that fit), the chosen one marked, each
with its digest; a checkout without ``ops/topk.py`` ``scan_layouts`` gets
its own plan's route at every depth and count. Each record is printed as a
JSON line and, with ``--out``, written as a JSON list. ``--device cpu`` runs
the plain versions at toy sizes on the host clock: a check of the harness,
whose times say nothing about a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores; an f32 product takes six
SMEM_LIMIT, SM_SMEM = 232_448, 233_472  # a block's shared memory; a SM's
# (rows, H, batch sizes) a storage dtype is timed at: the served width over
# 1M rows and one shard of 524,288, the widest tower's over 262,144 rows, and
# (bf16, int8) a width between them
SHAPES = {
    "f32": ((1 << 20, 256, (1, 16, 32)), (524_288, 256, (16,)), (262_144, 3200, (32,))),
    "bf16": ((1 << 20, 256, (1, 16, 32)), (524_288, 256, (16,)), (262_144, 3360, (32,)),
             (524_288, 1024, (32,))),
}
SHAPES["int8"] = SHAPES["bf16"]
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


def digest(torch, tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _layouts(topk, B, H, storage, k):
    """Every (route, stages, blocks a SM) the scan could take at (B, H, k),
    as plans, each with whether it is the checkout's own; the kernels'
    launch bounds cap the blocks (segmax 4, top-k 3)."""
    import torch

    chosen = topk.query_blocks("scan", B, H, storage, k)
    if len(chosen) != 1:
        return []  # a checkout that cuts the batch: no one-launch layout to vary
    chosen = chosen[0][2]
    if hasattr(topk, "scan_layouts"):
        bases = topk.scan_layouts(B, H, storage, k)
    else:  # the checkout's own route at every depth that fits
        stage = chosen.get("stage_bytes", 128 * 128)
        extra = chosen["smem"] - chosen["stages"] * stage
        bases = [dict(chosen, stages=s, smem=s * stage + extra,
                      blocks_per_sm=min(4 if k is None else 3,
                                        SM_SMEM // (s * stage + extra + 1024)))
                 for s in (4, 3, 2) if s * stage + extra <= SMEM_LIMIT]
    key = ("query_frags", "stages", "blocks_per_sm")
    for base in bases:
        for per_sm in range(1, base["blocks_per_sm"] + 1):
            plan = dict(base, blocks_per_sm=per_sm)
            yield plan, all(plan.get(x) == chosen.get(x) for x in key)


def _cases(topk, torch, storage, q, docs32, n_valid):
    """(segmax call, top-k call, segmax plain, top-k plain, segmax library,
    top-k library, full f32 scores, (segmax bytes, top-k bytes), products,
    kernel storage dtype) over the corpus docs32 stored as ``storage``."""
    B, H = q.shape
    rows = docs32.shape[0]
    if storage == "int8":
        scales = docs32.abs().amax(dim=1) / 127.0  # quantize_rows' arithmetic, on the device
        scales = torch.where(scales == 0, torch.ones_like(scales), scales)
        values = torch.clamp(torch.round(docs32 / scales[:, None]), -127, 127).to(torch.int8)
        qb = q.bfloat16()
        v16 = values.bfloat16()
        return (lambda: topk.segmax_int8(qb, values, scales, n_valid),
                lambda: topk.topk_stream_int8(qb, values, scales, K, n_valid),
                lambda: topk.segmax_int8_reference(qb, values, scales, n_valid),
                lambda: topk.topk_stream_reference(qb, values, K, n_valid, scales),
                lambda: (torch.matmul(v16, qb.T).float() * scales[:, None])
                .view(-1, 128, B).amax(dim=1),
                lambda: torch.topk(torch.matmul(qb, v16[:n_valid].T).float()
                                   * scales[:n_valid], K),
                torch.matmul(qb.float(), values.float().T) * scales,
                (topk.segmax_int8_bound(B, H, rows)[0],
                 topk.topk_stream_bound(B, H, rows, K, 1, scaled=True)[0]),
                1, torch.int8)
    dt = torch.float32 if storage == "f32" else torch.bfloat16
    docs, qs = docs32.to(dt), q.to(dt)
    nb = docs.element_size()
    return (lambda: topk.segmax(qs, docs, n_valid)[0],
            lambda: topk.topk_stream(qs, docs, K, n_valid),
            lambda: topk.segmax_reference(qs, docs, n_valid)[0],
            lambda: topk.topk_stream_reference(qs, docs, K, n_valid),
            lambda: torch.matmul(docs, qs.T).view(-1, 128, B).amax(dim=1),
            lambda: torch.topk(torch.matmul(qs, docs[:n_valid].T).float(), K),
            torch.matmul(qs.float(), docs.float().T),
            (topk.segmax_bound(B, H, rows, nb)[0], topk.topk_stream_bound(B, H, rows, K, nb)[0]),
            6 if storage == "f32" else 1, dt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkout", nargs="?", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--storage", choices=("f32", "bf16", "int8"), default="f32")
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

    def bound_ms(nbytes, flops):
        return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3

    with torch.inference_mode():
        for rows, H, batches in SHAPES[args.storage] if dev.type == "cuda" else CPU_SHAPES:
            gen = torch.Generator(device=dev).manual_seed(rows + H)
            docs32 = _unit_rows(torch, gen, rows, H, dev)
            n_valid = rows - 1001
            for B in batches:
                q = _unit_rows(torch, gen, B, H, dev)
                (seg, top, seg_plain, top_plain, seg_lib, top_lib, full, (seg_bytes, top_bytes),
                 products, st) = _cases(topk, torch, args.storage, q, docs32, n_valid)
                got, vals, ids = seg(), *top()
                again, (a_vals, a_ids) = seg(), top()
                r_vals, r_ids = top_plain()
                flops = 2 * B * H * rows * products
                rec = {
                    "storage": args.storage, "rows": rows, "H": H, "B": B,
                    "segmax_err": (got - seg_plain()).abs().max().item(),
                    "topk_err": max((vals - r_vals).abs().max().item(),
                                    (full.gather(1, ids.long()) - vals).abs().max().item()),
                    "topk_ids_equal_plain": (ids == r_ids).float().mean().item(),
                    "bitwise_repeatable": bool(torch.equal(got, again) and torch.equal(
                        vals, a_vals) and torch.equal(ids, a_ids)),
                    "segmax_digest": digest(torch, [got]),
                    "topk_digest": digest(torch, [vals, ids]),
                    "segmax_ms": time_ms(seg),
                    "segmax_library_ms": time_ms(seg_lib),
                    "topk_ms": time_ms(top),
                    "topk_library_ms": time_ms(top_lib),
                    "segmax_bound_ms": bound_ms(seg_bytes, flops),
                    "topk_bound_ms": bound_ms(top_bytes, flops),
                }
                for name, fn, counter, k in (("segmax", seg, topk.segmax, None),
                                             ("topk", top, topk.topk_stream, K)):
                    if st == torch.int8:
                        counter = getattr(topk, f"{counter.__name__}_int8")
                    before = counter.launches
                    fn()
                    rec[f"{name}_launches_a_call"] = counter.launches - before
                    rec[f"{name}_plan"] = [
                        {x: p.get(x) for x in ("query_frags", "stages", "blocks_per_sm")}
                        | {"rows": b} for _, b, p in topk.query_blocks(name, B, H, st, k)]
                emit(rec)
                if args.layouts:
                    orig = topk.scan_plan
                    try:
                        for name, k, fn in (("segmax", None, seg), ("topk_stream", K, top)):
                            for plan, chosen in list(_layouts(topk, B, H, st, k)):
                                topk.scan_plan = lambda *a, plan=plan, **kw: plan
                                out = fn()
                                emit({"layout": name, "storage": args.storage, "rows": rows,
                                      "H": H, "B": B, "query_frags": plan.get("query_frags"),
                                      "stages": plan["stages"],
                                      "blocks_per_sm": plan["blocks_per_sm"],
                                      "smem": plan["smem"], "chosen": chosen,
                                      "digest": digest(torch, [out] if torch.is_tensor(out)
                                                       else list(out)),
                                      "ms": time_ms(fn)})
                                topk.scan_plan = orig
                    finally:
                        topk.scan_plan = orig
                del full
            del docs32
            if dev.type == "cuda":
                torch.cuda.empty_cache()

        if args.storage == "f32":
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
