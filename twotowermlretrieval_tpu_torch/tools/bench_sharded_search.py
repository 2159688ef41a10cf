#!/usr/bin/env python3
"""Time the sharded exact search against one device: ``RetrievalIndex``
over N x H unit rows (default 1,048,576 x 256, BASELINE config 4's corpus)
without a mesh (D=1) and split over D shards, at B query rows and top-50.

    python -m twotowermlretrieval_tpu_torch.tools.bench_sharded_search
        [--rows 1048576] [--dim 256] [--shards 1 2 4] [--batches 1 16]
        [--storage bfloat16 int8] [--cards] [--iters 20] [--out FILE]
        [--trace DIR]

Without ``--cards`` every shard lives on cuda:0 (D shards of one card);
with it the mesh is the one ``ttr-torch-serve --mesh-data D`` takes
(``build_serving_mesh``: shard s on cuda:s). Per storage, D and B it prints
one JSON line with the median of ``--iters`` calls of:

- ``search_ms``: the whole search (``traced_search``: every shard's scan
  and phase 2, the merge);
- ``scan_ms``: the phase-1 scan kernels alone, one launch a shard
  (``segmax`` for bf16 / f32, ``segmax_s8`` for int8);
- ``shard_search_ms``: shard 0's whole search alone on its device; a
  search near it (and not near D times it) means the shards overlap;
- ``merge_ms``: the merge alone over the shards' [B, k] lists, and
  ``copy_ms``, its copies of the lists to the lead device;
- ``phase2_ms``: search - scan - merge.

Each line with D > 1 also says whether its ids equal the D=1 search's
(when ``--shards`` starts at 1) and how far its scores are, relative.

Each call is timed by CUDA events on the lead device, the other devices'
work joined to its stream before the end event, after a synchronize of
every device. Every line names the cards and their power limits.

With ``--trace DIR`` each line also holds ``trace``: after the timings,
``--trace-reps`` searches run one at a time (every device synchronized
before and after each) inside one ``torch.profiler`` window written under
DIR, after two it leaves out, and :func:`read_search_trace` reads it
back. A kernel or copy on the card belongs to the shard whose scan launch
last preceded its own launch on the host (the last shard's share holds
the merge). The profiler adds its own cost to every launch on the host.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def time_calls(fn, devices, iters: int = 20, warmup: int = 2) -> float:
    """Median ms of ``iters`` single calls of ``fn`` across ``devices``
    (the first is the lead)."""
    lead, others = devices[0], [d for d in dict.fromkeys(devices) if d != devices[0]]
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)
        with torch.cuda.device(lead):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        fn()
        for d in others:  # the lead's stream waits for every other card's work
            with torch.cuda.device(d):
                done = torch.cuda.Event()
                done.record()
            torch.cuda.current_stream(lead).wait_event(done)
        with torch.cuda.device(lead):
            end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def search_breakdown(index, q: torch.Tensor, k: int = 50, iters: int = 20) -> dict:
    """The times of one exact ``RetrievalIndex`` search of the queries
    ``q`` (f32, on the index's lead device): see the module docstring."""
    from twotowermlretrieval_tpu_torch.ops.topk import (
        fused_topk_segmax,
        fused_topk_segmax_s8,
        quantize_query_rows,
        segmax,
        segmax_s8,
    )
    from twotowermlretrieval_tpu_torch.parallel.topk import merge_lists

    mesh = index.mesh
    shards = index._docs if mesh is not None else (index._docs,)
    scales = (index._scales if mesh is not None else (index._scales,)) if index.quantized \
        else (None,) * len(shards)
    devices = list(mesh.shard_devices) if mesh is not None else [index.device]
    rows = shards[0].shape[0]
    n_valid = [min(max(index._n_valid - s * rows, 0), rows) for s in range(len(shards))]
    k = min(k, index.num_docs)
    width = shards[0].shape[1]
    qp = torch.nn.functional.pad(q, (0, width - q.shape[1]))
    if index.quantized:
        q_i8 = [quantize_query_rows(qp)[0].to(d) for d in devices]
        scans = [lambda s=s: segmax_s8(q_i8[s], shards[s]) for s in range(len(shards))]
        shard0 = lambda: fused_topk_segmax_s8(qp, shards[0], scales[0],  # noqa: E731
                                              k=min(k, rows), n_valid=n_valid[0])
    else:
        qs = [qp.to(shards[0].dtype).to(d) for d in devices]
        scans = [lambda s=s: segmax(qs[s], shards[s], n_valid[s]) for s in range(len(shards))]
        shard0 = lambda: fused_topk_segmax(qs[0], shards[0], k=min(k, rows),  # noqa: E731
                                           n_valid=n_valid[0])
    out = {"search_ms": time_calls(lambda: index.traced_search(q, k), devices, iters),
           "scan_ms": time_calls(lambda: [scan() for scan in scans], devices, iters),
           "shard_search_ms": time_calls(shard0, devices, iters)}
    if mesh is not None:
        parts = [shard0() for _ in shards]  # [B, k] lists of the right shape on each device
        parts = [(v.to(d), i.to(d)) for (v, i), d in zip(parts, devices)]
        out["merge_ms"] = time_calls(lambda: merge_lists(parts, k, mesh.lead), devices, iters)
        out["copy_ms"] = time_calls(
            lambda: [(v.to(mesh.lead), i.to(mesh.lead)) for v, i in parts], devices, iters)
    else:
        out["merge_ms"] = out["copy_ms"] = 0.0
    out["phase2_ms"] = out["search_ms"] - out["scan_ms"] - out["merge_ms"]
    return out


_SCAN_KERNEL = "segmax"  # in the name of each shard's scan kernel, and of nothing else


def _median(xs):
    return statistics.median(xs) if xs else None


def read_search_trace(path, searches: int, shards: int, name: str = "sharded search") -> dict:
    """What one trace of ``searches`` searches (each a ``name {i}``
    annotation, run alone) says, medians over them, in ms:

    - ``host_ms``: the annotation's length, the host's time to issue the
      whole search;
    - ``device_span_ms``: from the search's first device event's start to
      its last one's end; ``busy_ms`` and ``busy_share``: the union of the
      device intervals (every card) over that span;
    - ``device_busy_ms``: that union per card, by the trace's device ids;
    - per shard (lists of ``shards``): ``shard_host_ms``, host time from
      its scan's launch to the next shard's (the last: to the annotation's
      end); ``shard_busy_ms``, the device time of what it launched in that
      interval; ``scan_start_ms``, when its scan began on its card, from
      the search's first device event; ``gap_before_scan_ms``, the card's
      idle time between the previous shard's last event on that card and
      this scan (0 for the first shard);
    - ``pre_busy_ms``: device time launched before the first scan (the
      queries' copies and casts);
    - ``host_waits`` and ``host_wait_ms``: the runtime calls inside the
      annotation that wait for a card (``*Synchronize*``, or a copy to the
      host), their count and time.

    Device events pair with their host launches by correlation id. The
    trace's host and device clocks may be offset by milliseconds, so no
    figure mixes them: the host's come from launch and annotation times,
    the cards' from device event times."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launches = {e["args"]["correlation"]: e["ts"] for e in runtime
                if "correlation" in e.get("args", {})}
    to_host = {e["args"].get("correlation") for e in events
               if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]}
    device = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                    key=lambda e: e["ts"])
    marks = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith(name + " ")), key=lambda e: e["ts"])
    if len(marks) != searches:
        raise ValueError(f"{path}: {len(marks)} '{name}' annotations, expected {searches}")
    per = []
    for i, mark in enumerate(marks):
        t0, t_end = mark["ts"], mark["ts"] + mark["dur"]
        t_next = marks[i + 1]["ts"] if i + 1 < len(marks) else float("inf")
        mine = [e for e in device if t0 <= launches.get(e["args"].get("correlation"), -1) < t_next]
        scans = [e for e in mine if _SCAN_KERNEL in e["name"]]
        if len(scans) != shards:
            near = [e["name"][:60] for e in device if t0 <= e["ts"] < t_next]
            raise ValueError(f"{path}: search {i} launched {len(scans)} scans, expected {shards} "
                             f"({len(mine)} device events paired with a launch, {len(near)} in "
                             f"its window: {near[:12]})")
        bounds = [launches[e["args"]["correlation"]] for e in scans] + [t_end]
        owner = []
        for e in mine:
            at = launches[e["args"]["correlation"]]
            owner.append(max((s for s in range(shards) if bounds[s] <= at), default=-1))
        merged, by_card = _union((e["ts"], e["ts"] + e["dur"]) for e in mine), {}
        for e in mine:
            by_card.setdefault(e["args"].get("device", 0), []).append((e["ts"], e["ts"] + e["dur"]))
        d0 = min(e["ts"] for e in mine)
        span = max(e["ts"] + e["dur"] for e in mine) - d0
        waits = [e["dur"] for e in runtime if t0 <= e["ts"] < t_end and (
            "Synchronize" in e["name"] or e.get("args", {}).get("correlation") in to_host)]
        gaps = []
        for s, scan in enumerate(scans):
            card = scan["args"].get("device", 0)
            before = [e["ts"] + e["dur"] for e, o in zip(mine, owner)
                      if o == s - 1 and e["args"].get("device", 0) == card]
            gaps.append(max(scan["ts"] - max(before), 0.0) / 1e3 if s and before else 0.0)
        per.append({
            "host_ms": mark["dur"] / 1e3, "device_span_ms": span / 1e3,
            "busy_ms": _busy(merged) / 1e3, "busy_share": _busy(merged) / max(span, 1e-9),
            "device_busy_ms": {str(c): _busy(_union(iv)) / 1e3 for c, iv in sorted(by_card.items())},
            "shard_host_ms": [(bounds[s + 1] - bounds[s]) / 1e3 for s in range(shards)],
            "shard_busy_ms": [sum(e["dur"] for e, o in zip(mine, owner) if o == s) / 1e3
                              for s in range(shards)],
            "scan_start_ms": [(e["ts"] - d0) / 1e3 for e in scans],
            "gap_before_scan_ms": gaps,
            "pre_busy_ms": sum(e["dur"] for e, o in zip(mine, owner) if o == -1) / 1e3,
            "host_waits": len(waits), "host_wait_ms": sum(waits) / 1e3,
        })
    out = {"searches": searches}
    for key, first in per[0].items():
        if isinstance(first, list):
            out[key] = [_median([p[key][s] for p in per]) for s in range(len(first))]
        elif isinstance(first, dict):
            out[key] = {c: _median([p[key][c] for p in per]) for c in first}
        else:
            out[key] = _median([p[key] for p in per])
    return out


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _busy(merged) -> float:
    return sum(end - start for start, end in merged)


def trace_search(index, q: torch.Tensor, log_dir, k: int = 50, reps: int = 5,
                 warmup: int = 2) -> dict:
    """Trace ``reps`` searches of ``q``, each alone, and read the trace
    (:func:`read_search_trace`). The window opens with ``warmup``
    searches left out of the reading: a window's first launches can miss
    their device events."""
    from twotowermlretrieval_tpu_torch.utils.profiling import annotate, trace, trace_files

    devices = list(dict.fromkeys(index.mesh.devices if index.mesh is not None
                                 else [index.device]))
    shards = len(index._docs) if index.mesh is not None else 1
    index.traced_search(q, k)
    with trace(str(log_dir)):
        for r in range(-warmup, reps):
            for d in devices:
                torch.cuda.synchronize(d)
            with annotate(f"sharded search {r}" if r >= 0 else "warm-up"):
                index.traced_search(q, k)
            for d in devices:
                torch.cuda.synchronize(d)
    return read_search_trace(trace_files(log_dir)[-1], reps, shards)


def card_lines() -> list:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--storage", nargs="+", default=["bfloat16", "int8"])
    ap.add_argument("--cards", action="store_true",
                    help="shard s on cuda:s, as --mesh-data D places them (default: all on cuda:0)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    ap.add_argument("--trace", default=None,
                    help="trace --trace-reps searches a line under this directory and read "
                         "them back (the line's 'trace')")
    ap.add_argument("--trace-reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_sharded_search: no CUDA device", file=sys.stderr)
        return 1

    from twotowermlretrieval_tpu_torch.parallel.mesh import make_device_mesh
    from twotowermlretrieval_tpu_torch.serve.app import build_serving_mesh
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

    cards = card_lines()
    rng = np.random.default_rng(args.seed)
    docs = rng.standard_normal((args.rows, args.dim), dtype=np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q_np = rng.standard_normal((max(args.batches), args.dim), dtype=np.float32)
    q_np /= np.linalg.norm(q_np, axis=1, keepdims=True)
    lines, one_device = [], {}
    for storage in args.storage:
        for D in args.shards:
            if D == 1:
                index = RetrievalIndex(docs, storage, device="cuda:0")
            else:
                mesh = (build_serving_mesh(D, 1, "cuda") if args.cards
                        else make_device_mesh(D, 1, ["cuda:0"] * D))
                index = RetrievalIndex(docs, storage, mesh=mesh)
            devices = [str(d) for d in (index.mesh.devices if D > 1 else [index.device])]
            for B in args.batches:
                q = torch.from_numpy(q_np[:B]).to(index.device)
                line = {"storage": storage, "shards": D, "devices": devices, "B": B,
                        "rows": args.rows, "dim": args.dim,
                        **search_breakdown(index, q, iters=args.iters), "cards": cards}
                vals, ids = (t.cpu() for t in index.traced_search(q, 50))
                if D == 1:
                    one_device[storage, B] = vals, ids
                elif (storage, B) in one_device:
                    o_vals, o_ids = one_device[storage, B]
                    line["ids_equal_one_device"] = bool(torch.equal(ids, o_ids))
                    line["rel_to_one_device"] = float(
                        ((vals - o_vals).abs() / o_vals.abs().clamp(min=1e-30)).max())
                if args.trace:
                    try:
                        line["trace"] = trace_search(index, q, Path(args.trace) /
                                                     f"{storage}_d{D}_b{B}", reps=args.trace_reps)
                    except ValueError as e:  # a trace it cannot read: say so, time the rest
                        line["trace"] = {"error": str(e)}
                print(json.dumps(line), flush=True)
                lines.append(line)
            del index
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(line) + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
