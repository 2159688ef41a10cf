#!/usr/bin/env python3
"""Time the recurrent kernels where W streams through shared memory: the
forward (``rnn_layer_fwd``) and the backward (``rnn_layer_bwd``) at widths
whose W_hh columns a CTA cannot hold, beside the reference towers' width
(H=256, W resident) as a control. Each record holds the plan, the
CUDA-event median of single calls (the L2 is not flushed: the layer's W is
read again every step anyway), the time a step, the W bytes one CTA draws a
step and the rate that gives each SM, the least time the card could take
(bytes at 3.35 TB/s or operations at 989 TFLOP/s; an f32-compute product
counts as the six bf16 products of its split, 164.8 TFLOP/s), cuDNN's time for the
same cell, width and batch (``nn.GRU`` / ``nn.LSTM`` / ``nn.RNN``, forward,
and forward+backward minus forward, in bf16 where cuDNN takes it, else
fp16; at f32 compute also cuDNN in f32 with TF32 off, the same function as
the kernels'), the largest difference from the plain version, and a SHA-256
of the outputs' bytes, so two checkouts' bits can be compared.

    python3 twotowermlretrieval_tpu_torch/tools/bench_rnn_stream.py [CHECKOUT]
        [--layouts | --phases | --step-phases | --device-times] [--out FILE]
        [--device cuda]

CHECKOUT: time that checkout's package (default: this one's), so that one
call on one card can time two trees in turns (another commit unpacked
beside this one with ``git archive``): only the public ``rnn_layer_fwd``,
``rnn_layer_bwd``, their plain versions, the bounds and the plan functions
are called. ``--layouts`` also times each streamed shape under every
layout its pass can take (the W ring's depth and width, one or two row
blocks, clusters of 8 or 16, and the forward's W resident in clusters of
16 where it fits; where the plan is a large-batch layout, those instead:
``_wide_layouts``, and for the backward ``_bwd_wide_layouts``), the plan's
own marked, each with its digest: it needs a
checkout whose plans carry a ring (``wstages``). At f32 compute it times
every shape so, the backward under whole layouts (rows, the dhp row block
whole or in chunks, W resident or streamed, staging buffers), whose sums
may differ from the plan's. Each record is printed as
a JSON line and, with ``--out``, written as a JSON list. ``--phases``
instead splits single calls (``PHASE_SHAPES``: at f32 compute, and the
in-batch doc tower's bf16 backward) into their launches by torch.profiler's
device time: the forward's W packing and
time loop; the backward's operand split, gate recompute, W packing, dh
chain, weight gradient and fixed-order sum, each the mean over
``PHASE_CALLS`` calls. ``--step-phases`` instead splits both passes'
time loops (``STEP_PHASE_SHAPES``, bf16) into the phases of a step, from the
instrumented builds of ``csrc/rnn_bwd.cu`` and ``csrc/rnn_fwd.cu``
(``-DRNN_BWD_PHASES``, ``-DRNN_FWD_PHASES``: clock64() stamps of CTA
thread 0 at block-wide points, libraries of their own beside the shipped
ones): the backward's inputs (the staging wait; the large-batch
layout's L2 prefetch and first loads), the gate math, the wait for the
peers' last product (one row block), the push (the large-batch layout:
starting its bulk copies), the cluster barrier (the large-batch layout:
the wait for the peers' copies) and the product; the forward's inputs
(xp and the mask), the product, the wait for the peers' reads of the
one h row block, the gate math with its history writes, the push (the
large-batch layout: its bulk copies' start) and the barrier (the
large-batch layout: the waits for the peers' copies),
each in us a step, for the plan and for the cluster route forced (the
plan before the large-batch layout), beside both calls' CUDA-event time
and the plain call's device time by torch.profiler (taken after the
phases: a profiling session slows later launches);
this checkout only. ``--device-times`` instead gives each large-batch
forward shape of ``SHAPES`` (B >= 256) its call's CUDA-event time beside
the card's own time of its launches (torch.profiler, taken after the event
times), so that the host's work before a launch is told apart from the
kernel's; any checkout. ``--device cpu`` runs the plain versions at toy
sizes on the host clock: a check of the harness, whose times say nothing
about a card. Each record
also gives its plan's waves: ceil(2 x clusters / the clusters of its size
the card holds at once), each wave a whole time loop; a backward record at
B >= 256 also gives the chain's shared memory a CTA at larger row blocks
(``smem_by_rows``: 2 staging buffers, W resident and two dhp row blocks,
as its plan at 32 rows; and the dhp row block exchanged in 64-column
chunks), the rows that bound it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
# an f32-precision product on the tensor cores: the six bf16 products of
# its operands' split (utils/dtypes.py SPLIT_PRODUCTS)
SPLIT_FLOPS = BF16_FLOPS / 6
GATES = {"GRU": 3, "LSTM": 4, "RNN": 1}
# (pass, cell, H, B, T, compute dtype[, history dtype]): the reference
# towers at twice their width, a wide GRU at serving, training and export
# batches, the widest layers the JAX package keeps on its kernels, the
# f32-compute route (both passes, the reference towers' training shapes,
# and a wide forward where 8 rows a CTA, half an m16 tile, leave W a
# wider ring than 16); the reference towers themselves (W resident) as
# controls, with the compute dtype's history and (TTMR_RNN_HISTORY=f32)
# an f32 one
SHAPES = (
    ("fwd", "GRU", 512, 64, 32, "bfloat16"), ("fwd", "GRU", 512, 128, 128, "bfloat16"),
    ("fwd", "GRU", 1024, 16, 32, "bfloat16"), ("fwd", "GRU", 1024, 64, 32, "bfloat16"),
    ("fwd", "GRU", 1024, 1024, 128, "bfloat16"), ("fwd", "LSTM", 1536, 16, 32, "bfloat16"),
    ("fwd", "RNN", 3072, 16, 32, "bfloat16"), ("fwd", "GRU", 1024, 64, 32, "float32"),
    ("bwd", "GRU", 512, 64, 32, "bfloat16"), ("bwd", "GRU", 1024, 64, 32, "bfloat16"),
    ("bwd", "GRU", 1792, 16, 32, "bfloat16"), ("bwd", "LSTM", 1536, 16, 32, "bfloat16"),
    ("bwd", "RNN", 3072, 16, 32, "bfloat16"),
    ("fwd", "GRU", 256, 64, 32, "bfloat16"), ("fwd", "GRU", 256, 128, 128, "bfloat16"),
    ("bwd", "GRU", 256, 64, 32, "bfloat16"), ("bwd", "GRU", 256, 128, 128, "bfloat16"),
    ("bwd", "GRU", 1024, 64, 32, "float32"),
    ("fwd", "GRU", 256, 64, 32, "float32"), ("fwd", "GRU", 256, 128, 128, "float32"),
    ("bwd", "GRU", 256, 64, 32, "float32"), ("bwd", "GRU", 256, 128, 128, "float32"),
    ("fwd", "RNN", 3072, 16, 32, "float32"),
    ("fwd", "GRU", 256, 64, 32, "bfloat16", "float32"),
    ("fwd", "GRU", 256, 128, 128, "bfloat16", "float32"),
    ("bwd", "GRU", 256, 64, 32, "bfloat16", "float32"),
    ("bwd", "GRU", 256, 128, 128, "bfloat16", "float32"),
    # the large batches: the reference towers' export (T=128) and in-batch
    # training (T=32) batch of 1024, both passes, and a wide GRU's export
    ("fwd", "GRU", 256, 1024, 128, "bfloat16"), ("fwd", "GRU", 256, 1024, 32, "bfloat16"),
    ("bwd", "GRU", 256, 1024, 128, "bfloat16"), ("bwd", "GRU", 256, 1024, 32, "bfloat16"),
    ("fwd", "GRU", 512, 1024, 128, "bfloat16"),
    # more of the forward's large-batch layouts (W resident, one h row
    # block): the other cells at the export batch, the widest GRU they take
    # at B=512 and 1024, twice the export batch, and RNN at B=256
    ("fwd", "LSTM", 256, 1024, 32, "bfloat16"), ("fwd", "RNN", 256, 1024, 32, "bfloat16"),
    ("fwd", "GRU", 384, 512, 32, "bfloat16"), ("fwd", "GRU", 384, 1024, 32, "bfloat16"),
    ("fwd", "GRU", 256, 2048, 32, "bfloat16"), ("fwd", "RNN", 640, 256, 32, "bfloat16"),
    # the backward's large-batch layouts: one rank of two (B=512) and of
    # four (B=256) of in-batch training, and the other cells at B=1024
    ("bwd", "GRU", 256, 512, 128, "bfloat16"), ("bwd", "GRU", 256, 256, 32, "bfloat16"),
    ("bwd", "LSTM", 256, 1024, 32, "bfloat16"), ("bwd", "RNN", 256, 1024, 32, "bfloat16"),
)
# --phases: single calls split into their launches: at f32 compute, and
# the in-batch doc tower's backward at bf16 (B=1024 T=128)
PHASE_SHAPES = (("fwd", "GRU", 1024, 64, 32, "float32"), ("bwd", "GRU", 1024, 64, 32, "float32"),
                ("fwd", "GRU", 256, 128, 128, "float32"), ("bwd", "GRU", 256, 128, 128, "float32"),
                ("bwd", "GRU", 256, 1024, 128, "bfloat16"))
PHASE_CALLS = 5
# --step-phases: (pass, cell, H, B, T) at bf16 with a bf16 history: the
# backward at the reference towers' training query shape and the in-batch
# doc tower's; the forward at the served query (B=16), the training query
# (B=64), the export and in-batch doc tower (B=1024 T=128), and the other
# cells at the export batch
STEP_PHASE_SHAPES = (("bwd", "GRU", 256, 64, 32), ("bwd", "GRU", 256, 1024, 128),
                     ("fwd", "GRU", 256, 16, 32), ("fwd", "GRU", 256, 64, 32),
                     ("fwd", "GRU", 256, 1024, 128), ("fwd", "RNN", 256, 1024, 32),
                     ("fwd", "LSTM", 256, 1024, 32))
CPU_SHAPES = (("fwd", "GRU", 24, 5, 6, "bfloat16"), ("fwd", "LSTM", 40, 3, 4, "float32"),
              ("bwd", "GRU", 24, 5, 6, "bfloat16"), ("bwd", "RNN", 16, 3, 4, "bfloat16"),
              ("fwd", "GRU", 512, 3, 2, "bfloat16"), ("bwd", "GRU", 1024, 3, 2, "bfloat16"))
# the ring's widths and depths --layouts tries (with each layout's largest
# depth that fits)
LAYOUT_WIDTHS = (32, 64, 96, 128, 160, 192, 224, 256, 320, 384, 512)
LAYOUT_DEPTHS = (1, 2, 3)


def _import_port(checkout: Path):
    sys.path.insert(0, str(checkout))
    import twotowermlretrieval_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parent.parent != checkout:
        raise SystemExit(f"the package came from {pkg.__file__}, not {checkout}")
    from twotowermlretrieval_tpu_torch.ops import rnn_scan

    return rnn_scan


def _timer(torch, dev):
    if dev.type == "cpu":
        def time_ms(fn, reps=2, warmup=1):
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


def digest(torch, tensors) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _inputs(torch, cell, H, B, T, cdt, dev, seed):
    """Per-direction xp, ragged lengths (0, 1 and T among them), W_hh and
    b_hh at torch.nn.GRU's init scale, in the compute dtype."""
    G = GATES[cell]
    gen = torch.Generator(device=dev).manual_seed(seed)
    lim = 1.0 / math.sqrt(H)
    dt = getattr(torch, cdt)
    xps = [(torch.randn((T, B, G * H), generator=gen, device=dev) * 0.5).to(dt)
           for _ in range(2)]
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
    lengths[: min(3, B)] = torch.tensor([0, 1, T][: min(3, B)], device=dev)
    mask = (torch.arange(T, device=dev)[:, None] < lengths[None, :]).float()
    w_hh = ((torch.rand((2, H, G * H), generator=gen, device=dev) * 2 - 1) * lim).to(dt)
    b_hh = (torch.rand((2, G * H), generator=gen, device=dev) * 2 - 1) * lim
    return xps, mask, w_hh, b_hh


def _bound(nbytes, flops, split=False):
    """(ms, "bytes" | "operations"): the larger of the bytes at the memory
    rate and the operations at the bf16 rate, or (``split``: f32 compute)
    a sixth of it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (SPLIT_FLOPS if split else BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# torch.profiler's kernel names -> the phase of a call they run
_PHASES = (("pack_w", "W packing"), ("split", "operand split"), ("gemm_f32<0", "gate recompute"),
           ("gemm_f32<1", "weight gradient"), ("gemm<0", "gate recompute"),
           ("gemm<1", "weight gradient"), ("gemm_bf16<0", "gate recompute"),
           ("gemm_bf16<1", "weight gradient"), ("chain", "dh chain"),
           ("reduce", "fixed-order sum"), ("rnn_fwd_kernel", "time loop"))


def _phase_of(name: str) -> str:
    return next((label for key, label in _PHASES if key in name), name[:60])


def _phases(torch, rnn_scan, dev, card):
    """PHASE_SHAPES' single calls split into their launches (device ms a
    call, by torch.profiler) beside the CUDA-event median of the call."""
    from torch.profiler import ProfilerActivity, profile

    time_ms = _timer(torch, dev)
    recs = []
    for seed, (which, cell, H, B, T, cdt) in enumerate(PHASE_SHAPES):
        xps, mask, w_hh, b_hh = _inputs(torch, cell, H, B, T, cdt, dev, seed)
        if which == "fwd":
            def call():
                return rnn_scan.rnn_layer_fwd(cell, xps, mask, w_hh, b_hh, cdt, True)
        else:
            outs, c_hist, _ = rnn_scan.rnn_layer_fwd_reference(cell, xps, mask, w_hh, b_hh,
                                                               cdt, True)
            gen = torch.Generator(device=dev).manual_seed(seed + 100)
            douts = [torch.randn((T, B, H), generator=gen, device=dev).to(outs[0].dtype)
                     for _ in range(2)]
            d_hfinal = torch.randn((2, B, H), generator=gen, device=dev)

            def call():
                return rnn_scan.rnn_layer_bwd(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts,
                                              d_hfinal, cdt)
        with torch.no_grad():
            ms = time_ms(call)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(PHASE_CALLS):
                    call()
                torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
                label = _phase_of(e.key)
                parts[label] = parts.get(label, 0.0) + e.self_device_time_total / 1e3 / PHASE_CALLS
        rec = {"pass": which, "cell": cell, "H": H, "B": B, "T": T, "compute": cdt, "ms": ms,
               "device_ms": sum(parts.values()), "phases_ms": parts, "card": card}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def _cudnn_ms(torch, time_ms, cell, H, B, T, dev, backward: bool, f32: bool = False):
    """cuDNN over one bidirectional layer of the cell (input width 2H, the
    second layer's), in bf16 where cuDNN takes bf16, else fp16 (``f32``:
    in f32, TF32 off as ``main`` sets it): the forward, or forward+backward
    minus forward. Returns (ms, dtype name); (None, None) on the host."""
    if dev.type != "cuda":
        return None, None
    dt = torch.float32 if f32 else torch.bfloat16
    if not torch.backends.cudnn.is_acceptable(torch.empty(1, device=dev, dtype=dt)):
        dt = torch.float16
    make = {"GRU": torch.nn.GRU, "LSTM": torch.nn.LSTM, "RNN": torch.nn.RNN}[cell]
    layer = make(2 * H, H, num_layers=1, bidirectional=True).to(dev, dt)
    x = torch.randn((T, B, 2 * H), device=dev, dtype=dt, requires_grad=backward)
    if not backward:
        with torch.no_grad():
            return time_ms(lambda: layer(x)), str(dt).replace("torch.", "")
    g = torch.randn((T, B, 2 * H), device=dev, dtype=dt)
    fwd = time_ms(lambda: layer(x))
    both = time_ms(lambda: torch.autograd.backward(layer(x)[0], g))
    return both - fwd, str(dt).replace("torch.", "")


def _w_bytes_a_step(cell, plan, cb):
    """W bytes one CTA draws from L2 a step: its G*hc columns of all H rows
    (forward) or its hc rows of all G*H columns (backward); 0 where W is
    resident."""
    if plan["resident"]:
        return 0
    return plan["H"] * GATES[cell] * plan["hc"] * cb


def _sizes_and_rows(rnn_scan, Hk, B, cb, slots, base):
    """(cluster size and columns, rows) pairs --layouts tries: per cluster
    size, the plan's rows, the least rows the plans take at this batch and
    the fewest rows whose clusters (both directions) all fit on the card at
    once, where a CTA holds them."""
    cands = (16, 32, 64, 128) if cb == 2 else (8, 16, 32, 64)
    least = cands[0] if B <= cands[0] else cands[1]
    out = []
    for nc, hc in rnn_scan._cluster_sizes(Hk, slots):
        held = [R for R in cands if _units(R, hc) <= 32]
        wave = [R for R in held if R >= least and 2 * -(-B // R) <= slots[nc]]
        for R in sorted({base["rows"], least, cands[0], *wave[:1]} & set(held)):
            out.append(((nc, hc), R))
    return out


def _units(R, hc):
    """The (16 x 8) output units of a chain CTA of R rows and hc columns
    (8 rows count as one unit's); a CTA holds 32."""
    return -(-R // 16) * (hc // 8)


def _fwd_layouts(rnn_scan, cell, B, cdt, slots, base):
    """Every forward layout --layouts times: per cluster size and rows
    (:func:`_sizes_and_rows`), W resident where it fits, and each ring
    width and depth with two or one h row blocks; at f32 each with W f32
    and again in its bf16 pieces (``wsplit``) where that fits."""
    cb = 2 if cdt == "bfloat16" else 4
    Hk = base["H"]
    kp = -(-Hk // 32) * 32
    out = []
    for (nc, hc), R in _sizes_and_rows(rnn_scan, Hk, B, cb, slots, base):
        common = dict(base, nc=nc, hc=hc, rows=R, clusters=-(-B // R), slots=slots[nc])
        if "wsplit" in base:  # W f32 here; its pieces below
            common["wsplit"] = False
        smem = rnn_scan._fwd_smem_bytes(cell, Hk, cb, R, hc, kp)
        if smem <= rnn_scan._SMEM_LIMIT:
            out.append(dict(common, kc=kp, resident=True, wstages=0, blocks=2, smem=smem))
        for blocks in (2, 1):
            for kc in LAYOUT_WIDTHS if cb == 2 else (16, 48) + LAYOUT_WIDTHS:
                if kc >= kp:
                    continue
                fits = [s for s in range(2, 9) if rnn_scan._fwd_smem_bytes(
                    cell, Hk, cb, R, hc, kc, s, blocks) <= rnn_scan._SMEM_LIMIT]
                if fits and blocks == 1 and rnn_scan._fwd_smem_bytes(
                        cell, Hk, cb, R, hc, kc, fits[-1], 2) <= rnn_scan._SMEM_LIMIT:
                    fits = fits[-1:]  # one block where two hold the same ring: its deepest
                for s in sorted({d for d in LAYOUT_DEPTHS if d in fits} | set(fits[-1:])):
                    out.append(dict(common, kc=kc, resident=False, wstages=s, blocks=blocks,
                                    smem=rnn_scan._fwd_smem_bytes(cell, Hk, cb, R, hc, kc, s,
                                                                  blocks)))
    if cb == 4 and "wsplit" in base:  # f32: each layout again with W in its bf16 pieces
        for lay in list(out):
            smem = rnn_scan._fwd_smem_bytes(cell, Hk, cb, lay["rows"], lay["hc"], lay["kc"],
                                            lay["wstages"], lay["blocks"], True)
            if smem <= rnn_scan._SMEM_LIMIT:
                out.append(dict(lay, wsplit=True, smem=smem))
    return out


def _wide_layouts(rnn_scan, cell, B, slots, base):
    """The forward's large-batch layouts --layouts times (bf16, W resident,
    the h row block as one region a CTA; a checkout that has them): per
    cluster size, every row count a CTA of the large-batch units holds
    whose clusters take that size's fewest waves."""
    Hk = base["H"]
    kp = -(-Hk // 32) * 32
    out = []
    for nc, hc in rnn_scan._cluster_sizes(Hk, slots):
        rows = [R for R in range(16, 257, 16)
                if _units(R, hc) <= rnn_scan._UNITS_WIDE and R <= -(-B // 16) * 16
                and rnn_scan._fwd_smem_bytes(cell, Hk, 2, R, hc, kp, 0, 1, wide=True)
                <= rnn_scan._SMEM_LIMIT]
        if not rows:
            continue
        waves = {R: -(-2 * -(-B // R) // slots[nc]) for R in rows}
        for R in rows:
            if waves[R] == min(waves.values()):
                out.append(dict(base, nc=nc, hc=hc, rows=R, clusters=-(-B // R),
                                slots=slots[nc], wsplit=False, wide=True, kc=kp,
                                resident=True, wstages=0, blocks=1,
                                regions=rnn_scan._fwd_regions(Hk, hc), xld=hc,
                                smem=rnn_scan._fwd_smem_bytes(cell, Hk, 2, R, hc, kp, 0, 1,
                                                              wide=True)))
    return out


def _bwd_wide_layouts(rnn_scan, cell, B, hist, slots, base):
    """The backward's large-batch layouts --layouts times (bf16, W
    resident, one dhp row block, nothing staged; a checkout that has
    them): per cluster size, every row count of ``_WIDE_BWD_ROWS`` a CTA
    holds, each with the plan's order of the sums (so the bits stay)."""
    Hk = base["H"]
    kp = -(-GATES[cell] * Hk // 16) * 16
    out = []
    for nc, hc in rnn_scan._cluster_sizes(Hk, slots):
        for R in rnn_scan._WIDE_BWD_ROWS:
            smem = rnn_scan._bwd_smem_bytes(cell, Hk, 2, hist.itemsize, R, hc, kp, 0, 1)
            if (hc % 16 or _units(R, hc) > 32 or R > -(-B // 32) * 32
                    or smem > rnn_scan._SMEM_LIMIT):
                break
            out.append(dict(base, nc=nc, hc=hc, rows=R, clusters=-(-B // R), slots=slots[nc],
                            smem=smem))
    return out


def _device_ms(torch, call, calls=PHASE_CALLS):
    """The card's time of one call: torch.profiler's device time of its
    launches, the mean over ``calls`` calls (the CUDA-event time of a call
    also holds the host's work before its launches, where the card waits)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls


def _device_times(torch, rnn_scan, dev, card):
    """--device-times (module docstring)."""
    time_ms = _timer(torch, dev)
    shapes = [(seed, s) for seed, s in enumerate(SHAPES) if s[0] == "fwd" and s[3] >= 256
              and len(s) == 6 and s[5] == "bfloat16"]
    calls, recs = [], []
    for seed, (_, cell, H, B, T, cdt) in shapes:
        xps, mask, w_hh, b_hh = _inputs(torch, cell, H, B, T, cdt, dev, seed)

        def call(_a=(cell, xps, mask, w_hh, b_hh, cdt, True)):
            return rnn_scan.rnn_layer_fwd(*_a)
        with torch.no_grad():
            rec = {"pass": "fwd", "cell": cell, "H": H, "B": B, "T": T, "compute": cdt,
                   "ms": time_ms(call), "card": card}
        calls.append(call)
        recs.append(rec)
    for rec, call in zip(recs, calls):  # a profiling session slows every later launch
        with torch.no_grad():
            rec["device_ms"] = _device_ms(torch, call)
        print(json.dumps(rec), flush=True)
    return recs


def _step_phases(torch, rnn_scan, dev, card):
    """STEP_PHASE_SHAPES' time loops split into a step's phases (module
    docstring), for the plan and for the cluster route forced."""
    time_ms = _timer(torch, dev)
    recs, later = [], []
    for seed, (which, cell, H, B, T) in enumerate(STEP_PHASE_SHAPES):
        cdt = "bfloat16"
        xps, mask, w_hh, b_hh = _inputs(torch, cell, H, B, T, cdt, dev, seed)
        if which == "fwd":
            names, nwords = rnn_scan.FWD_PHASE_NAMES, rnn_scan.FWD_PHASE_WORDS
            plan_fn, wide_name = rnn_scan.fwd_plan, "_wide_plan"
            fargs = (cell, xps, mask, w_hh, b_hh, cdt, True)

            def call(phases=None, _a=fargs):
                return rnn_scan.rnn_layer_fwd(*_a, phases=phases)
        else:
            names, nwords = rnn_scan.BWD_PHASE_NAMES, rnn_scan.BWD_PHASE_WORDS
            plan_fn, wide_name = rnn_scan.bwd_plan, "_bwd_wide_plan"
            outs, c_hist, _ = rnn_scan.rnn_layer_fwd_reference(cell, xps, mask, w_hh, b_hh,
                                                               cdt, True)
            gen = torch.Generator(device=dev).manual_seed(seed + 100)
            douts = [torch.randn((T, B, H), generator=gen, device=dev).to(outs[0].dtype)
                     for _ in range(2)]
            d_hfinal = torch.randn((2, B, H), generator=gen, device=dev)
            bargs = (cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal, cdt)

            def call(phases=None, _a=bargs):
                if phases is None:
                    return rnn_scan.rnn_layer_bwd(*_a)
                return rnn_scan._bwd_call(*_a, split=False, phases=phases)
        slots = rnn_scan.cluster_slots(which, cell, cdt, torch.bfloat16, dev)
        wide_fn = getattr(rnn_scan, wide_name)
        for route in ("plan", "cluster route"):
            if route == "cluster route":
                setattr(rnn_scan, wide_name, lambda *a, **k: None)
            try:
                plan = plan_fn(cell, T, B, H, 2, cdt, torch.bfloat16, slots)
                buf = torch.zeros(2 * plan["nc"] * plan["clusters"] * nwords,
                                  dtype=torch.int64, device=dev)
                with torch.no_grad():
                    ms = time_ms(call)
                    ms_phased = time_ms(lambda: call(buf))
                    buf.zero_()
                    call(buf)
                    torch.cuda.synchronize()
            finally:
                setattr(rnn_scan, wide_name, wide_fn)
            words = buf.view(-1, nwords).double().cpu()
            cycles, loop, ns = words[:, :len(names)], words[:, len(names)], words[:, -1]
            ns_a_cycle = ns / loop  # each CTA's own clock over its loop
            us = (cycles * ns_a_cycle[:, None]).mean(dim=0) / T / 1e3
            rec = {"pass": which, "cell": cell, "H": H, "B": B, "T": T, "compute": cdt,
                   "history": cdt, "route": route,
                   "plan": {k: plan[k] for k in _PLAN_KEYS if k in plan},
                   "waves": -(-2 * plan["clusters"] // plan["slots"]), "ms": ms,
                   "ms_instrumented": ms_phased,
                   "loop_us_a_step": float(ns.mean() / T / 1e3),
                   "phases_us_a_step": {n: float(v) for n, v in zip(names, us)},
                   "phases_share": {n: float(v) for n, v in
                                    zip(names, (cycles / loop[:, None]).mean(dim=0))},
                   "sm_ghz": float((loop / ns).mean()), "card": card}
            recs.append(rec)
            later.append((rec, call, wide_name, wide_fn, route))
    # the device times last: a profiling session slows every later launch
    for rec, call, wide_name, wide_fn, route in later:
        if route == "cluster route":
            setattr(rnn_scan, wide_name, lambda *a, **k: None)
        try:
            with torch.no_grad():
                rec["device_ms"] = _device_ms(torch, call)
        finally:
            setattr(rnn_scan, wide_name, wide_fn)
        print(json.dumps(rec), flush=True)
    return recs


def _bwd_layouts(rnn_scan, cell, H, cdt, hist, slots, base):
    """Every backward layout --layouts times: the plan's chunk kc kept (it
    orders the sums), its staging buffers and row blocks, each piece width
    and ring depth, per cluster size that holds the layer."""
    if base["resident"]:
        return []
    cb = 2 if cdt == "bfloat16" else 4
    Hk, R, kc = base["H"], base["rows"], base["kc"]
    out = []
    for nc, hc in rnn_scan._cluster_sizes(Hk, slots):
        if _units(R, hc) > 32:
            continue
        for kw in sorted({w for w in LAYOUT_WIDTHS if w < kc} | {kc}):
            if kw < kc and kw % (32 if cb == 2 else 16):
                continue

            def smem(s, _hc=hc, _kw=kw):
                return rnn_scan._bwd_smem_bytes(cell, Hk, cb, hist.itemsize, R, _hc, kc,
                                                base["stages"], base["blocks"], base["xc"], s,
                                                _kw)
            fits = [s for s in range(1, 9) if smem(s) <= rnn_scan._SMEM_LIMIT]
            for s in sorted({d for d in LAYOUT_DEPTHS if d in fits} | set(fits[-1:])):
                out.append(dict(base, nc=nc, hc=hc, slots=slots[nc], kw=kw, wstages=s,
                                smem=smem(s)))
    return out


def _bwd_f32_layouts(rnn_scan, cell, B, hist, slots, base):
    """Every backward layout at f32 compute --layouts times (whose sums
    may differ from the plan's, unlike the bf16 rings): per cluster size
    and rows (32, 16, 8 where a CTA holds them), the dhp row block whole
    (two blocks or one; W resident, or streamed in the widest chunks that
    fit and its ring) or exchanged in the widest chunks that fit, with one
    or two staging buffers."""
    Hk, hb = base["H"], hist.itemsize
    kp = -(-GATES[cell] * Hk // 16) * 16
    lim = rnn_scan._SMEM_LIMIT

    def smem(R, hc, kc, st, bl, xc, S=0, kw=None):
        return rnn_scan._bwd_smem_bytes(cell, Hk, 4, hb, R, hc, kc, st, bl, xc, S, kw)

    out = []
    for nc, hc in rnn_scan._cluster_sizes(Hk, slots):
        for R in (32, 16, 8):
            if _units(R, hc) > 32:
                continue
            common = dict(base, nc=nc, hc=hc, rows=R, clusters=-(-B // R), slots=slots[nc])
            for chunked in (False, True):
                for bl in ((2,) if chunked else (2, 1)):
                    for resident in ((False,) if chunked else (True, False)):
                        for st in (2, 1):
                            if chunked:
                                xc = kp - 16
                                while xc >= 16 and smem(R, hc, xc, st, 2, xc) > lim:
                                    xc -= 16
                                kc = xc
                            elif resident:
                                xc = kc = kp
                            else:
                                xc, kc = kp, kp - 16
                                while kc >= 16 and smem(R, hc, kc, st, bl, xc) > lim:
                                    kc -= 16
                            if kc < 16 or smem(R, hc, kc, st, bl, xc) > lim:
                                continue
                            if resident:
                                out.append(dict(common, kc=kc, xc=xc, resident=True, stages=st,
                                                blocks=bl, wstages=0, kw=kc,
                                                smem=smem(R, hc, kc, st, bl, xc)))
                                continue
                            ring = rnn_scan._bwd_ring(cell, Hk, 4, hb, R, hc, kc, st, bl, xc)
                            if ring is not None:
                                kw, S, st2, bl2, sm = ring
                                out.append(dict(common, kc=kc, xc=xc, resident=False, stages=st2,
                                                blocks=bl2, wstages=S, kw=kw, smem=sm))
    return [dict(t) for t in {tuple(sorted(d.items())) for d in out}]


_PLAN_KEYS = ("nc", "hc", "rows", "clusters", "kc", "resident", "wstages", "blocks", "stages",
              "xc", "kw", "nsplit", "smem", "slots", "wsplit", "wide", "db_rows", "khalf",
              "regions", "xld")


def _bwd_smem_by_rows(rnn_scan, cell, plan, cb, hb):
    """The backward chain's shared memory a CTA at the plan's columns and
    larger row blocks: {rows: [whole dhp row block, W resident, two
    blocks and two staging buffers; the row block exchanged in chunks of
    64 columns, W streamed in the same chunks]}, beside the limit."""
    Hk, hc = plan["H"], plan["hc"]
    out = {}
    for R in (32, 48, 64, 96, 128, 160):
        whole = rnn_scan._bwd_smem_bytes(cell, Hk, cb, hb, R, hc, 1 << 30, 2, 2)
        chunked = rnn_scan._bwd_smem_bytes(cell, Hk, cb, hb, R, hc, 64, 2, 2, 64)
        out[R] = [whole, chunked]
    out["limit"] = rnn_scan._SMEM_LIMIT
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkout", nargs="?", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--layouts", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--step-phases", action="store_true")
    ap.add_argument("--device-times", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rnn_scan = _import_port(Path(args.checkout).resolve())
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to check the harness")
        torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products in the plain version
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    else:
        card = "the host (plain versions)"
    if args.phases or args.step_phases or args.device_times:
        if dev.type != "cuda":
            raise SystemExit("--phases, --step-phases and --device-times read the card's own "
                             "time: they need a CUDA device")
        mode = _phases if args.phases else _step_phases if args.step_phases else _device_times
        recs = mode(torch, rnn_scan, dev, card)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(recs, indent=1))
        return 0
    time_ms = _timer(torch, dev)
    recs = []
    for seed, shape in enumerate(SHAPES if dev.type == "cuda" else CPU_SHAPES):
        which, cell, H, B, T, cdt, *hdt = shape
        G = GATES[cell]
        cb = 2 if cdt == "bfloat16" else 4
        # the history: the compute dtype's (the model's), unless the shape names another
        hist = getattr(torch, hdt[0] if hdt else cdt)
        compact = hist == getattr(torch, cdt)
        xps, mask, w_hh, b_hh = _inputs(torch, cell, H, B, T, cdt, dev, seed)
        slots = (rnn_scan.cluster_slots(which, cell, cdt, hist, dev) if dev.type == "cuda"
                 else rnn_scan.H100_SXM_CLUSTER_SLOTS)
        plan_fn = rnn_scan.fwd_plan if which == "fwd" else rnn_scan.bwd_plan
        plan = plan_fn(cell, T, B, H, 2, cdt, hist, slots)
        rec = {"pass": which, "cell": cell, "H": H, "B": B, "T": T, "compute": cdt,
               "history": str(hist).replace("torch.", ""),
               "plan": {k: plan[k] for k in _PLAN_KEYS if k in plan},
               "waves": -(-2 * plan["clusters"] // plan["slots"])}
        if which == "bwd" and B >= 256:
            rec["smem_by_rows"] = _bwd_smem_by_rows(rnn_scan, cell, plan, cb, hist.itemsize)
        with torch.no_grad():
            if which == "fwd":
                def call():
                    return rnn_scan.rnn_layer_fwd(cell, xps, mask, w_hh, b_hh, cdt, compact)

                def flat(res):
                    return [*res[0], *res[1], res[2]]
                plain = flat(rnn_scan.rnn_layer_fwd_reference(cell, xps, mask, w_hh, b_hh, cdt,
                                                              compact))
                nbytes, flops = rnn_scan.rnn_fwd_bound(T, B, H, 2, G, cb, hist.itemsize)
            else:
                # the history from the plain forward: the same in every checkout
                outs, c_hist, _ = rnn_scan.rnn_layer_fwd_reference(cell, xps, mask, w_hh, b_hh,
                                                                   cdt, compact)
                gen = torch.Generator(device=dev).manual_seed(seed + 100)
                douts = [torch.randn((T, B, H), generator=gen, device=dev).to(hist)
                         for _ in range(2)]
                d_hfinal = torch.randn((2, B, H), generator=gen, device=dev)
                bargs = (cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal, cdt)

                def call():
                    return rnn_scan.rnn_layer_bwd(*bargs)

                def flat(res):
                    return [*res[0], res[1], res[2]]
                plain = flat(rnn_scan.rnn_layer_bwd_reference(*bargs))
                nbytes, flops = rnn_scan.rnn_bwd_bound(T, B, H, 2, G, cb, hist.itemsize)
            got = flat(call())
            rec["digest"] = digest(torch, got)
            rec["bitwise_repeatable"] = digest(torch, flat(call())) == rec["digest"]
            rec["max_abs_err"] = max((a.float() - b.float()).abs().max().item()
                                     for a, b in zip(got, plain))
            rec["ms"] = time_ms(call)
        rec["step_us"] = rec["ms"] / T * 1e3
        rec["w_bytes_cta_step"] = _w_bytes_a_step(cell, plan, cb)
        rec["gb_s_per_sm"] = rec["w_bytes_cta_step"] / (rec["step_us"] * 1e-6) / 1e9
        rec["bound_ms"], rec["bound_by"] = _bound(nbytes, flops, split=cdt == "float32")
        rec["cudnn_ms"], rec["cudnn_dtype"] = _cudnn_ms(torch, time_ms, cell, H, B, T, dev,
                                                        which == "bwd")
        if cdt == "float32":
            rec["cudnn_f32_ms"] = _cudnn_ms(torch, time_ms, cell, H, B, T, dev, which == "bwd",
                                            f32=True)[0]
        wide = plan.get("wide", False)
        if args.layouts and (H > 256 or cdt == "float32" or wide):
            if wide and which == "bwd":
                layouts = _bwd_wide_layouts(rnn_scan, cell, B, hist, slots, plan)
            elif wide:
                layouts = _wide_layouts(rnn_scan, cell, B, slots, plan)
            elif which == "fwd":
                layouts = _fwd_layouts(rnn_scan, cell, B, cdt, slots, plan)
            elif cdt == "float32":
                layouts = _bwd_f32_layouts(rnn_scan, cell, B, hist, slots, plan)
            else:
                layouts = _bwd_layouts(rnn_scan, cell, H, cdt, hist, slots, plan)
            rec["layouts"] = []
            for lay in layouts:
                setattr(rnn_scan, f"{which}_plan", lambda *a, _lay=lay, **k: _lay)
                try:
                    with torch.no_grad():
                        d = digest(torch, flat(call()))
                        ms = time_ms(call, reps=10, warmup=2)
                finally:
                    setattr(rnn_scan, f"{which}_plan", plan_fn)
                rec["layouts"].append({
                    "plan": {k: lay[k] for k in _PLAN_KEYS if k in lay}, "ms": ms,
                    "waves": -(-2 * lay["clusters"] // lay["slots"]),
                    "step_us": ms / T * 1e3,
                    "chosen": all(lay.get(k) == plan.get(k) for k in _PLAN_KEYS),
                    "same_bits": d == rec["digest"]})
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        recs.append(rec)
        del xps, mask, w_hh, b_hh
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
