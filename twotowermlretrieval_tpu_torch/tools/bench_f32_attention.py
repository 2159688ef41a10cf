#!/usr/bin/env python3
"""Time fused attention at f32 compute: ``attention_fwd`` and
``attention_bwd`` with ``compute_dtype="float32"`` at the transformer
tower's shapes (config 5: the doc tower in training, its query tower, a
serving batch) and at T=512 hd=64, f32 inputs, plus one bf16-input case.
Each shape is held against the plain versions (max |diff| as a share of the
plain result's largest magnitude, two calls bit-identical) and timed with
CUDA events (medians of single calls) beside the same shape at bf16
compute, ``scaled_dot_product_attention`` on the same inputs and additive
mask with TF32 off (forward, and forward+backward minus forward), and the
least time the card could take. The backward's two launches are timed
apart by ``torch.profiler`` device time where the profiler reports it.

    python3 twotowermlretrieval_tpu_torch/tools/bench_f32_attention.py [CHECKOUT]
        [--out FILE] [--device cuda]

CHECKOUT: time that checkout's package (default: this one's), so that one
call on one card can time two trees in turns (another commit unpacked
beside this one with ``git archive``): only the public ``attention_fwd``,
``attention_bwd``, their plain versions and ``attention_bound`` are called. Each record is
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
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
HEADS = 8
# (R, T, hd, input dtype): config 5's doc tower in training (B=512 x 8
# heads), its query tower, a serving batch of 16, the widest T at hd=64,
# and the doc tower under a bf16 residual stream
SHAPES = ((4096, 128, 32, "float32"), (4096, 32, 32, "float32"), (128, 32, 32, "float32"),
          (32, 512, 64, "float32"), (4096, 128, 32, "bfloat16"))
CPU_SHAPES = ((16, 16, 8, "float32"), (8, 33, 16, "float32"), (8, 33, 16, "bfloat16"))


def _import_port(checkout: Path):
    sys.path.insert(0, str(checkout))
    import twotowermlretrieval_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parent.parent != checkout:
        raise SystemExit(f"the package came from {pkg.__file__}, not {checkout}")
    from twotowermlretrieval_tpu_torch.ops import attention

    return attention


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


def bound_ms(attention, R: int, T: int, hd: int, in_bytes: int, backward: bool):
    """The least time of one call at f32 compute, and what sets it: the
    checkout's ``attention_bound`` (bytes, and the split products counted
    by operand dtype) at the HBM and bf16 tensor-core rates. (None, None)
    for a checkout whose ``attention_bound`` counts no split products (one
    from before the f32 route ran on the tensor cores)."""
    try:
        nbytes, ops = attention.attention_bound(R, T, hd, in_bytes, backward, "float32")
    except TypeError:
        return None, None
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bwd_kernels_ms(torch, fn, reps=10):
    """Device time a call of each backward launch (the kernels whose names
    hold "bwd_dq" and "bwd_dkv"), by torch.profiler; None where the
    profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        for part in ("bwd_dkv", "bwd_dq"):
            if part in evt.key and part not in out:
                total = getattr(evt, "device_time_total", None)
                if total is None:
                    total = getattr(evt, "cuda_time_total", 0.0)
                out[part] = total / 1e3 / max(evt.count, 1) if total else None
                break
    return {"dq_ms": out.get("bwd_dq"), "dkv_ms": out.get("bwd_dkv")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkout", nargs="?", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    attention = _import_port(Path(args.checkout).resolve())
    import torch
    import torch.nn.functional as F

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to check the harness")
        torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products in the yardstick
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    else:
        card = "the host (plain versions)"
    time_ms = _timer(torch, dev)
    recs = []
    for R, T, hd, in_name in SHAPES if dev.type == "cuda" else CPU_SHAPES:
        in_dtype = getattr(torch, in_name)
        gen = torch.Generator(device=dev).manual_seed(R + T + hd)
        q, k, v, do = (torch.randn((R, T, hd), generator=gen, device=dev) for _ in range(4))
        q, k, v = (t.to(in_dtype) for t in (q, k, v))
        lengths = torch.randint(1, T + 1, (R,), generator=gen, device=dev)
        lengths[:3] = torch.tensor([0, 1, T], device=dev)
        bias = torch.where(torch.arange(T, device=dev)[None, :] < lengths[:, None], 0.0, -1e9)
        scale = float(hd) ** -0.5
        qkvb = (q, k, v, bias)

        def fwd(cdt="float32"):
            return attention.attention_fwd(*qkvb, scale, cdt)

        def bwd(cdt="float32"):
            return attention.attention_bwd(*qkvb, do, scale, cdt)

        with torch.no_grad():
            out, grads = fwd(), bwd()
            r_out = attention.attention_fwd_reference(*qkvb, scale, "float32")
            r_grads = attention.attention_bwd_reference(*qkvb, do, scale, "float32")
            rec = {
                "R": R, "T": T, "hd": hd, "input": in_name, "compute": "float32",
                "fwd_rel_err": ((out - r_out).abs().max() / r_out.abs().max()).item(),
                "bwd_rel_err": max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                                   for a, b in zip(grads, r_grads)),
                "bitwise_repeatable": bool(torch.equal(out, fwd()) and all(
                    torch.equal(a, b) for a, b in zip(grads, bwd()))),
                "fwd_ms": time_ms(fwd),
                "bwd_ms": time_ms(bwd),
                "bf16_compute_fwd_ms": time_ms(lambda: fwd("bfloat16")),
                "bf16_compute_bwd_ms": time_ms(lambda: bwd("bfloat16")),
            }
            del out, grads, r_out, r_grads
        in_bytes = 2 if in_dtype == torch.bfloat16 else 4
        for name, backward in (("fwd", False), ("bwd", True)):
            rec[f"{name}_bound_ms"], rec[f"{name}_bound_by"] = bound_ms(
                attention, R, T, hd, in_bytes, backward)
        # the yardstick: one library call on the same inputs and additive mask
        mask = bias[:, None, :].to(in_dtype)
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, scale=scale)

        with torch.no_grad():
            rec["sdpa_fwd_ms"] = time_ms(sdpa)
        both = time_ms(lambda: torch.autograd.grad(sdpa(), (ql, kl, vl), do.to(in_dtype)))
        rec["sdpa_bwd_ms"] = both - rec["sdpa_fwd_ms"]
        if dev.type == "cuda":
            with torch.no_grad():
                rec.update({f"bwd_{k}": v for k, v in _bwd_kernels_ms(torch, bwd).items()})
            torch.cuda.empty_cache()
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
