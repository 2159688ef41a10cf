#!/usr/bin/env python3
"""Time the training step's clip and Adam on a card: ``csrc/adam.cu``
(``train/train_step.py`` ``apply_clip_and_adam`` over f32 leaves on the
card) against its bytes bound and against the plain loop on the same
leaves, for the GRU towers of ``configs/msmarco_inbatch.json`` (table
frozen) and config 5's transformer towers (``configs/transformer_tp.json``,
both 400,000 x 100 tables trainable).

Each record: the leaves and elements, the launches a call, the mean of a
call by CUDA events over back-to-back calls (the step count's add
included), the host's enqueue time a call, each kernel's device time by
``torch.profiler``, and the least time the card could take: 32 bytes an
element (the gradient read twice, params and both moments read and
written) at 3.35 TB/s. The plain loop's call synchronizes twice (its bias
corrections) and is timed the same way.

    python3 -m twotowermlretrieval_tpu_torch.tools.bench_adam [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from twotowermlretrieval_tpu_torch.config import Config
from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, init_two_tower
from twotowermlretrieval_tpu_torch.ops import adam
from twotowermlretrieval_tpu_torch.train.train_step import apply_clip_and_adam, create_train_state
from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves, tree_map

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)
BYTES_PER_ELEMENT = 32
VOCAB, EMBED = 400_000, 100  # GloVe 6B 100d's shape
ROOT = Path(__file__).resolve().parents[2]
CONFIGS = {"gru": "msmarco_inbatch.json", "config5": "transformer_tp.json"}


def leaf_params(name: str, dev: torch.device, vocab: int = VOCAB, seed: int = 0):
    """(params on ``dev``, config) of a training leaf set: ``name`` a key
    of :data:`CONFIGS`, its word table ``vocab`` x 100 drawn from N(0, 0.4^2)."""
    cfg = Config.from_dict(json.loads((ROOT / "configs" / CONFIGS[name]).read_text()))
    cfg = cfg.replace(vocab_size=vocab, embed_dim=EMBED)
    table = np.random.default_rng(seed).normal(0, 0.4, (vocab, EMBED)).astype(np.float32)
    params = init_two_tower(torch.Generator().manual_seed(seed), TwoTowerSpec.from_config(cfg),
                            table)
    return tree_map(lambda p: p.to(dev), params), cfg


def _state(name: str, dev: torch.device):
    params, cfg = leaf_params(name, dev)
    return create_train_state(torch.Generator(device=dev), params, cfg), cfg


def _time(state, grads, cfg, iters: int):
    """(ms a call by CUDA events, host ms a call)."""
    apply_clip_and_adam(state, grads, cfg)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host = 0.0
    start.record()
    for _ in range(iters):
        t0 = time.perf_counter()
        apply_clip_and_adam(state, grads, cfg)
        host += time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, 1e3 * host / iters


def _device_ms(state, grads, cfg, iters: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            apply_clip_and_adam(state, grads, cfg)
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / 1e3 / iters for e in prof.key_averages()
            if "adam" in e.key}


def bench(name: str, dev: torch.device, iters: int = 50) -> dict:
    state, cfg = _state(name, dev)
    leaves = [p for _, p in named_leaves(state.trainable)]
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = [torch.randn(p.shape, generator=gen, device=dev) * 1e-3 for p in leaves]
    elements = sum(p.numel() for p in leaves)
    before = adam.clip_and_adam.launches
    apply_clip_and_adam(state, grads, cfg)
    rec = {"leaves": name, "n_leaves": len(leaves), "elements": elements,
           "kernel_launches_a_call": adam.clip_and_adam.launches - before,
           "bound_ms": 1e3 * BYTES_PER_ELEMENT * elements / HBM_BYTES_PER_S}
    rec["ms"], rec["host_ms"] = _time(state, grads, cfg, iters)
    rec["device_ms"] = _device_ms(state, grads, cfg, 10)
    real = adam.table_for
    adam.table_for = lambda *a, **k: None  # the plain loop on the same leaves
    try:
        rec["loop_ms"], rec["loop_host_ms"] = _time(state, grads, cfg, max(3, iters // 10))
    finally:
        adam.table_for = real
    rec["bound_share"] = rec["bound_ms"] / sum(rec["device_ms"].values())
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_adam times a card: no CUDA device")
    dev = torch.device("cuda", 0)
    recs = []
    for name in CONFIGS:
        recs.append({"card": torch.cuda.get_device_name(dev), **bench(name, dev)})
        print(json.dumps(recs[-1]), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
