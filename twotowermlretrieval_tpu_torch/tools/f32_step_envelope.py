#!/usr/bin/env python3
"""How far the reference GRU model's first train step moves at f32 compute
when its products change, on the CPU: the envelope that ``chip_smoke.py``
holds the card's f32 first step to, against the CPU's.

The reference configuration (``Config`` defaults: two 2-layer bidirectional
GRU towers, H=256, B=64, dropout off for the comparison, a frozen table)
with ``COMPUTE_DTYPE`` float32 takes one step from a seeded state on the
first packed batch of synthetic triplets (a random ``--vocab`` x 100 table
and passages of 24-159 Zipf-drawn words, as ``chip_smoke.py`` makes its
corpus). The step runs four ways on the host, all plain PyTorch:

- ``f32``: as the port runs it on the CPU;
- ``f64_products``: every ``torch.matmul`` (the recurrent products, the
  input projections, the loss's scores, and through autograd their
  gradients) summed in float64 and rounded to f32: the f32 step's own
  rounding, which the card's kernels (split bf16 products, other orders)
  share in size;
- ``split_products``: the recurrent plain versions' products
  (``ops/rnn_scan.py`` ``_mm``) as the kernels form them at f32
  (``utils/dtypes.py`` ``matmul_split``);
- ``bf16``: the same step at bf16 compute, the lower-precision control an
  f32 envelope must tell apart.

Prints one JSON object: each variant's loss and its distance from
``f32`` (|loss diff|, and the per-leaf gradient norm farthest from it,
relative).

    python3 -m twotowermlretrieval_tpu_torch.tools.f32_step_envelope [--vocab N]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
from pathlib import Path

import numpy as np


def _corpus(vocab: int, seed: int, n_passages: int = 2000):
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(vocab - 1)] + ["<UNK>"])
    table = rng.standard_normal((vocab, 100), dtype=np.float32) * 0.4
    lengths = rng.integers(24, 160, n_passages)
    ids = (rng.zipf(1.2, int(lengths.sum())) - 1) % (vocab - 1)
    ends = np.cumsum(lengths)
    passages = [" ".join(words[ids[e - n : e]]) for e, n in zip(ends, lengths)]
    triplets = [(" ".join(passages[2 * i].split()[:6]), passages[2 * i], passages[2 * i + 1])
                for i in range(n_passages // 2)]
    return {w: i for i, w in enumerate(words.tolist())}, table, triplets


@contextlib.contextmanager
def _f64_products():
    """torch.matmul summed in float64, rounded back to its inputs' dtype."""
    import torch

    plain = torch.matmul

    def matmul(a, b, *args, **kw):
        return plain(a.double(), b.double(), *args, **kw).to(torch.result_type(a, b))

    torch.matmul = matmul
    try:
        yield
    finally:
        torch.matmul = plain


@contextlib.contextmanager
def _split_products():
    from twotowermlretrieval_tpu_torch.ops import rnn_scan
    from twotowermlretrieval_tpu_torch.utils.dtypes import matmul_split

    plain = rnn_scan._mm
    rnn_scan._mm = matmul_split
    try:
        yield
    finally:
        rnn_scan._mm = plain


def _step(cfg, params, packed) -> dict:
    import torch

    from twotowermlretrieval_tpu_torch.data.batching import unpack_batch
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec
    from twotowermlretrieval_tpu_torch.train.train_step import create_train_state, make_train_step

    step = make_train_step(TwoTowerSpec.from_config(cfg), cfg)
    state = create_train_state(torch.Generator().manual_seed(1), params, cfg)
    _, m = step(state, unpack_batch(torch.from_numpy(packed), cfg.max_query_len))
    return {k: float(v) for k, v in m.items()}


def _distance(got: dict, want: dict) -> dict:
    rels = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
            for k in want if k.startswith("grad_norm")}
    worst = max(rels, key=rels.get)
    return {"loss": got["loss"], "loss_err": abs(got["loss"] - want["loss"]),
            "worst_leaf": worst, "worst_grad_norm_rel": rels[worst],
            "median_grad_norm_rel": float(np.median(list(rels.values())))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vocab", type=int, default=20_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.data.batching import TripletBatcher, pack_batch
    from twotowermlretrieval_tpu_torch.data.glove import save_embedding_artifacts
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, init_two_tower
    from twotowermlretrieval_tpu_torch.train.loop import setup

    word_to_idx, table, triplets = _corpus(args.vocab, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        save_embedding_artifacts(Path(tmp), table, word_to_idx)
        cfg = Config(embeddings_path=str(Path(tmp) / "embeddings.npy"),
                     word_to_idx_path=str(Path(tmp) / "word_to_idx.pkl"),
                     length_buckets=[32, 64, 128], epochs=1)
        cfg, tok, table = setup(cfg)
    cfg = cfg.replace(dropout=0.0, log_param_stats=True, compute_dtype="float32")
    batcher = TripletBatcher(triplets, tok, cfg.batch_size, cfg.max_query_len, cfg.max_doc_len,
                             length_buckets=cfg.length_buckets)
    packed = pack_batch(next(batcher.batches(seed=cfg.seed + 1000)))
    params = init_two_tower(torch.Generator().manual_seed(cfg.seed),
                            TwoTowerSpec.from_config(cfg), pretrained_embeddings=table)
    base = _step(cfg, params, packed)
    out = {"rows": int(packed.shape[0]),
           "doc_width": int((packed.shape[1] - cfg.max_query_len - 4) // 2),
           "f32": {"loss": base["loss"]}}
    with _f64_products():
        out["f64_products"] = _distance(_step(cfg, params, packed), base)
    with _split_products():
        out["split_products"] = _distance(_step(cfg, params, packed), base)
    out["bf16"] = _distance(_step(cfg.replace(compute_dtype="bfloat16"), params, packed), base)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
