#!/usr/bin/env python3
"""A/B the recurrent backward variants and the training knobs on the card.

The port's twin of the JAX package's ``tools/bench_rnn_variants.py``, at
its shapes (the reference architecture: GRU H=256, 2 bidirectional
layers, B=64; the query tower T=32 over 64 rows, the doc tower T=128 over
the 128 rows of positives and negatives). Modes:

- ``kernels``: one layer's backward three ways: ``rnn_layer_bwd`` (the
  combined kernel, dW accumulated inside it), ``rnn_layer_bwd_hoisted``
  (one split-mode launch for both directions, dW as one product outside)
  and ``rnn_layer_bwd_split_full`` (one split-mode launch a direction);
- ``step``: the whole train step under ``TTMR_RNN_BWD_PLAN`` ``--plan``
  (combined or hoisted);
- ``history``: the train step with ``TTMR_RNN_HISTORY`` f32 against cdt,
  both arms in one process, each set explicitly while its steps run;
- ``negskip`` (alias ``transformer``): the train step with
  ``TRIPLET_METRICS`` on against off under the in-batch loss, for config
  5's transformer (``--tower transformer``, the fused attention kernels,
  B=512) or the reference GRU towers (``--tower rnn``, B=1024).

Times come from CUDA events over windows of repeated calls (the host
clock with ``--device cpu``); A/B arms alternate their windows so that
drift hits both alike. Without a card and without ``--device cpu`` the
tool raises.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

H, D = 256, 2
SHAPES = {"query": (32, 64), "doc": (128, 128)}  # name -> (T, B_rows)
QUERY_LEN, DOC_LEN, VOCAB = 32, 128, 50_000  # the step modes' batches
_GATES = {"GRU": 3, "LSTM": 4, "RNN": 1}


def log(msg):
    print(msg, flush=True)


def _timer(dev):
    """``timed(fn, n) -> seconds`` for n calls of fn on the device."""
    import torch

    if dev.type != "cuda":
        def timed(fn, n):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return time.perf_counter() - t0
        return timed

    def timed(fn, n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    return timed


def _alternating_windows(variants, run, n_long, n_rounds=7):
    """Timed windows alternating between variants so drift hits all
    equally; returns {name: [per-call times]}: each window of ``n_long``
    calls less the best short window of 5, over ``n_long - 5``."""
    for name in variants:
        run(name, 5)
        run(name, n_long)  # warm both window lengths before timing
    base = {name: min(run(name, 5) for _ in range(3)) for name in variants}
    per = {name: [] for name in variants}
    for _ in range(n_rounds):
        for name in variants:
            per[name].append(max(run(name, n_long) - base[name], 1e-9) / (n_long - 5))
    return per


def _report(label, B, per, unit_digits=3):
    for name, ts in per.items():
        med = float(np.median(ts))
        log(f"{label} [{name}, B={B}]: {med * 1e3:.{unit_digits}f} ms/step ({B / med:.0f} ex/s; "
            "windows " + ", ".join(f"{t * 1e3:.2f}" for t in ts) + ")")


def bench_kernels(cell, dev, n_long=45):
    """One layer's backward at each shape: combined, hoisted, split."""
    import torch

    from twotowermlretrieval_tpu_torch.ops.rnn_scan import (
        rnn_layer_bwd,
        rnn_layer_bwd_hoisted,
        rnn_layer_bwd_split_full,
        rnn_layer_fwd,
    )

    rng = np.random.default_rng(0)
    gh = _GATES[cell] * H

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    impls = {"combined": rnn_layer_bwd, "hoisted": rnn_layer_bwd_hoisted,
             "split": rnn_layer_bwd_split_full}
    out = {}
    for name, (T, B) in SHAPES.items():
        xps = tuple(t(rng.standard_normal((T, B, gh)) * 0.3) for _ in range(D))
        lengths = rng.integers(T // 2, T + 1, (B,))
        mask = t(np.arange(T)[:, None] < lengths[None, :])
        w = t(rng.standard_normal((D, H, gh)) * 0.05)
        b = t(rng.standard_normal((D, gh)) * 0.05)
        with torch.no_grad():
            outs, c_hist, _ = rnn_layer_fwd(cell, xps, mask, w, b)
        douts = tuple(t(rng.standard_normal((T, B, H))) for _ in range(D))
        dhf = t(rng.standard_normal((D, B, H)))
        timed = _timer(dev)

        def run(impl, n):
            return timed(lambda: impls[impl](cell, xps, mask, w, b, outs, c_hist, douts, dhf), n)

        per = _alternating_windows(impls, run, n_long)
        med = {k: float(np.median(v)) for k, v in per.items()}
        log(f"{cell} {name} [T={T}, rows={B}] bwd: combined {med['combined'] * 1e3:.3f} ms | "
            f"hoisted {med['hoisted'] * 1e3:.3f} ms | split {med['split'] * 1e3:.3f} ms")
        out[name] = med
    return out


def _toks(rng, n, mx, mean, vocab):
    L = np.clip(rng.normal(mean, mean / 3, n).astype(np.int32), 2, mx)
    t = rng.integers(1, vocab, (n, mx)).astype(np.int32)
    for i, l in enumerate(L):
        t[i, l:] = 0
    return t, L


def _batch(rng, B, vocab, dev):
    """A batch on the device with MS MARCO-like lengths (queries ~7
    tokens, passages ~60), as the training loop ships it (packed)."""
    import torch

    from twotowermlretrieval_tpu_torch.data.batching import Batch, pack_batch, unpack_batch

    batch = Batch(*_toks(rng, B, QUERY_LEN, 7, vocab), *_toks(rng, B, DOC_LEN, 60, vocab),
                  *_toks(rng, B, DOC_LEN, 60, vocab), np.ones((B,), np.float32))
    return unpack_batch(torch.from_numpy(pack_batch(batch)).to(dev), QUERY_LEN)


def _gru_config_and_batch(B, dev):
    """The headline setup (reference architecture, MS MARCO-like lengths)
    shared by the step/history/negskip modes."""
    from twotowermlretrieval_tpu_torch.config import Config

    rng = np.random.default_rng(0)
    table = (rng.standard_normal((VOCAB, 100)) * 0.1).astype(np.float32)
    config = Config(
        vocab_size=VOCAB, embed_dim=100, hidden_dim=H, num_layers=2,
        bidirectional=True, dropout=0.2, batch_size=B, lr=5e-5, margin=0.5,
        loss_type="triplet", max_query_len=QUERY_LEN, max_doc_len=DOC_LEN,
        compute_dtype="bfloat16", freeze_embeddings=True,
    )
    return config, table, _batch(rng, B, VOCAB, dev)


def _stepper(config, table, batch, dev):
    """``step()``: one train step of a fresh state on ``batch``."""
    import torch

    from twotowermlretrieval_tpu_torch.models.two_tower import (
        TwoTowerSpec,
        init_two_tower,
        to_device,
    )
    from twotowermlretrieval_tpu_torch.train.train_step import (
        create_train_state,
        make_train_step,
    )

    spec = TwoTowerSpec.from_config(config)
    params = init_two_tower(torch.Generator().manual_seed(0), spec, pretrained_embeddings=table)
    state = create_train_state(torch.Generator(device=dev).manual_seed(1),
                               to_device(params, dev), config)
    step_fn = make_train_step(spec, config)

    def step():
        nonlocal state
        state, _ = step_fn(state, batch)

    return step


def _with_env(name, value, fn):
    """``fn`` with the environment variable ``name`` set to ``value``
    (unset for None) while it runs, restored after."""
    def run():
        old = os.environ.get(name)
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
        try:
            fn()
        finally:
            if old is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = old
    return run


def _ab_steps(arms, dev, n_long, n_rounds=7):
    """Alternating windows over the arms ({name: step()}); per-step times."""
    timed = _timer(dev)
    return _alternating_windows(arms, lambda name, n: timed(arms[name], n), n_long, n_rounds)


def bench_full_step(plan, B, dev, n_long=45):
    config, table, batch = _gru_config_and_batch(B, dev)
    step = _with_env("TTMR_RNN_BWD_PLAN", None if plan == "combined" else plan,
                     _stepper(config, table, batch, dev))
    per = _ab_steps({plan: step}, dev, n_long, n_rounds=5)
    _report("full step", B, per)
    return per


def bench_history(B, dev, n_long=45):
    """TTMR_RNN_HISTORY f32 against cdt in one process; both arms set the
    variable explicitly (unset means cdt under bf16 compute)."""
    config, table, batch = _gru_config_and_batch(B, dev)
    arms = {name: _with_env("TTMR_RNN_HISTORY", name, _stepper(config, table, batch, dev))
            for name in ("f32", "cdt")}
    per = _ab_steps(arms, dev, n_long)
    _report("history", B, per)
    return per


def bench_negskip(tower, B, dev):
    """TRIPLET_METRICS on/off under the in-batch loss, where the explicit
    negative only feeds the triplet metrics; off skips its doc-tower pass
    ([B] instead of [2B] rows). ``tower='transformer'``: config 5's
    architecture (configs/transformer_tp.json, B=512, a learned 400k
    table) on one card, its attention through the fused kernels;
    ``tower='rnn'``: the reference GRU towers, in-batch loss, B=1024."""
    from twotowermlretrieval_tpu_torch.config import Config

    if tower == "transformer":
        B = B or 512
        vocab = 400_000
        base = Config(
            vocab_size=vocab, embed_dim=100, hidden_dim=256, num_layers=6,
            tower_type="transformer", num_heads=8, ffn_dim=1024, dropout=0.1,
            batch_size=B, lr=1e-4, margin=0.5, loss_type="in_batch",
            temperature=0.05, max_query_len=32, max_doc_len=128,
            compute_dtype="bfloat16", freeze_embeddings=False,
            residual_dtype="bfloat16", fused_attention=True,
        )
        batch = _batch(np.random.default_rng(1), B, vocab, dev)
        table = None
    else:
        B = B or 1024
        base, table, batch = _gru_config_and_batch(B, dev)
        base = base.replace(loss_type="in_batch")
    arms = {name: _stepper(base.replace(triplet_metrics=flag), table, batch, dev)
            for name, flag in (("neg-encoded", True), ("neg-skipped", False))}
    per = _ab_steps(arms, dev, n_long=10 if tower == "transformer" else 15, n_rounds=5)
    _report(tower, B, per, unit_digits=2)
    return per


def main(argv=None):
    ap = argparse.ArgumentParser(description="A/B the recurrent backward variants and "
                                             "training knobs")
    ap.add_argument("--mode",
                    choices=["kernels", "step", "history", "negskip", "transformer"],
                    default="kernels")  # "transformer" = alias of negskip
    ap.add_argument("--tower", choices=["transformer", "rnn"], default="transformer")
    ap.add_argument("--cell", default="GRU", choices=sorted(_GATES))
    ap.add_argument("--plan", choices=["combined", "hoisted"], default="combined")
    ap.add_argument("--batch", type=int, default=0,
                    help="0 = per-mode default (64 for step/history, "
                         "512/1024 for negskip transformer/rnn)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions; checks "
                         "the harness, times nothing of the card)")
    args = ap.parse_args(argv)
    from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device

    dev = resolve_device(args.device)
    if args.mode == "kernels":
        return bench_kernels(args.cell, dev)
    if args.mode == "history":
        return bench_history(args.batch or 64, dev)
    if args.mode in ("negskip", "transformer"):
        return bench_negskip(args.tower, args.batch, dev)
    return bench_full_step(args.plan, args.batch or 64, dev)


if __name__ == "__main__":
    main()
