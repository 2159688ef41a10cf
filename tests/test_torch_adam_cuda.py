"""The clip-and-Adam kernel (``csrc/adam.cu`` behind ``ops/adam.py``) on a
card, against the plain loop of ``train/train_step.py``
``apply_clip_and_adam``.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_adam_cuda.py

Three leaf sets: the GRU cell's trainable leaves, config 5's (its two
400,000 x 100 tables among them), and odd sizes (1, 3, 1,023 elements, a
gradient that is an unaligned view, one that is transposed, a zero one).
Each takes three consecutive updates with a gradient norm above the clip
and below it, on the card and on CPU copies.
"""

import numpy as np
import pytest
import torch

from twotowermlretrieval_tpu_torch.config import Config
from twotowermlretrieval_tpu_torch.data.batching import Batch
from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec
from twotowermlretrieval_tpu_torch.ops import adam
from twotowermlretrieval_tpu_torch.tools.bench_adam import leaf_params
from twotowermlretrieval_tpu_torch.train import train_step as ts
from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device
from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves, tree_map

pytestmark = pytest.mark.cuda

STEPS = 3
NORMS = {"above_clip": 5.0, "below_clip": 0.5}  # the configs clip at 1.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")  # also turns TF32 off


def _leaf_set(which, dev):
    """(params on the card, config) of a leaf set: "gru" and "config5" are
    ``configs/msmarco_inbatch.json``'s (the table frozen) and
    ``configs/transformer_tp.json``'s (both tables trainable) at full
    width, as ``tools/bench_adam.py`` times them."""
    if which == "odd":
        gen = torch.Generator(device=dev).manual_seed(5)
        shapes = {"a": (1,), "b": (3,), "c": (1023,), "d": (5, 3), "z": (64,)}
        params = {"t": {k: torch.randn(s, generator=gen, device=dev) for k, s in shapes.items()}}
        return params, Config(lr=1e-2, freeze_embeddings=False)
    return leaf_params(which, dev, seed=11)


def _grads(state, which, norm, step):
    """CPU gradients in leaf order with a global norm of ``norm``; in the
    odd set "c" an unaligned view, "d" a transposed one, "z" zero."""
    gen = torch.Generator().manual_seed(100 + step)
    out = []
    for name, p in named_leaves(state.trainable):
        g = torch.randn(p.shape, generator=gen, dtype=torch.float64)
        if name.endswith("/z"):
            g.zero_()
        out.append(g)
    total = float(torch.sqrt(sum((g * g).sum() for g in out)))
    return [(g * (norm / total)).float() for g in out]


def _on_card(name, g, dev):
    if name.endswith("/c"):  # 4 bytes past a 16-byte boundary
        buf = torch.empty(g.numel() + 1, device=dev)
        buf[1:] = g.to(dev)
        return buf[1:]
    if name.endswith("/d"):
        return g.to(dev).T.contiguous().T
    return g.to(dev)


def _states(which, dev):
    params, cfg = _leaf_set(which, dev)
    card = ts.create_train_state(torch.Generator(device=dev), params, cfg)
    host = ts.create_train_state(torch.Generator(), tree_map(lambda p: p.cpu(), params), cfg)
    return card, host, cfg


def _compare(card, host):
    for tree in ("trainable", "mu", "nu"):
        a = card.trainable if tree == "trainable" else card.opt_state[tree]
        b = host.trainable if tree == "trainable" else host.opt_state[tree]
        for (name, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
            np.testing.assert_allclose(x.detach().cpu().numpy(), y.detach().numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{tree} {name}")


@pytest.mark.parametrize("regime", sorted(NORMS))
@pytest.mark.parametrize("which", ["gru", "config5", "odd"])
def test_kernel_matches_the_cpu_loop(dev, which, regime):
    card, host, cfg = _states(which, dev)
    launches = adam.clip_and_adam.launches
    names = [n for n, _ in named_leaves(host.trainable)]
    for step in range(STEPS):
        grads = _grads(host, which, NORMS[regime], step)
        gnorm = ts.apply_clip_and_adam(card, [_on_card(n, g, dev) for n, g in zip(names, grads)],
                                       cfg)
        ref = ts.apply_clip_and_adam(host, grads, cfg)
        assert gnorm.device.type == "cuda" and gnorm.dim() == 0
        np.testing.assert_allclose(float(gnorm), float(ref), rtol=1e-6)
    torch.cuda.synchronize()
    assert isinstance(card.leaf_table, adam.LeafTable)
    assert adam.clip_and_adam.launches - launches == 2 * STEPS
    assert int(card.opt_state["count"]) == STEPS == int(host.opt_state["count"])
    _compare(card, host)


def test_sharded_leaves_square_sums_go_through_the_group_sum(dev, monkeypatch):
    """The model axis: a sharded leaf's square sum is summed over the group
    and a replicated leaf's counts once, as in ``global_norm_sharded``. The
    group's sum is a stand-in of two ranks that hold the same shards (it
    doubles what it is given), on the card and on the CPU loop alike."""
    monkeypatch.setattr(ts, "psum_", lambda t, group: t.mul_(2))
    monkeypatch.setattr(ts, "psum", lambda t, group: t * 2)
    card, host, cfg = _states("odd", dev)
    names = [n for n, _ in named_leaves(host.trainable)]
    sharded = [n.endswith(("/a", "/c", "/z")) for n in names]
    group = object()
    for step in range(STEPS):
        grads = _grads(host, "odd", NORMS["above_clip"], step)
        gnorm = ts.apply_clip_and_adam(card, [_on_card(n, g, dev) for n, g in zip(names, grads)],
                                       cfg, group, sharded)
        ref = ts.apply_clip_and_adam(host, grads, cfg, group, sharded)
        want = sum(float((g.double() ** 2).sum()) * (2 if s else 1)
                   for g, s in zip(grads, sharded)) ** 0.5
        np.testing.assert_allclose(float(gnorm), want, rtol=1e-6)
        np.testing.assert_allclose(float(gnorm), float(ref), rtol=1e-6)
    assert isinstance(card.leaf_table, adam.LeafTable)
    _compare(card, host)


@pytest.mark.parametrize("which", ["gru", "odd"])
def test_below_the_clip_the_kernel_gives_the_card_loops_bits(dev, which, monkeypatch):
    """Below the clip the scale is exactly 1, so the only sums are the
    norm's; the elementwise arithmetic is the loop's, operation for
    operation: every bit equals the loop's on the card."""
    card, loop, cfg = _states(which, dev)
    loop = ts.create_train_state(torch.Generator(device=dev),
                                 tree_map(lambda p: p.to(dev), ts.merge_params(loop.trainable,
                                                                               loop.frozen)),
                                 cfg)
    names = [n for n, _ in named_leaves(card.trainable)]
    real = adam.table_for
    for step in range(STEPS):
        grads = [_on_card(n, g, dev)
                 for n, g in zip(names, _grads(card, which, NORMS["below_clip"], step))]
        ts.apply_clip_and_adam(card, grads, cfg)
        monkeypatch.setattr(adam, "table_for", lambda *a, **k: None)
        ts.apply_clip_and_adam(loop, grads, cfg)
        monkeypatch.setattr(adam, "table_for", real)
    for tree in ("trainable", "mu", "nu"):
        a = card.trainable if tree == "trainable" else card.opt_state[tree]
        b = loop.trainable if tree == "trainable" else loop.opt_state[tree]
        for (name, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
            assert torch.equal(x, y), f"{tree} {name}"


def test_repeated_updates_give_the_same_bits(dev):
    """The square sums' order is fixed: two tables over copies of the same
    leaves, fed the same gradients, stay bit for bit equal."""
    a, _, cfg = _states("config5", dev)
    b = ts.create_train_state(torch.Generator(device=dev),
                              ts.merge_params(a.trainable, a.frozen), cfg)
    names = [n for n, _ in named_leaves(a.trainable)]
    for step in range(2):
        grads = [_on_card(n, g, dev)
                 for n, g in zip(names, _grads(a, "config5", NORMS["above_clip"], step))]
        na = ts.apply_clip_and_adam(a, grads, cfg)
        nb = ts.apply_clip_and_adam(b, grads, cfg)
        assert torch.equal(na, nb)
    for (name, x), (_, y) in zip(named_leaves(a.opt_state["nu"]), named_leaves(b.opt_state["nu"])):
        assert torch.equal(x, y), name


def test_a_gru_train_step_does_not_synchronize(dev):
    """A whole in-batch GRU step (forward, backward, clip and Adam) under
    ``set_sync_debug_mode("error")``: no call waits for the card."""
    params, cfg = leaf_params("gru", dev, vocab=1000, seed=3)
    state = ts.create_train_state(torch.Generator(device=dev).manual_seed(1), params, cfg)
    step = ts.make_train_step(TwoTowerSpec.from_config(cfg), cfg)
    gen = torch.Generator(device=dev).manual_seed(2)
    B, Lq, Ld = 64, cfg.max_query_len, 64

    def batch():
        tok = lambda L: torch.randint(1, 1000, (B, L), generator=gen, device=dev,
                                      dtype=torch.int32)
        ln = lambda L: torch.randint(1, L + 1, (B,), generator=gen, device=dev,
                                     dtype=torch.int32)
        return Batch(tok(Lq), ln(Lq), tok(Ld), ln(Ld), tok(Ld), ln(Ld),
                     torch.ones(B, device=dev))

    warm, checked = batch(), batch()
    step(state, warm)  # builds the kernels and the leaf table
    torch.cuda.synchronize()
    launches = adam.clip_and_adam.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, checked)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert adam.clip_and_adam.launches - launches == 2
    assert torch.isfinite(metrics["grad_norm"]) and int(state.opt_state["count"]) == 2


@pytest.mark.parametrize("fault", ["bfloat16", "transposed"])
def test_leaves_the_kernel_does_not_take_raise_on_the_card(dev, fault):
    """The plain loop never runs on a card: a bf16 state, or a param that
    is not contiguous, raises naming the leaf, and nothing is updated."""
    params, cfg = _leaf_set("odd", dev)
    state = ts.create_train_state(torch.Generator(device=dev), params, cfg)
    if fault == "bfloat16":
        state.trainable = tree_map(lambda p: p.detach().bfloat16(), state.trainable)
        want = "param t/a is torch.bfloat16"
    else:
        state.trainable["t"]["d"] = state.trainable["t"]["d"].detach().T.contiguous().T
        want = "param t/d is torch.float32, not contiguous"
    before = [p.clone() for _, p in named_leaves(state.trainable)]
    grads = [torch.ones_like(p) for p in before]
    with pytest.raises(ValueError, match=want):
        ts.apply_clip_and_adam(state, grads, cfg)
    assert state.leaf_table is None and int(state.opt_state["count"]) == 0
    for (name, p), b in zip(named_leaves(state.trainable), before):
        assert torch.equal(p, b), name
