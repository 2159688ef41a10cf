"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)
"""

import math

import pytest
import torch

from twotowermlretrieval_tpu_torch.ops.rnn_scan import (
    _bwd_hoisted_call,
    _bwd_reference,
    _hoisted_weight_grad,
    rnn_layer_bwd,
    rnn_layer_bwd_reference,
    rnn_layer_bwd_split_full,
    rnn_layer_fwd,
    rnn_layer_fwd_reference,
)
from twotowermlretrieval_tpu_torch.ops.topk import (
    NEG_INF,
    fused_topk_segmax,
    segmax,
    segmax_reference,
    topk_oracle,
)
from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device

pytestmark = pytest.mark.cuda

_GATES = {"GRU": 3, "LSTM": 4, "RNN": 1}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")  # also turns TF32 off


def _rnn_case(dev, cell, D, T, B, H, seed):
    G = _GATES[cell]
    gen = torch.Generator(device=dev).manual_seed(seed)
    lim = 1.0 / math.sqrt(H)
    xps = [torch.randn((T, B, G * H), generator=gen, device=dev) * 0.5 for _ in range(D)]
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
    lengths[:3] = torch.tensor([0, 1, T], device=dev)
    mask = (torch.arange(T, device=dev)[:, None] < lengths[None, :]).float()
    w_hh = (torch.rand((D, H, G * H), generator=gen, device=dev) * 2 - 1) * lim
    b_hh = (torch.rand((D, G * H), generator=gen, device=dev) * 2 - 1) * lim
    return xps, mask, w_hh, b_hh


@pytest.mark.parametrize("cell", ["GRU", "LSTM", "RNN"])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("H,B", [(256, 16), (128, 40), (320, 3)])
def test_rnn_kernel_matches_plain_version_f32(dev, cell, D, H, B):
    """f32 compute: the same arithmetic with the products summed in another
    order, so atol 1e-4 over 12 steps. H=320 runs more columns than
    threads; B=40 and B=3 leave a partial block of batch rows."""
    args = _rnn_case(dev, cell, D, 12, B, H, seed=D * 10 + B)
    before = rnn_layer_fwd.launches
    outs, c_hist, fin = rnn_layer_fwd(cell, *args, compute_dtype="float32")
    assert rnn_layer_fwd.launches == before + 1
    r_outs, r_c, r_fin = rnn_layer_fwd_reference(cell, *args, compute_dtype="float32")
    torch.testing.assert_close(fin, r_fin, rtol=0, atol=1e-4)
    for a, b in zip(outs + c_hist, r_outs + r_c):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    assert (fin[:, 0] == 0).all() and all((o[:, 0] == 0).all() for o in outs)


@pytest.mark.parametrize("cell", ["GRU", "LSTM", "RNN"])
@pytest.mark.parametrize("history_in_cdt", [False, True])
def test_rnn_kernel_matches_plain_version_bf16(dev, cell, history_in_cdt):
    """bf16 compute at the serving shape. Both round h to bf16 before each
    step's product; a last-bit difference in the f32 sums can move a value
    across a bf16 rounding boundary, which changes that operand by one
    bf16 ulp (<= 2^-8 for |h| < 1). Hence atol 2e-3 on h_final and one
    ulp-sized 1e-2 on the history (relative 2^-6 for the LSTM cell state,
    which may exceed 1)."""
    args = _rnn_case(dev, cell, 2, 32, 16, 256, seed=7)
    outs, c_hist, fin = rnn_layer_fwd(
        cell, *args, compute_dtype="bfloat16", history_in_cdt=history_in_cdt
    )
    r_outs, r_c, r_fin = rnn_layer_fwd_reference(
        cell, *args, compute_dtype="bfloat16", history_in_cdt=history_in_cdt
    )
    assert outs[0].dtype == (torch.bfloat16 if history_in_cdt else torch.float32)
    torch.testing.assert_close(fin, r_fin, rtol=0, atol=2e-3)
    for a, b in zip(outs, r_outs):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=1e-2)
    for a, b in zip(c_hist, r_c):
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -6, atol=1e-2)


def test_rnn_wrapper_rejects_bad_shapes(dev):
    xps, mask, w_hh, b_hh = _rnn_case(dev, "GRU", 2, 4, 4, 32, seed=0)
    with pytest.raises(ValueError):
        rnn_layer_fwd("GRU", xps, mask[:, :3], w_hh, b_hh)
    with pytest.raises(ValueError):
        rnn_layer_fwd("GRU", xps, mask.cpu(), w_hh, b_hh)


def _bwd_case(dev, cell, D, T, B, H, seed, cdt="float32", history_in_cdt=False):
    """Forward inputs, the plain forward's history and random cotangents
    (in the history's dtype, as the autograd Function delivers them)."""
    xps, mask, w_hh, b_hh = _rnn_case(dev, cell, D, T, B, H, seed)
    outs, c_hist, _ = rnn_layer_fwd_reference(cell, xps, mask, w_hh, b_hh, cdt, history_in_cdt)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    douts = [torch.randn((T, B, H), generator=gen, device=dev).to(outs[0].dtype)
             for _ in range(D)]
    d_hfinal = torch.randn((D, B, H), generator=gen, device=dev)
    return xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal


@pytest.mark.parametrize("cell", ["GRU", "LSTM", "RNN"])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("H,B", [(256, 16), (128, 40), (320, 3)])
def test_rnn_bwd_kernel_matches_plain_version_f32(dev, cell, D, H, B):
    """f32 compute: the same arithmetic summed in another order over 12
    steps (dW over 12 * B outer products)."""
    args = _bwd_case(dev, cell, D, 12, B, H, seed=D * 10 + B)
    before = rnn_layer_bwd.launches
    dxps, dw, db = rnn_layer_bwd(cell, *args, compute_dtype="float32")
    assert rnn_layer_bwd.launches == before + 1
    r_dxps, r_dw, r_db = rnn_layer_bwd_reference(cell, *args, compute_dtype="float32")
    for a, b in zip(dxps, r_dxps):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dw, r_dw, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(db, r_db, rtol=1e-4, atol=1e-3)
    # the zero-length row 0 and the masked steps get no gate cotangent
    assert all((d[:, 0] == 0).all() for d in dxps)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("cell", ["GRU", "LSTM", "RNN"])
@pytest.mark.parametrize("history_in_cdt", [False, True])
def test_rnn_bwd_kernel_matches_plain_version_bf16(dev, cell, history_in_cdt):
    """bf16 compute at the query tower's training shape (B=64, T=32). The
    plain version against itself with float64 products on the CPU differs
    by 6e-4 of the dxp scale and 2e-4 (norm-relative) in dW/db; the bounds
    are about 10x that: one bf16 ulp of the dxp scale (2^-7 max|dxp|), and
    2e-3 norm-relative on dW and db."""
    args = _bwd_case(dev, cell, 2, 32, 64, 256, seed=7, cdt="bfloat16",
                     history_in_cdt=history_in_cdt)
    dxps, dw, db = rnn_layer_bwd(cell, *args, compute_dtype="bfloat16")
    r_dxps, r_dw, r_db = rnn_layer_bwd_reference(cell, *args, compute_dtype="bfloat16")
    for a, b in zip(dxps, r_dxps):
        assert (a - b).abs().max().item() <= 2 ** -7 * b.abs().max().item()
    assert _rel(dw, r_dw) <= 2e-3 and _rel(db, r_db) <= 2e-3


@pytest.mark.parametrize("cell", ["GRU", "LSTM", "RNN"])
def test_rnn_bwd_split_mode_matches_plain_and_combined(dev, cell):
    """Split mode (both directions in one launch, and one launch per
    direction) against its plain version, and the hoisted weight gradient
    against the kernel's own accumulation."""
    args = _bwd_case(dev, cell, 2, 12, 40, 128, seed=3)
    dxps, dhps = _bwd_hoisted_call(cell, *args, compute_dtype="float32")
    r_dxps, r_dhps, _, _ = _bwd_reference(cell, *args, "float32", split=True)
    for a, b in zip(dxps + dhps, r_dxps + r_dhps):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    c_dxps, c_dw, c_db = rnn_layer_bwd(cell, *args, compute_dtype="float32")
    outs = args[4]
    for d in range(2):
        dw, db = _hoisted_weight_grad(outs[d], dhps[d], d, "float32")
        torch.testing.assert_close(dw, c_dw[d], rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(db, c_db[d], rtol=1e-4, atol=1e-3)
    s_dxps, s_dw, s_db = rnn_layer_bwd_split_full(cell, *args, compute_dtype="float32")
    for a, b in zip(s_dxps, c_dxps):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_dw, c_dw, rtol=1e-4, atol=1e-3)


def test_rnn_bwd_wrapper_rejects_what_the_kernel_does_not_take(dev):
    args = list(_bwd_case(dev, "LSTM", 2, 4, 4, 32, seed=0))
    with pytest.raises(ValueError):
        rnn_layer_bwd("LSTM", *args[:4], args[4], (), *args[6:])  # no cell history
    args[7] = args[7].cpu()
    with pytest.raises(ValueError):
        rnn_layer_bwd("LSTM", *args)
    wide = _rnn_case(dev, "LSTM", 1, 2, 3, 512, seed=0)
    outs, c_hist, _ = rnn_layer_fwd_reference("LSTM", *wide, "float32")
    with pytest.raises(ValueError, match="shared memory"):
        rnn_layer_bwd("LSTM", *wide, outs, c_hist, [torch.zeros_like(outs[0])],
                      torch.zeros((1, 3, 512), device=dev))


def _unit_rows(gen, n, h, dev):
    x = torch.randn((n, h), generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [1, 5, 16, 32])
@pytest.mark.parametrize("with_cache", [False, True])
def test_segmax_kernel_matches_plain_version(dev, dtype, B, with_cache):
    """f32 sums of 256 products of unit-norm rows, in another order: they
    differ by at most about 2 * 256 * 2^-24 < 3e-5."""
    gen = torch.Generator(device=dev).manual_seed(B)
    docs = _unit_rows(gen, 8192, 256, dev).to(dtype)
    q = _unit_rows(gen, B, 256, dev).to(dtype)
    n_valid = 8000
    before = segmax.launches
    seg, cache = segmax(q, docs, n_valid, with_cache=with_cache)
    assert segmax.launches == before + 1
    r_seg, r_cache = segmax_reference(q, docs, n_valid, with_cache=with_cache)
    torch.testing.assert_close(seg, r_seg, rtol=0, atol=3e-5)
    assert (seg[(n_valid + 127) // 128 :] == NEG_INF).all()
    if with_cache:
        torch.testing.assert_close(cache, r_cache, rtol=0, atol=3e-5)
        assert (cache[n_valid:] == NEG_INF).all()
    else:
        assert cache is None


@pytest.mark.parametrize("phase2", ["rescore", "gather"])
def test_fused_topk_on_the_card_matches_the_oracle(dev, phase2):
    """The whole search on the card: ids equal the oracle's except where two
    scores lie within the summation-order tolerance."""
    gen = torch.Generator(device=dev).manual_seed(3)
    docs = _unit_rows(gen, 20000, 256, dev).to(torch.bfloat16)
    q = _unit_rows(gen, 16, 256, dev).to(torch.bfloat16)
    vals, ids = fused_topk_segmax(q, docs, k=50, phase2=phase2)
    o_vals, _ = topk_oracle(q, docs, 50)
    torch.testing.assert_close(vals, o_vals, rtol=0, atol=3e-5)
    full = torch.matmul(q.float(), docs.float().T)
    picked = full.gather(1, ids.long())
    torch.testing.assert_close(picked, vals, rtol=0, atol=3e-5)


def test_segmax_wrapper_rejects_what_the_kernel_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    docs = _unit_rows(gen, 256, 64, dev).to(torch.bfloat16)
    with pytest.raises(ValueError):
        segmax(_unit_rows(gen, 33, 64, dev).to(torch.bfloat16), docs, 256)
    with pytest.raises(ValueError):
        segmax(_unit_rows(gen, 4, 64, dev), docs, 256)  # dtype mismatch
    with pytest.raises(ValueError):
        segmax(_unit_rows(gen, 4, 64, dev).to(torch.bfloat16), docs[:200], 200)
