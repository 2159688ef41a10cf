"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)
"""

import math

import numpy as np
import pytest
import torch

from twotowermlretrieval_tpu_torch.ops.attention import (
    attention_bwd,
    attention_bwd_reference,
    attention_fwd,
    attention_fwd_reference,
    fused_attention,
)
from twotowermlretrieval_tpu_torch.ops.rnn_scan import (
    _bwd_hoisted_call,
    _bwd_reference,
    _hoisted_weight_grad,
    bwd_plan,
    fwd_plan,
    rnn_layer_bwd,
    rnn_layer_bwd_reference,
    rnn_layer_bwd_split,
    rnn_layer_bwd_split_full,
    rnn_layer_fwd,
    rnn_layer_fwd_reference,
)
from twotowermlretrieval_tpu_torch.ops.topk import (
    NEG_INF,
    fused_topk,
    fused_topk_int8,
    fused_topk_segmax,
    fused_topk_segmax_int8,
    fused_topk_segmax_s8,
    quantize_query_rows,
    quantize_rows,
    quantize_segments,
    s8_phase2,
    segmax,
    segmax_int8,
    segmax_int8_reference,
    segmax_reference,
    segmax_s8,
    segmax_s8_reference,
    topk_oracle,
    topk_segmented_s8,
    topk_stream,
    topk_stream_int8,
    topk_stream_reference,
)
from twotowermlretrieval_tpu_torch.ops import rnn_scan as _rnn_scan
from twotowermlretrieval_tpu_torch.ops import topk as _topk
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
    if B >= 3:
        lengths[:3] = torch.tensor([0, 1, T], device=dev)
    else:
        lengths[:] = T
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


def _check_fwd(got, want, cdt):
    """Kernel against plain version at the tolerances above: 1e-4 at f32;
    at bf16 2e-3 on h_final, 1e-2 on the history and relative 2^-6 on the
    LSTM cell history."""
    (outs, c_hist, fin), (r_outs, r_c, r_fin) = got, want
    tf, th = (1e-4, 1e-4) if cdt == "float32" else (2e-3, 1e-2)
    torch.testing.assert_close(fin, r_fin, rtol=0, atol=tf)
    for a, b in zip(outs, r_outs):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=th)
    for a, b in zip(c_hist, r_c):
        torch.testing.assert_close(a.float(), b.float(), rtol=0 if cdt == "float32" else 2 ** -6,
                                   atol=th)


# the widest forward layer of each cell and compute dtype (ops/rnn_scan.py;
# clusters of 16 past what clusters of 8 hold, one h row block past what
# two leave a ring of W for)
_FWD_WIDEST = {("GRU", "bfloat16"): 4032, ("GRU", "float32"): 4064,
               ("LSTM", "bfloat16"): 3520, ("LSTM", "float32"): 3520,
               ("RNN", "bfloat16"): 4096, ("RNN", "float32"): 4096}


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("H", [30, 50, 150, 1024])
def test_rnn_fwd_every_width(dev, H, cdt):
    """Widths off the kernel's multiple of 8 (zero-padded by the wrapper)
    and a wide layer whose W columns stream through shared memory: the
    kernel is launched and holds the plain version."""
    args = _rnn_case(dev, "GRU", 2, 12, 37, H, seed=H)
    hist = cdt == "bfloat16"
    before = rnn_layer_fwd.launches
    got = rnn_layer_fwd("GRU", *args, compute_dtype=cdt, history_in_cdt=hist)
    assert rnn_layer_fwd.launches == before + 1
    assert got[0][0].shape == (12, 37, H) and got[2].shape == (2, 37, H)
    _check_fwd(got, rnn_layer_fwd_reference("GRU", *args, compute_dtype=cdt,
                                            history_in_cdt=hist), cdt)


@pytest.mark.parametrize("cell,cdt", list(_FWD_WIDEST), ids=[f"{c}-{d}" for c, d in _FWD_WIDEST])
def test_rnn_fwd_widest_widths(dev, cell, cdt):
    """The widest planned layer of each cell runs on the kernel."""
    H = _FWD_WIDEST[cell, cdt]
    assert fwd_plan(cell, 3, 5, H, 1, cdt) is not None
    args = _rnn_case(dev, cell, 1, 3, 5, H, seed=H)
    before = rnn_layer_fwd.launches
    got = rnn_layer_fwd(cell, *args, compute_dtype=cdt)
    assert rnn_layer_fwd.launches == before + 1
    _check_fwd(got, rnn_layer_fwd_reference(cell, *args, compute_dtype=cdt), cdt)


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("cell", ["GRU", "LSTM", "RNN"])
def test_rnn_fwd_is_bitwise_repeatable(dev, cell, cdt):
    """No atomics and a fixed summation order: two calls give the same
    bits, at the training doc tower's batch (4 clusters a direction)."""
    args = _rnn_case(dev, cell, 2, 12, 128, 256, seed=11)
    a, b = (rnn_layer_fwd(cell, *args, compute_dtype=cdt, history_in_cdt=cdt == "bfloat16")
            for _ in range(2))
    for x, y in zip((*a[0], *a[1], a[2]), (*b[0], *b[1], b[2])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("cell,cdt", list(_FWD_WIDEST), ids=[f"{c}-{d}" for c, d in _FWD_WIDEST])
def test_rnn_fwd_beyond_its_widths_raises(dev, cell, cdt):
    """One width past the widest layout: a ValueError naming the limit,
    before any launch (the wrapper never runs the plain loop on the
    card)."""
    top = _FWD_WIDEST[cell, cdt]
    assert fwd_plan(cell, 2, 3, top + 1, 1, cdt) is None
    args = _rnn_case(dev, cell, 1, 2, 3, top + 1, seed=1)
    before = rnn_layer_fwd.launches
    with pytest.raises(ValueError, match=f"shared memory.*up to {top}"):
        rnn_layer_fwd(cell, *args, compute_dtype=cdt)
    assert rnn_layer_fwd.launches == before


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


def _check_bwd(got, want, cdt):
    """Kernel against plain version: dxp within 2^-7 of its scale and dW/db
    within 2e-3 norm-relative at bf16 (see the bf16 test above); 1e-4 at
    f32 (dW/db atol 1e-3: sums over T*B outer products)."""
    (dxps, dw, db), (r_dxps, r_dw, r_db) = got, want
    if cdt == "float32":
        for a, b in zip(dxps, r_dxps):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(dw, r_dw, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(db, r_db, rtol=1e-4, atol=1e-3)
    else:
        for a, b in zip(dxps, r_dxps):
            assert (a - b).abs().max().item() <= 2 ** -7 * b.abs().max().item()
        for a, b in ((dw, r_dw), (db, r_db)):  # at T=1 every h_prev, so dW, is 0
            assert _rel(a, b) <= 2e-3 if b.norm() > 0 else torch.equal(a, b)


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("split", [False, True], ids=["combined", "split"])
@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_rnn_bwd_is_bitwise_repeatable(dev, cell, split, cdt):
    """No atomics: two calls give the same bits (resume relies on it)."""
    args = _bwd_case(dev, cell, 2, 12, 40, 128, seed=5, cdt=cdt)
    if split:
        a, b = (_bwd_hoisted_call(cell, *args, compute_dtype=cdt) for _ in range(2))
        pairs = zip(a[0] + a[1], b[0] + b[1])
    else:
        a, b = (rnn_layer_bwd(cell, *args, compute_dtype=cdt) for _ in range(2))
        pairs = zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2]))
    for x, y in pairs:
        assert torch.equal(x, y)


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("cell", ["GRU", "LSTM", "RNN"])
@pytest.mark.parametrize("B,T", [(1, 12), (37, 12), (130, 12), (37, 1)])
def test_rnn_bwd_ragged_batches_and_one_step(dev, B, T, cell, cdt):
    """Batches that leave a cluster's row block partly empty (B=1, 37, 130
    with 16 or 32 rows a cluster; B=1 has one full-length row), and T=1
    (every row at its first position)."""
    args = _bwd_case(dev, cell, 2, T, B, 128, seed=B + T, cdt=cdt)
    _check_bwd(rnn_layer_bwd(cell, *args, compute_dtype=cdt),
               rnn_layer_bwd_reference(cell, *args, compute_dtype=cdt), cdt)


# the widest width the backward takes with two dhp row blocks, and the
# widest the planner takes now (the row block exchanged in chunks in
# clusters of 16; f32 history), per cell and compute dtype
_WIDEST = {("GRU", "bfloat16"): (816, 4096), ("GRU", "float32"): (916, 4096),
           ("LSTM", "bfloat16"): (608, 3328), ("LSTM", "float32"): (700, 4096),
           ("RNN", "bfloat16"): (2048, 4096), ("RNN", "float32"): (2048, 4096)}


@pytest.mark.parametrize("which", [0, 1], ids=["previous", "new"])
@pytest.mark.parametrize("cell,cdt", list(_WIDEST), ids=[f"{c}-{d}" for c, d in _WIDEST])
def test_rnn_bwd_widest_widths(dev, cell, cdt, which):
    """The widest layers stream their rows of W through shared memory,
    the widest of all in clusters of 16 with the dhp row block exchanged
    in chunks."""
    H = _WIDEST[cell, cdt][which]
    assert bwd_plan(cell, 4, 3, H, 1, cdt, torch.float32) is not None
    assert which == 0 or bwd_plan(cell, 4, 3, H + 4, 1, cdt, torch.float32) is None
    args = _bwd_case(dev, cell, 1, 4, 3, H, seed=H, cdt=cdt)
    _check_bwd(rnn_layer_bwd(cell, *args, compute_dtype=cdt),
               rnn_layer_bwd_reference(cell, *args, compute_dtype=cdt), cdt)


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("cell", ["GRU", "LSTM", "RNN"])
def test_rnn_bwd_lone_direction_1(dev, cell, cdt):
    """The backward tower direction alone (dir0=1): it walks t = 0..T-1 and
    reads h_prev at t+1."""
    xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal = _bwd_case(
        dev, cell, 2, 12, 37, 128, seed=9, cdt=cdt)
    one = ((xps[1],), mask, w_hh[1:], b_hh[1:], (outs[1],), tuple(c_hist[1:]), (douts[1],),
           d_hfinal[1:])
    dxp, dhp = rnn_layer_bwd_split(cell, xps[1], mask, w_hh[1:], b_hh[1:], outs[1],
                                   c_hist[1] if c_hist else None, douts[1], d_hfinal[1:],
                                   direction=1, compute_dtype=cdt)
    r_dxps, r_dhps, _, _ = _bwd_reference(cell, *one, cdt, split=True, dir0=1)
    for a, b in ((dxp, r_dxps[0]), (dhp, r_dhps[0])):
        if cdt == "float32":
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        else:
            assert (a.float() - b.float()).abs().max().item() <= \
                2 ** -7 * b.float().abs().max().item()
    # and the two-direction call's second half agrees with it
    both, _ = _bwd_hoisted_call(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal,
                                compute_dtype=cdt)
    assert torch.equal(both[1], dxp)


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("cell", ["GRU", "LSTM", "RNN"])
@pytest.mark.parametrize("H", [30, 150])
def test_rnn_bwd_every_width(dev, H, cell, cdt):
    """Widths off the kernel's multiple of 4, zero-padded by the wrapper:
    the kernel is launched, in both modes, and holds the plain version."""
    args = _bwd_case(dev, cell, 2, 12, 37, H, seed=H, cdt=cdt, history_in_cdt=cdt == "bfloat16")
    before = rnn_layer_bwd.launches
    got = rnn_layer_bwd(cell, *args, compute_dtype=cdt)
    assert rnn_layer_bwd.launches == before + 1
    assert got[0][0].shape == (12, 37, _GATES[cell] * H) and got[1].shape == (2, H, _GATES[cell] * H)
    _check_bwd(got, rnn_layer_bwd_reference(cell, *args, compute_dtype=cdt), cdt)
    dxps, dhps = _bwd_hoisted_call(cell, *args, compute_dtype=cdt)
    r_dxps, r_dhps, _, _ = _bwd_reference(cell, *args, cdt, split=True)
    for a, b in zip(dxps + dhps, r_dxps + r_dhps):
        assert a.shape == b.shape
        assert (a.float() - b.float()).abs().max().item() <= 2 ** -7 * b.float().abs().max().item()


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
def test_rnn_bwd_one_row_block(dev, cdt):
    """GRU at H=1024, the width the JAX package's split plan keeps on its
    kernel: past two dhp row blocks, so one block and a second cluster
    barrier a step. Both modes hold the plain version, and two calls give
    the same bits."""
    assert bwd_plan("GRU", 6, 20, 1024, 2, cdt, torch.float32)["blocks"] == 1
    args = _bwd_case(dev, "GRU", 2, 6, 20, 1024, seed=4, cdt=cdt)
    before = rnn_layer_bwd.launches
    a, b = (rnn_layer_bwd("GRU", *args, compute_dtype=cdt) for _ in range(2))
    assert rnn_layer_bwd.launches == before + 2
    _check_bwd(a, rnn_layer_bwd_reference("GRU", *args, compute_dtype=cdt), cdt)
    for x, y in zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2])):
        assert torch.equal(x, y)
    dxps, dhps = _bwd_hoisted_call("GRU", *args, compute_dtype=cdt)
    r_dxps, r_dhps, _, _ = _bwd_reference("GRU", *args, cdt, split=True)
    for x, y in zip(dxps + dhps, r_dxps + r_dhps):
        assert (x.float() - y.float()).abs().max().item() <= 2 ** -7 * y.float().abs().max().item()


# the widths the JAX package keeps on its Pallas kernels that clusters of 8
# do not hold: clusters of 16, W streamed, the backward's dhp row block
# exchanged in chunks (GRU 1792, LSTM 1536) or held once (RNN)
_WIDE = [("GRU", 1792, 16), ("LSTM", 1536, 16), ("RNN", 3072, 16), ("RNN", 2560, 128)]


@pytest.mark.parametrize("cell,H,B", _WIDE, ids=[f"{c}-H{h}-B{b}" for c, h, b in _WIDE])
def test_rnn_widest_jax_widths_on_the_kernels(dev, cell, H, B):
    """Both passes at bf16 with the model's bf16 history hold their plain
    versions within the tolerances above, and each gives the same bits
    twice."""
    cdt = "bfloat16"
    fp = fwd_plan(cell, 6, B, H, 2, cdt, torch.bfloat16)
    bp = bwd_plan(cell, 6, B, H, 2, cdt, torch.bfloat16)
    assert fp["nc"] > 8 or bp["nc"] > 8
    args = _rnn_case(dev, cell, 2, 6, B, H, seed=H + B)
    before = rnn_layer_fwd.launches, rnn_layer_bwd.launches
    got = [rnn_layer_fwd(cell, *args, compute_dtype=cdt, history_in_cdt=True) for _ in range(2)]
    _check_fwd(got[0], rnn_layer_fwd_reference(cell, *args, compute_dtype=cdt,
                                               history_in_cdt=True), cdt)
    for x, y in zip((*got[0][0], *got[0][1], got[0][2]), (*got[1][0], *got[1][1], got[1][2])):
        assert torch.equal(x, y)
    bargs = _bwd_case(dev, cell, 2, 6, B, H, seed=H + B + 1, cdt=cdt, history_in_cdt=True)
    a, b = (rnn_layer_bwd(cell, *bargs, compute_dtype=cdt) for _ in range(2))
    assert (rnn_layer_fwd.launches, rnn_layer_bwd.launches) == (before[0] + 2, before[1] + 2)
    _check_bwd(a, rnn_layer_bwd_reference(cell, *bargs, compute_dtype=cdt), cdt)
    for x, y in zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2])):
        assert torch.equal(x, y)


# the widths a user reaches by widening the reference towers (HIDDEN_DIM
# 512 or 1024), as chip_smoke.py's phase_wide_kernels runs them: W in a
# ring of stages (or, GRU H=512 at B=64, resident in clusters of 16)
_STREAMED = [("fwd", 512, 64), ("fwd", 1024, 64), ("fwd", 1024, 16), ("bwd", 512, 64)]


@pytest.mark.parametrize("which,H,B", _STREAMED, ids=[f"{w}-H{h}-B{b}" for w, h, b in _STREAMED])
def test_rnn_streamed_route_matches_plain_version(dev, which, H, B):
    """GRU at bf16 with a bf16 history, T=32: one launch, the plain version
    within the tolerances above, and the same bits twice."""
    cdt = "bfloat16"
    if which == "fwd":
        args = _rnn_case(dev, "GRU", 2, 32, B, H, seed=H + B)
        before = rnn_layer_fwd.launches
        got = [rnn_layer_fwd("GRU", *args, compute_dtype=cdt, history_in_cdt=True)
               for _ in range(2)]
        assert rnn_layer_fwd.launches == before + 2
        _check_fwd(got[0], rnn_layer_fwd_reference("GRU", *args, compute_dtype=cdt,
                                                   history_in_cdt=True), cdt)
        flat = [[*g[0], *g[1], g[2]] for g in got]
    else:
        args = _bwd_case(dev, "GRU", 2, 32, B, H, seed=H + B, cdt=cdt, history_in_cdt=True)
        before = rnn_layer_bwd.launches
        got = [rnn_layer_bwd("GRU", *args, compute_dtype=cdt) for _ in range(2)]
        assert rnn_layer_bwd.launches == before + 2
        _check_bwd(got[0], rnn_layer_bwd_reference("GRU", *args, compute_dtype=cdt), cdt)
        flat = [[*g[0], g[1], g[2]] for g in got]
    for x, y in zip(*flat):
        assert torch.equal(x, y)


# f32 compute (split products) where W streams: GRU H=1024 at the training
# query tower's B=64 (clusters of 8), and in clusters of 16 at B=16 (GRU
# H=1024 forward; the LSTM H=1536 backward's row block exchanged in
# chunks; RNN H=3072 both passes at 8 rows a cluster)
_F32_STREAMED = [("fwd", "GRU", 1024, 64), ("bwd", "GRU", 1024, 64), ("fwd", "GRU", 1024, 16),
                 ("bwd", "LSTM", 1536, 16), ("fwd", "RNN", 3072, 16), ("bwd", "RNN", 3072, 16)]


@pytest.mark.parametrize("which,cell,H,B", _F32_STREAMED,
                         ids=[f"{w}-{c}-H{h}-B{b}" for w, c, h, b in _F32_STREAMED])
def test_rnn_f32_split_route_where_w_streams(dev, which, cell, H, B):
    """At f32 compute, T=12: one launch, the plain version within the f32
    tolerances above, the same bits twice, and the zero-length row 0
    exactly zero (no state, no gate cotangent)."""
    cdt = "float32"
    plan = (fwd_plan if which == "fwd" else bwd_plan)(cell, 12, B, H, 2, cdt, torch.float32)
    assert not plan["resident"] and (B > 16 or plan["nc"] == 16)
    if which == "fwd":
        args = _rnn_case(dev, cell, 2, 12, B, H, seed=H + B)
        before = rnn_layer_fwd.launches
        got = [rnn_layer_fwd(cell, *args, compute_dtype=cdt) for _ in range(2)]
        assert rnn_layer_fwd.launches == before + 2
        _check_fwd(got[0], rnn_layer_fwd_reference(cell, *args, compute_dtype=cdt), cdt)
        outs, _, fin = got[0]
        assert (fin[:, 0] == 0).all() and all((o[:, 0] == 0).all() for o in outs)
        flat = [[*g[0], *g[1], g[2]] for g in got]
    else:
        args = _bwd_case(dev, cell, 2, 12, B, H, seed=H + B, cdt=cdt)
        before = rnn_layer_bwd.launches
        got = [rnn_layer_bwd(cell, *args, compute_dtype=cdt) for _ in range(2)]
        assert rnn_layer_bwd.launches == before + 2
        _check_bwd(got[0], rnn_layer_bwd_reference(cell, *args, compute_dtype=cdt), cdt)
        assert all((d[:, 0] == 0).all() for d in got[0][0])
        flat = [[*g[0], g[1], g[2]] for g in got]
    for x, y in zip(*flat):
        assert torch.equal(x, y)


def _ring_layouts(which, cell, T, B, H, cdt):
    """The plan and every ring its pass could take at this shape: depths
    from 1 (the backward's degenerate ring) or 2 up to what fits, the
    forward at 32 and 64 rows a stage with one and two h row blocks (at
    f32 with W in its bf16 pieces at 16 to 64 rows, the odd multiples of
    16 ending on a k16 step, and at 16 and 32 rows with W f32: both forms
    form the same products in the same order), the backward at each piece
    width of the plan's chunk."""
    hist = torch.bfloat16 if cdt == "bfloat16" else torch.float32
    cb = 2 if cdt == "bfloat16" else 4
    if which == "fwd":
        plan = fwd_plan(cell, T, B, H, 2, cdt, hist)
        out = []
        forms = [(False, (32, 64))] if cb == 2 else [(True, (16, 32, 48, 64)), (False, (16, 32))]
        for wsplit, widths in forms:
            for kc in widths:
                for blocks in (1, 2):
                    for s in range(2, 9):
                        smem = _rnn_scan._fwd_smem_bytes(cell, plan["H"], cb, plan["rows"],
                                                         plan["hc"], kc, s, blocks, wsplit)
                        if smem <= _rnn_scan._SMEM_LIMIT:
                            out.append(dict(plan, kc=kc, resident=False, wstages=s,
                                            blocks=blocks, smem=smem, wsplit=wsplit))
        return plan, out
    plan = bwd_plan(cell, T, B, H, 2, cdt, hist)
    out = []
    for kw in sorted({32, 64, 96, plan["kc"]}):
        if kw > plan["kc"] or kw % (32 if cb == 2 else 16):
            continue
        for s in range(1, 9):
            smem = _rnn_scan._bwd_smem_bytes(cell, plan["H"], cb, hist.itemsize, plan["rows"],
                                             plan["hc"], plan["kc"], plan["stages"],
                                             plan["blocks"], plan["xc"], s, kw)
            if smem <= _rnn_scan._SMEM_LIMIT:
                out.append(dict(plan, kw=kw, wstages=s, smem=smem))
    return plan, out


_RING_CASES = [("fwd", "bfloat16"), ("fwd", "float32"), ("bwd", "bfloat16"), ("bwd", "float32")]


@pytest.mark.parametrize("which,cdt", _RING_CASES, ids=[f"{w}-{c}" for w, c in _RING_CASES])
def test_rnn_ring_layouts_give_the_same_bits(dev, monkeypatch, which, cdt):
    """GRU H=1024 B=16 T=6: the launcher's plan arguments at every depth of
    the W ring (and the forward's stage rows and row blocks, the
    backward's piece widths) give the bits of the plan's own layout: only
    the moment each part of W arrives changes."""
    plan, layouts = _ring_layouts(which, "GRU", 6, 16, 1024, cdt)
    assert not plan["resident"] and len(layouts) >= 6
    hist = cdt == "bfloat16"
    if which == "fwd":
        args = _rnn_case(dev, "GRU", 2, 6, 16, 1024, seed=3)

        def run():
            res = rnn_layer_fwd("GRU", *args, compute_dtype=cdt, history_in_cdt=hist)
            return [*res[0], *res[1], res[2]]
    else:
        args = _bwd_case(dev, "GRU", 2, 6, 16, 1024, seed=3, cdt=cdt, history_in_cdt=hist)

        def run():
            res = rnn_layer_bwd("GRU", *args, compute_dtype=cdt)
            return [*res[0], res[1], res[2]]
    want = run()
    for lay in layouts:
        monkeypatch.setattr(_rnn_scan, f"{which}_plan", lambda *a, _lay=lay, **k: _lay)
        got = run()
        assert all(torch.equal(x, y) for x, y in zip(got, want)), lay


def test_rnn_widest_ring_is_bitwise_repeatable(dev):
    """RNN H=3072 B=16 T=32 (clusters of 16, W in a ring with one h row
    block forward and one dhp row block backward): two calls of each pass
    give the same bits."""
    cdt = "bfloat16"
    args = _rnn_case(dev, "RNN", 2, 32, 16, 3072, seed=7)
    a, b = (rnn_layer_fwd("RNN", *args, compute_dtype=cdt, history_in_cdt=True)
            for _ in range(2))
    for x, y in zip((*a[0], a[2]), (*b[0], b[2])):
        assert torch.equal(x, y)
    bargs = _bwd_case(dev, "RNN", 2, 32, 16, 3072, seed=8, cdt=cdt, history_in_cdt=True)
    a, b = (rnn_layer_bwd("RNN", *bargs, compute_dtype=cdt) for _ in range(2))
    for x, y in zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2])):
        assert torch.equal(x, y)


# The forward's large-batch layout (bf16, B >= 256, W resident;
# ops/rnn_scan.py fwd_plan): GRU, LSTM and RNN H=256 at the export batch
# (160 rows a cluster, one wave; T=1, 8, 12, 32 and 128) and GRU H=384
# (80 rows, two waves); at B=512 GRU H=264 (7 CTAs of 40 columns, so a
# region of zeros past them), LSTM H=320 and RNN H=376 (48 columns: the
# regions' swizzle over two rows' words), and RNN H=520 at B=256 (72
# columns, 9 units a CTA's row of tiles); GRU H=1024 (W streams) keeps the
# cluster route; batches that leave the last cluster ragged
_LARGE_BATCH = [("GRU", 256, 1000, 12, True), ("GRU", 1024, 1000, 6, False),
                ("LSTM", 256, 1024, 8, True), ("RNN", 256, 1000, 8, True),
                ("GRU", 384, 1024, 6, True), ("GRU", 256, 1024, 128, True),
                ("LSTM", 256, 1000, 1, True), ("RNN", 256, 1024, 32, True),
                ("GRU", 264, 512, 32, True), ("LSTM", 320, 512, 1, True),
                ("RNN", 376, 512, 128, True), ("RNN", 520, 256, 32, True)]


def _cluster_route_plan(cell, T, B, H, D, compute_dtype="bfloat16", history_dtype=None,
                        slots=_rnn_scan.H100_SXM_CLUSTER_SLOTS):
    """fwd_plan's cluster route alone: the plan before the large-batch
    layout, at every shape."""
    cb = _rnn_scan.torch_dtype(compute_dtype).itemsize
    return _rnn_scan._cluster_plan(cell, B, _rnn_scan.kernel_width(H), D, cb, slots)


def _flat_fwd(res):
    return [*res[0], *res[1], res[2]]


@pytest.mark.parametrize("history_in_cdt", [True, False])
@pytest.mark.parametrize("cell,H,B,T,wide", _LARGE_BATCH,
                         ids=[f"{c}-H{h}-B{b}" for c, h, b, _, _ in _LARGE_BATCH])
def test_rnn_fwd_large_batch_layouts(dev, monkeypatch, cell, H, B, T, wide, history_in_cdt):
    """The large batches launch the kernel once a call, hold the plain
    version at _check_fwd's tolerances, give the same bits twice, keep a
    zero-length row at zero, and give the bits of the cluster route forced
    to the plan it had before the large-batch layout: each product still
    runs over k in ascending order, in 16-wide mma.sync steps into one
    accumulator, whatever the regions and the order of a warp's units."""
    hist = torch.bfloat16 if history_in_cdt else torch.float32
    slots = _rnn_scan.cluster_slots("fwd", cell, "bfloat16", hist, dev)
    assert fwd_plan(cell, T, B, H, 2, "bfloat16", hist, slots)["wide"] == wide
    args = _rnn_case(dev, cell, 2, T, B, H, seed=B + H)
    kw = dict(compute_dtype="bfloat16", history_in_cdt=history_in_cdt)
    before = rnn_layer_fwd.launches
    got = rnn_layer_fwd(cell, *args, **kw)
    assert rnn_layer_fwd.launches == before + 1
    again = rnn_layer_fwd(cell, *args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(_flat_fwd(got), _flat_fwd(again)))
    _check_fwd(got, rnn_layer_fwd_reference(cell, *args, **kw), "bfloat16")
    assert (got[2][:, 0] == 0).all() and all((o[:, 0] == 0).all() for o in got[0])
    monkeypatch.setattr(_rnn_scan, "fwd_plan", _cluster_route_plan)
    parent = rnn_layer_fwd(cell, *args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(_flat_fwd(got), _flat_fwd(parent)))


# The backward's large-batch layout (bf16, B >= 256, W resident, one dhp
# row block, nothing staged; ops/rnn_scan.py bwd_plan) at H=256: every
# cell at B=256, 512, 1000 (the last cluster ragged) and 1024, with T=1, 32
# and 128 among them, and both history dtypes (LSTM's cluster route took
# 16 rows and split k between two warps: the layout keeps that order)
_LARGE_BWD = [("GRU", 256, 32, True), ("GRU", 512, 128, True), ("GRU", 1000, 1, True),
              ("GRU", 1024, 128, True), ("GRU", 1024, 32, False), ("LSTM", 256, 128, True),
              ("LSTM", 512, 1, False), ("LSTM", 1000, 32, True), ("LSTM", 1024, 32, True),
              ("RNN", 256, 1, True), ("RNN", 512, 32, False), ("RNN", 1000, 128, True),
              ("RNN", 1024, 32, True)]


def _flat_bwd(res):
    return [*res[0], res[1], res[2]]


@pytest.mark.parametrize("cell,B,T,history_in_cdt", _LARGE_BWD,
                         ids=[f"{c}-B{b}-T{t}-{'bf16' if h else 'f32'}"
                              for c, b, t, h in _LARGE_BWD])
def test_rnn_bwd_large_batch_layout(dev, monkeypatch, cell, B, T, history_in_cdt):
    """The large-batch layout launches the kernel once a call in both modes,
    holds the plain version at _check_bwd's tolerances (split mode: dxp and
    dhp within 2^-7 of their scale), gives the same bits twice, keeps a
    zero-length row at zero, and gives the bits of the cluster route forced
    to the plan it had before (_bwd_wide_plan patched to find none) in every
    output: dxp, GRU's dhp, dW and db."""
    hist = torch.bfloat16 if history_in_cdt else torch.float32
    slots = _rnn_scan.cluster_slots("bwd", cell, "bfloat16", hist, dev)
    plan = bwd_plan(cell, T, B, 256, 2, "bfloat16", hist, slots)
    assert plan["wide"] and plan["stages"] == 0 and plan["rows"] % 32 == 0
    args = _bwd_case(dev, cell, 2, T, B, 256, seed=B + T, cdt="bfloat16",
                     history_in_cdt=history_in_cdt)
    kw = dict(compute_dtype="bfloat16")
    before = rnn_layer_bwd.launches
    got = rnn_layer_bwd(cell, *args, **kw)
    split = _bwd_hoisted_call(cell, *args, **kw)
    assert rnn_layer_bwd.launches == before + 2
    again = rnn_layer_bwd(cell, *args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(_flat_bwd(got), _flat_bwd(again)))
    _check_bwd(got, rnn_layer_bwd_reference(cell, *args, **kw), "bfloat16")
    r_dxps, r_dhps, _, _ = _bwd_reference(cell, *args, "bfloat16", split=True)
    for a, b in zip(split[0] + split[1], r_dxps + r_dhps):
        assert (a.float() - b.float()).abs().max() <= 2 ** -7 * b.float().abs().max()
    assert all((d[:, 0] == 0).all() for d in got[0])
    monkeypatch.setattr(_rnn_scan, "_bwd_wide_plan", lambda *a, **k: None)
    assert not bwd_plan(cell, T, B, 256, 2, "bfloat16", hist, slots)["wide"]
    parent = rnn_layer_bwd(cell, *args, **kw)
    p_split = _bwd_hoisted_call(cell, *args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(_flat_bwd(got), _flat_bwd(parent)))
    assert all(torch.equal(x, y) for x, y in zip(split[0] + split[1], p_split[0] + p_split[1]))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("H", [30, 50, 150, 1024])
def test_gru_tower_every_width_on_the_kernels(dev, H, cdt):
    """A two-layer bidirectional GRU tower at widths off the kernels'
    multiple and at H=1024: each layer, padded once to kernel_width(H),
    launches the forward and the backward kernel once, and the encoding
    and every parameter's gradient agree with the same tower on the CPU
    (f32: atol 1e-4 and relative 1e-3; bf16: atol 2e-2 and relative 2e-2,
    chip_smoke.py's card-against-CPU tolerances)."""
    from twotowermlretrieval_tpu_torch.models.rnn import RNNSpec, init_rnn_encoder, rnn_encode

    spec = RNNSpec(vocab_size=50, embed_dim=32, hidden_dim=H, num_layers=2, bidirectional=True,
                   compute_dtype=cdt)
    params = init_rnn_encoder(torch.Generator().manual_seed(H), spec)
    rng = np.random.default_rng(H)
    tokens = torch.from_numpy(rng.integers(0, 50, (20, 9)))
    lengths = torch.from_numpy(np.r_[0, 1, 9, rng.integers(1, 10, 17)])
    weights = torch.from_numpy(rng.standard_normal((20, H)).astype(np.float32))

    def run(device):
        p = _tree_map(lambda x: x.to(device).requires_grad_(True), params)
        out = rnn_encode(p, tokens.to(device), lengths.to(device), spec)
        (out * weights.to(device)).sum().backward()
        return out.detach().cpu(), [x.grad.cpu() for x in _tree_leaves(p)]

    fwd0, bwd0 = rnn_layer_fwd.launches, rnn_layer_bwd.launches
    got, got_g = run(dev)
    assert (rnn_layer_fwd.launches - fwd0, rnn_layer_bwd.launches - bwd0) == (2, 2)
    want, want_g = run("cpu")
    atol, rel = (1e-4, 1e-3) if cdt == "float32" else (2e-2, 2e-2)
    assert got.shape == (20, H)
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    for g, w in zip(got_g, want_g):
        assert _rel(g, w) <= rel


def test_rnn_bwd_wrapper_rejects_what_the_kernel_does_not_take(dev):
    args = list(_bwd_case(dev, "LSTM", 2, 4, 4, 32, seed=0))
    with pytest.raises(ValueError):
        rnn_layer_bwd("LSTM", *args[:4], args[4], (), *args[6:])  # no cell history
    args[7] = args[7].cpu()
    with pytest.raises(ValueError):
        rnn_layer_bwd("LSTM", *args)
    # one width step beyond the widest LSTM layout of either compute dtype:
    # refused before any launch, naming the limit
    wide = _rnn_case(dev, "LSTM", 1, 2, 3, 4100, seed=0)
    outs, c_hist, _ = rnn_layer_fwd_reference("LSTM", *wide, "float32")
    before = rnn_layer_bwd.launches
    with pytest.raises(ValueError, match="shared memory.*up to 3328"):
        rnn_layer_bwd("LSTM", *wide, outs, c_hist, [torch.zeros_like(outs[0])],
                      torch.zeros((1, 3, 4100), device=dev))
    assert rnn_layer_bwd.launches == before


@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_index_at_an_odd_width(dev, storage):
    """A card index over H=150 embeddings (the scans read 16-byte rows, so
    the index zero-pads its columns and the queries): the kernel path
    equals the two-phase path."""
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

    rng = np.random.default_rng(0)
    docs = rng.standard_normal((9000, 150)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = docs[:5] + 0.1 * rng.standard_normal((5, 150)).astype(np.float32)
    before = segmax.launches + segmax_s8.launches
    vals, ids = RetrievalIndex(docs, device=dev, storage_dtype=storage).search(q, 50)
    assert segmax.launches + segmax_s8.launches == before + 1
    r_vals, r_ids = RetrievalIndex(docs, device=dev, storage_dtype=storage,
                                   use_kernel=False).search(q, 50)
    assert (ids[:, 0] == np.arange(5)).all()
    if storage == "int8":
        assert np.array_equal(ids, r_ids) and np.array_equal(vals, r_vals)
    else:
        np.testing.assert_allclose(vals, r_vals, rtol=0, atol=3e-5)


def _unit_rows(gen, n, h, dev):
    x = torch.randn((n, h), generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


# Batch sizes around the kernels' n8 query tiles, widths with a k-tail
# short of a 16-column step (8, 24, 40), and n_valid on, just before and
# just after a segment boundary (8064 = 63 * 128).
_SCAN_B = [1, 5, 8, 9, 16, 17, 32]
_SCAN_H = [256, 8, 24, 40]
_N_VALID = [8000, 8063, 8064, 8065]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", _SCAN_B)
@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("H", _SCAN_H)
def test_segmax_kernel_matches_plain_version(dev, dtype, B, with_cache, H):
    """f32 sums of H products of unit-norm rows, in another order: they
    differ by at most about 2 * 256 * 2^-24 < 3e-5."""
    gen = torch.Generator(device=dev).manual_seed(B + H)
    docs = _unit_rows(gen, 8192, H, dev).to(dtype)
    q = _unit_rows(gen, B, H, dev).to(dtype)
    for n_valid in _N_VALID:
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


def _int8_rows(d):
    return (torch.from_numpy(a).to(d.device) for a in quantize_rows(d.cpu().numpy()))


@pytest.mark.parametrize("storage", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("segments", [1, 2500])  # one; more than the resident blocks
def test_segmax_one_segment_and_more_than_the_resident_blocks(dev, storage, segments):
    """The persistent blocks walk every segment: one segment, and 2,500
    (more than the card's blocks at once, at most 4 a SM), against the plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(segments)
    d = _unit_rows(gen, segments * 128, 48, dev)
    q = _unit_rows(gen, 12, 48, dev)
    n_valid = segments * 128 - 77
    if storage == "int8":
        values, scales = _int8_rows(d)
        got = segmax_int8(q.bfloat16(), values, scales, n_valid)
        want = segmax_int8_reference(q.bfloat16(), values, scales, n_valid)
        torch.testing.assert_close(got, want, rtol=0, atol=4e-5)
    else:
        dt = getattr(torch, storage)
        got, cache = segmax(q.to(dt), d.to(dt), n_valid, with_cache=True)
        want, r_cache = segmax_reference(q.to(dt), d.to(dt), n_valid, with_cache=True)
        torch.testing.assert_close(got, want, rtol=0, atol=3e-5)
        torch.testing.assert_close(cache, r_cache, rtol=0, atol=3e-5)
    assert got.shape == (segments, 12)


def test_scan_kernels_are_bitwise_repeatable(dev):
    """No atomics in a sum: two calls of segmax (bf16, f32, with its cache),
    segmax_int8, topk_stream (bf16, f32) and topk_stream_int8 give the same
    bits. The running top-k's blocks race on their shared thresholds (a
    different set of candidates reaches launch 2 in each run), which must
    not move its result: 1,100 tiles (past the 1,024 from which a pilot
    seeds the thresholds), B=17, k=128, and a corpus of duplicated rows so
    that keys tie in value across blocks; the result also holds the plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(11)
    d = _unit_rows(gen, 1100 * 128, 64, dev)
    d[40_000:] = d[: d.shape[0] - 40_000].clone()  # every value twice, far apart
    q = _unit_rows(gen, 17, 64, dev)
    values, scales = _int8_rows(d)
    qb = q.bfloat16()
    calls = [
        lambda: segmax(qb, d.bfloat16(), 138_000, with_cache=True),
        lambda: segmax(q, d, 138_000, with_cache=True),
        lambda: (segmax_int8(qb, values, scales, 138_000),),
        lambda: topk_stream(qb, d.bfloat16(), 128, 139_000),
        lambda: topk_stream(q, d, 128, 139_000),
        lambda: topk_stream_int8(qb, values, scales, 128, 139_000),
    ]
    for call in calls:
        first = call()
        for _ in range(3):
            assert all(torch.equal(a, b) for a, b in zip(first, call()))
    for got, want in ((calls[3](), topk_stream_reference(qb, d.bfloat16(), 128, 139_000)),
                      (calls[4](), topk_stream_reference(q, d, 128, 139_000)),
                      (calls[5](), topk_stream_reference(qb, values, 128, 139_000, scales))):
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=4e-5)


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


# 32 query rows at the widest tower widths (bf16 and int8 H=3360, f32
# H=3200): one launch each, the query fragments riding the ring, and each
# query's result is bit for bit its own one-row launch (at bf16 and int8
# one whose fragments stay resident in shared memory).
@pytest.mark.parametrize("dtype,H", [(torch.bfloat16, 3360), (torch.float32, 3200),
                                     (torch.int8, 3360)])
def test_wide_batches_run_in_blocks_bitwise(dev, dtype, H):
    gen = torch.Generator(device=dev).manual_seed(H)
    docs = _unit_rows(gen, 4096, H, dev)
    q = _unit_rows(gen, 32, H, dev)
    n_valid = 4000
    if dtype == torch.int8:
        values, scales = _int8_rows(docs)
        qb = q.bfloat16()
        scan = lambda qq: segmax_int8(qq, values, scales, n_valid)  # noqa: E731
        plain = segmax_int8_reference(qb, values, scales, n_valid)
        top = lambda qq: topk_stream_int8(qq, values, scales, 50, n_valid)  # noqa: E731
        top_plain = topk_stream_reference(qb, values, 50, n_valid, scales)
        counter, top_counter = segmax_int8, topk_stream_int8
    else:
        docs, qb = docs.to(dtype), q.to(dtype)
        scan = lambda qq: segmax(qq, docs, n_valid)[0]  # noqa: E731
        plain = segmax_reference(qb, docs, n_valid)[0]
        top = lambda qq: topk_stream(qq, docs, 50, n_valid)  # noqa: E731
        top_plain = topk_stream_reference(qb, docs, 50, n_valid)
        counter, top_counter = segmax, topk_stream
    before = (counter.launches, top_counter.launches)
    seg = scan(qb)
    vals, ids = top(qb)
    storage = torch.int8 if dtype == torch.int8 else dtype
    blocks = len(_topk.query_blocks("segmax", 32, H, storage))
    top_blocks = len(_topk.query_blocks("topk_stream", 32, H, storage, 50))
    assert counter.launches - before[0] == blocks
    assert top_counter.launches - before[1] == top_blocks
    assert (blocks, top_blocks) == (1, 1)
    assert _topk.scan_plan(32, H, storage)["query_frags"] == "ring"
    assert _topk.scan_plan(1, H, storage)["query_frags"] == (
        "ring" if dtype == torch.float32 else "shared memory")
    torch.testing.assert_close(seg, plain, rtol=0, atol=3e-5 * H / 256)
    torch.testing.assert_close(vals, top_plain[0], rtol=0, atol=3e-5 * H / 256)
    for i in (0, 13, 31):
        assert torch.equal(seg[:, i], scan(qb[i : i + 1])[:, 0])
        one_vals, one_ids = top(qb[i : i + 1])
        assert torch.equal(vals[i], one_vals[0]) and torch.equal(ids[i], one_ids[0])


# bf16 and per-row int8 scans under every layout they can take (the query
# fragments resident in shared memory or riding the ring, each ring depth
# that fits): the same words reach the same products in the same order, so
# every layout gives the chosen plan's bits.
@pytest.mark.parametrize("storage", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("B", [1, 9, 32])
@pytest.mark.parametrize("H", [48, 256, 1024])
def test_every_fragment_route_gives_the_same_bits(dev, monkeypatch, storage, B, H):
    gen = torch.Generator(device=dev).manual_seed(B * 7 + H)
    docs = _unit_rows(gen, 4096, H, dev)
    q = _unit_rows(gen, B, H, dev).bfloat16()
    n_valid = 4000
    if storage == torch.int8:
        values, scales = _int8_rows(docs)
        scan = lambda: segmax_int8(q, values, scales, n_valid)  # noqa: E731
        top = lambda k: topk_stream_int8(q, values, scales, k, n_valid)  # noqa: E731
        plain = segmax_int8_reference(q, values, scales, n_valid)
    else:
        docs = docs.bfloat16()
        scan = lambda: segmax(q, docs, n_valid)[0]  # noqa: E731
        top = lambda k: topk_stream(q, docs, k, n_valid)  # noqa: E731
        plain = segmax_reference(q, docs, n_valid)[0]
    want = {k: (scan() if k is None else top(k)) for k in (None, 50, 128)}
    torch.testing.assert_close(want[None], plain, rtol=0, atol=4e-5 * max(1, H / 256))
    plan_fn = _topk.scan_plan
    for k in (None, 50, 128):
        layouts = _topk.scan_layouts(B, H, storage, k)
        assert {p["query_frags"] for p in layouts} == {"ring", "shared memory"}
        for layout in layouts:
            monkeypatch.setattr(_topk, "scan_plan", lambda *a, _p=layout, **kw: _p)
            got = scan() if k is None else top(k)
            monkeypatch.setattr(_topk, "scan_plan", plan_fn)
            same = (torch.equal(got, want[k]) if k is None else
                    torch.equal(got[0], want[k][0]) and torch.equal(got[1], want[k][1]))
            assert same, (k, layout["query_frags"], layout["stages"])


# The f32 route (three bf16 pieces a value, six products on the tensor
# cores, the query fragments riding the ring) at the batch sizes around its
# n8 query tiles and at widths from a k-tail inside one stage (8, 24, 40) to
# the widest tower's (3200: 100 stages of 32 columns, one pass at B=32).
@pytest.mark.parametrize("B", _SCAN_B)
@pytest.mark.parametrize("H", [8, 24, 40, 256, 1024, 3200])
def test_f32_route_matches_plain_version(dev, B, H):
    """segmax (with its cache) and the running top-k at k=50 over f32 rows,
    one launch each, against their plain versions (f32 products): a score
    is within 2^-23 (1 + 2^-7) of the exact one for unit rows besides the
    f32 sums' order, so 3e-5 (scaled by H / 256 past 256, as the wide
    batches); n_valid at and around a segment boundary; the top-k's ids
    score their values; two calls give the same bits."""
    gen = torch.Generator(device=dev).manual_seed(B * 31 + H)
    docs = _unit_rows(gen, 8192, H, dev)
    q = _unit_rows(gen, B, H, dev)
    atol = 3e-5 * max(1, H / 256)
    assert _topk.scan_plan(B, H, torch.float32)["route"] == "mma"
    full = torch.matmul(q, docs.T)
    for n_valid in _N_VALID:
        before = (segmax.launches, topk_stream.launches)
        seg, cache = segmax(q, docs, n_valid, with_cache=True)
        vals, ids = topk_stream(q, docs, 50, n_valid)
        assert (segmax.launches, topk_stream.launches) == (before[0] + 1, before[1] + 1)
        r_seg, r_cache = segmax_reference(q, docs, n_valid, with_cache=True)
        torch.testing.assert_close(seg, r_seg, rtol=0, atol=atol)
        torch.testing.assert_close(cache, r_cache, rtol=0, atol=atol)
        assert (seg[(n_valid + 127) // 128 :] == NEG_INF).all()
        assert (cache[n_valid:] == NEG_INF).all()
        r_vals, _ = topk_stream_reference(q, docs, 50, n_valid)
        torch.testing.assert_close(vals, r_vals, rtol=0, atol=atol)
        assert ((ids >= 0) & (ids < n_valid)).all()
        torch.testing.assert_close(full.gather(1, ids.long()), vals, rtol=0, atol=atol)
        again = segmax(q, docs, n_valid, with_cache=True)
        assert torch.equal(again[0], seg) and torch.equal(again[1], cache)
        a_vals, a_ids = topk_stream(q, docs, 50, n_valid)
        assert torch.equal(a_vals, vals) and torch.equal(a_ids, ids)


@pytest.mark.parametrize("B", [8, 32])
def test_f32_topk_stream_bitwise_over_1100_tiles(dev, B):
    """The f32 running top-k over 1,100 tiles (a pilot seeds the shared
    thresholds, and the blocks race on them) at H=256, k=50, over a corpus
    of duplicated rows so that keys tie in value across blocks: three more
    calls give the same bits, and the result holds the plain version."""
    gen = torch.Generator(device=dev).manual_seed(B)
    d = _unit_rows(gen, 1100 * 128, 256, dev)
    d[50_000:] = d[: d.shape[0] - 50_000].clone()
    q = _unit_rows(gen, B, 256, dev)
    assert _topk.topk_stream_grid(_topk.scan_plan(B, 256, torch.float32, 50), B, 1100,
                                  sms=132)["stride"] == 32
    first = topk_stream(q, d, 50, 140_000)
    for _ in range(3):
        again = topk_stream(q, d, 50, 140_000)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    r_vals, _ = topk_stream_reference(q, d, 50, 140_000)
    torch.testing.assert_close(first[0], r_vals, rtol=0, atol=3e-5)


def test_segmax_wrapper_rejects_what_the_kernel_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    docs = _unit_rows(gen, 256, 64, dev).to(torch.bfloat16)
    with pytest.raises(ValueError):
        segmax(_unit_rows(gen, 33, 64, dev).to(torch.bfloat16), docs, 256)
    with pytest.raises(ValueError):
        segmax(_unit_rows(gen, 4, 64, dev), docs, 256)  # dtype mismatch
    with pytest.raises(ValueError):
        segmax(_unit_rows(gen, 4, 64, dev).to(torch.bfloat16), docs[:200], 200)


# ---------------------------------------------------------------------------
# int8 scans and the running top-k
# ---------------------------------------------------------------------------


def _s8_case(dev, B, N, H, seed, seg=128):
    """Unit rows quantized per segment (on the host, as the index does) and
    per-row int8 queries, on the card."""
    gen = torch.Generator().manual_seed(seed)
    d = torch.randn((N, H), generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    values, scales = quantize_segments(d.numpy(), seg=seg)
    q = torch.randn((B, H), generator=gen)
    q = q / q.norm(dim=1, keepdim=True)
    q_i8, q_scale = quantize_query_rows(q)
    return (q.to(dev), q_i8.to(dev), q_scale.to(dev), torch.from_numpy(values).to(dev),
            torch.from_numpy(scales).to(dev))


def _s8_random(dev, B, N, H, seed):
    """Uniform int8 values in -127..127 (queries and rows), on the card."""
    gen = torch.Generator().manual_seed(seed)
    q, d = (torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
            for shape in ((B, H), (N, H)))
    return q.to(dev), d.to(dev)


@pytest.mark.parametrize("seg", [32, 64, 128])
@pytest.mark.parametrize("B", [1, 5, 16, 32])
@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("H", [256, 16, 48, 1056, 2048])
def test_segmax_s8_kernel_equals_plain_version_bitwise(dev, seg, B, with_cache, H):
    """Integer sums are exact in both, in any order, and each converts to
    f32 once (the kernel after the segment max, the plain version before:
    rounding is monotone), so the segment maxima and the cache agree to the
    bit at every width, also past H=1040 where the scores pass 2^24 and
    round. H=16 and 48 leave most of a stage zero-filled. Two calls give
    the same bits."""
    if H == 256:
        _, q_i8, _, values, _ = _s8_case(dev, B, 8192, 256, seed=B + seg)
    else:  # full-range values: |score| up to 127 * 127 * H
        q_i8, values = _s8_random(dev, B, 8192 if H < 2048 else 4096, H, seed=B + seg + H)
    before = segmax_s8.launches
    got, cache = segmax_s8(q_i8, values, seg, with_cache=with_cache)
    assert segmax_s8.launches == before + 1
    want, r_cache = segmax_s8_reference(q_i8, values, seg, with_cache=with_cache)
    assert got.shape == (values.shape[0] // seg, B) and torch.equal(got, want)
    assert (cache is None) == (not with_cache)
    if with_cache:
        assert torch.equal(cache, r_cache)
    again, again_cache = segmax_s8(q_i8, values, seg, with_cache=with_cache)
    assert torch.equal(again, got) and (not with_cache or torch.equal(again_cache, cache))


@pytest.mark.parametrize("B", [3, 16, 32])
def test_segmax_s8_one_tile_and_a_partial_wave(dev, B):
    """Npad of one 128-row tile (one block), and a corpus whose tiles end
    part-way through the persistent blocks' last wave: bitwise equal to
    the plain version at every segment width."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    wave = _topk.s8_plan(B, 256)["blocks_per_sm"] * sms
    for tiles in (1, 2 * wave + wave // 3):
        q_i8, values = _s8_random(dev, B, tiles * 128, 256, seed=tiles + B)
        for seg in (32, 64, 128):
            got, cache = segmax_s8(q_i8, values, seg, with_cache=True)
            want, r_cache = segmax_s8_reference(q_i8, values, seg, with_cache=True)
            assert torch.equal(got, want) and torch.equal(cache, r_cache), (tiles, seg)


def test_segmax_s8_scores_past_2_24_round_as_the_plain_version(dev):
    """Rows of 127 but one column r and queries of 127 but that column's
    1: the integer scores 127 * 127 * (H - 1) + r pass 2^24 and round to
    even in f32; the kernel's maxima and cache equal the plain version's
    and the int64 product converted to f32."""
    H = 2048
    values = torch.full((1024, H), 127, dtype=torch.int8)
    values[:, 1] = (torch.arange(1024) % 255 - 127).to(torch.int8)
    q_i8 = torch.full((4, H), 127, dtype=torch.int8)
    q_i8[:, 1] = 1
    exact = (values.long() @ q_i8.long().T).float()
    assert exact.max().item() > 2 ** 24
    for seg in (32, 128):
        got, cache = segmax_s8(q_i8.to(dev), values.to(dev), seg, with_cache=True)
        assert torch.equal(cache.cpu(), exact)
        assert torch.equal(got.cpu(), exact.reshape(-1, seg, 4).amax(dim=1))


@pytest.mark.parametrize("phase2", ["rescore", "gather"])
@pytest.mark.parametrize("seg", [64, 128])
def test_s8_search_on_the_card_equals_plain_phase1_and_two_phase(dev, phase2, seg):
    """fused_topk_segmax_s8 with the kernel equals the same search with the
    plain phase 1, and the two-phase path, in every bit."""
    q, q_i8, q_scale, values, scales = _s8_case(dev, 16, 20480, 256, seed=seg, seg=seg)
    kw = dict(k=50, n_valid=20000, seg=seg)
    vals, ids = fused_topk_segmax_s8(q, values, scales, phase2=phase2, **kw)
    maxima, cache = segmax_s8_reference(q_i8, values, seg, with_cache=phase2 == "gather")
    r_vals, r_ids = s8_phase2(maxima, cache, q_i8, q_scale, values, scales, 50, 20000, seg)
    assert torch.equal(ids, r_ids) and torch.equal(vals, r_vals)
    t_vals, t_ids = topk_segmented_s8(q, values, scales, **kw)
    assert torch.equal(ids, t_ids) and torch.equal(vals, t_vals)
    assert ((ids >= 0) & (ids < 20000)).all()


@pytest.mark.parametrize("phase2", ["rescore", "gather"])
def test_s8_search_past_1040_columns_equals_plain_phase1_and_two_phase(dev, phase2):
    """At H=1056 the search with the kernel equals the same search with the
    plain phase 1 (its re-score through the exact pieced product) and the
    two-phase path, in every bit."""
    q, q_i8, q_scale, values, scales = _s8_case(dev, 8, 8192, 1056, seed=3)
    kw = dict(k=50, n_valid=8100)
    before = segmax_s8.launches
    vals, ids = fused_topk_segmax_s8(q, values, scales, phase2=phase2, **kw)
    assert segmax_s8.launches == before + 1
    maxima, cache = segmax_s8_reference(q_i8, values, 128, with_cache=phase2 == "gather")
    r_vals, r_ids = s8_phase2(maxima, cache, q_i8, q_scale, values, scales, 50, 8100, 128)
    assert torch.equal(ids, r_ids) and torch.equal(vals, r_vals)
    t_vals, t_ids = topk_segmented_s8(q, values, scales, **kw)
    assert torch.equal(ids, t_ids) and torch.equal(vals, t_vals)


@pytest.mark.parametrize("H", [1040, 1056, 2080, 4096])
def test_int_matmul_on_the_card_is_exact_past_1040(dev, H):
    """The card's plain integer product (exact f32 pieces of at most 1040
    columns summed in int32, converted once) equals the int64 product on
    the CPU converted to f32, for every operand layout phase 2 and the
    two-phase path use, with full-range values."""
    q_i8, values = _s8_random(dev, 8, 512, H, seed=H)
    exact = (values.cpu().long() @ q_i8.cpu().long().T).float()  # [512, 8]
    assert torch.equal(_topk._int_matmul(values, q_i8.T).cpu(), exact)
    assert torch.equal(_topk._int_matmul(q_i8, values.T).cpu(), exact.T)
    blocks = values.reshape(8, 64, H)  # [B, rows, H] against each query row
    got = _topk._int_matmul(blocks, q_i8[:, :, None])[..., 0]
    assert torch.equal(got.cpu(), exact.reshape(8, 64, 8).diagonal(dim1=0, dim2=2).T)


def test_segmax_s8_wrapper_rejects_what_the_kernel_does_not_take(dev):
    _, q_i8, _, values, _ = _s8_case(dev, 4, 256, 64, seed=0)
    with pytest.raises(ValueError):
        segmax_s8(q_i8, values, seg=16)  # segment width
    with pytest.raises(ValueError):
        segmax_s8(torch.cat([q_i8] * 9), values)  # 36 query rows
    with pytest.raises(ValueError):
        segmax_s8(q_i8[:, :40], values[:, :40].contiguous())  # H not a multiple of 16
    with pytest.raises(ValueError):
        segmax_s8(q_i8.float(), values)  # not int8
    with pytest.raises(ValueError):
        segmax_s8(q_i8.cpu(), values)  # devices differ
    # H=1056, past where the scores stay below 2^24: taken, the plain version's bits
    wide_q, wide = _s8_random(dev, 2, 256, 1056, seed=1)
    got, cache = segmax_s8(wide_q, wide, with_cache=True)
    want, r_cache = segmax_s8_reference(wide_q, wide, with_cache=True)
    assert torch.equal(got, want) and torch.equal(cache, r_cache)
    # past the widest layout a block holds: refused before any launch, naming the limit
    widest = _topk.s8_max_h(32)
    too_wide = torch.zeros((128, widest + 16), dtype=torch.int8, device=dev)
    before = segmax_s8.launches
    with pytest.raises(ValueError, match=f"up to {widest}"):
        segmax_s8(too_wide[:32], too_wide)
    assert segmax_s8.launches == before


@pytest.mark.parametrize("B", _SCAN_B)
@pytest.mark.parametrize("H", [256, 16, 48])
def test_segmax_int8_kernel_matches_plain_version(dev, B, H):
    """Exact products summed in f32 in another order, times the row scale:
    the sums of |q_i v_i| scale(row) are at most about 1 for unit rows, so
    the two differ by at most about 2 * 256 * 2^-24 < 4e-5. int8 rows are
    16-byte multiples: H = 16 and 48 leave a stage mostly zero-filled."""
    gen = torch.Generator(device=dev).manual_seed(B + H)
    d = _unit_rows(gen, 8192, H, dev)
    values, scales = _int8_rows(d)
    q = _unit_rows(gen, B, H, dev).bfloat16()
    for n_valid in _N_VALID:
        before = segmax_int8.launches
        got = segmax_int8(q, values, scales, n_valid)
        assert segmax_int8.launches == before + 1
        want = segmax_int8_reference(q, values, scales, n_valid)
        torch.testing.assert_close(got, want, rtol=0, atol=4e-5)
        assert (got[(n_valid + 127) // 128 :] == NEG_INF).all()
    vals, ids = fused_topk_segmax_int8(q, values, scales, k=50, n_valid=8000)
    full = (torch.matmul(q.float(), values.float().T) * scales)[:, :8000]
    torch.testing.assert_close(vals, torch.topk(full, 50).values, rtol=0, atol=4e-5)
    torch.testing.assert_close(full.gather(1, ids.long()), vals, rtol=0, atol=4e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("B,k", [(1, 1), (5, 50), (8, 128), (9, 50), (16, 128), (17, 64),
                                 (32, 7), (32, 128)])
@pytest.mark.parametrize("H", [256, 16, 48])
def test_topk_stream_kernel_matches_plain_version(dev, dtype, B, k, H):
    """The running top-k against the full product and a stable sort: the
    values within the summation-order tolerance (4e-5, as above), every id
    scoring its value, and -- where no two scores are that close -- the
    same ids. 20,480 rows span several chunks; n_valid on, just before and
    just after a tile boundary (20,096 = 157 * 128)."""
    gen = torch.Generator(device=dev).manual_seed(B * 7 + k + H)
    d = _unit_rows(gen, 20480, H, dev)
    q = _unit_rows(gen, B, H, dev)
    if dtype == torch.int8:
        values, scales = _int8_rows(d)
        q = q.bfloat16()
        fn, args, counter = topk_stream_int8, (q, values, scales), topk_stream_int8
        full = torch.matmul(q.float(), values.float().T) * scales
    else:
        docs, q = d.to(dtype), q.to(dtype)
        fn, args, counter = topk_stream, (q, docs), topk_stream
        full = torch.matmul(q.float(), docs.float().T)
    for n_valid in (20000, 20095, 20096, 20097):
        r_vals, r_ids = topk_stream_reference(*args[:2], k, n_valid, *args[2:])
        before = counter.launches
        vals, ids = fn(*args, k, n_valid)
        assert counter.launches == before + 1
        torch.testing.assert_close(vals, r_vals, rtol=0, atol=4e-5)
        assert ((ids >= 0) & (ids < n_valid)).all()
        torch.testing.assert_close(full.gather(1, ids.long()), vals, rtol=0, atol=4e-5)
        assert (vals[:, 1:] <= vals[:, :-1]).all()
        top = torch.sort(full[:, :n_valid], dim=1, descending=True).values[:, : k + 1]
        if (top[:, :-1] - top[:, 1:]).min().item() > 1e-4:  # no near-tie in or at the top k
            assert torch.equal(ids, r_ids)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_topk_stream_ties_and_short_corpus(dev, dtype):
    """Bit-identical duplicate rows rank by id, also when they lie in
    different blocks' chunks; fewer valid rows than k pad with NEG_INF / -1;
    one tile; the public functions agree with the plain version; at B = 1,
    9, 17 and 32 and H = 24 (48 for int8 rows: a k-tail)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    d = _unit_rows(gen, 300 * 128, 128, dev)
    for dup in (1000, 20_000, 37_000):  # chunks apart
        d[dup + 1] = d[1000]
        d[dup] = d[1000]
    q = _unit_rows(gen, 4, 128, dev)

    def search(q, d, k, n_valid=None):
        """(kernel, plain version) of the public function."""
        n = d.shape[0] if n_valid is None else n_valid
        if dtype == torch.int8:
            values, scales = _int8_rows(d)
            return (fused_topk_int8(q.bfloat16(), values, scales, k=k, n_valid=n_valid),
                    topk_stream_reference(q.bfloat16(), values, k, n, scales))
        return (fused_topk(q.to(dtype), d.to(dtype), k=k, n_valid=n_valid),
                topk_stream_reference(q.to(dtype), d.to(dtype), k, n))

    (vals, ids), _ = search(q, d, 128)
    for row in ids.tolist():
        pos = [row.index(i) for i in (1000, 1001, 20_000, 20_001, 37_000, 37_001) if i in row]
        assert pos == sorted(pos)
    (vals, ids), _ = search(q, d, 10, n_valid=3)
    assert (ids[:, 3:] == -1).all() and (vals[:, 3:] <= NEG_INF).all()
    assert sorted(ids[0, :3].tolist()) == [0, 1, 2]
    tail = 48 if dtype == torch.int8 else 24  # int8 rows are 16-byte multiples
    # one tile, then k-tails at B = 1, 9, 17, 32
    for B, H, rows, n_valid in ((4, 128, 128, 100), (1, tail, 4096, 4000), (9, tail, 4096, 4000),
                                (17, tail, 4096, 4000), (32, tail, 4096, 4000)):
        qq, dd = _unit_rows(gen, B, H, dev), _unit_rows(gen, rows, H, dev)
        (vals, ids), (r_vals, _) = search(qq, dd, 50, n_valid=n_valid)
        torch.testing.assert_close(vals, r_vals, rtol=0, atol=4e-5)
        assert ((ids >= 0) & (ids < n_valid)).all()


def test_topk_stream_wrappers_reject_what_the_kernel_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    docs = _unit_rows(gen, 256, 64, dev).bfloat16()
    q = _unit_rows(gen, 4, 64, dev).bfloat16()
    with pytest.raises(ValueError, match="k in"):
        topk_stream(q, docs, 129, 256)  # beyond the 128 keys the kernel keeps
    with pytest.raises(ValueError):
        topk_stream(torch.cat([q] * 9), docs, 10, 256)  # 36 query rows
    with pytest.raises(ValueError):
        topk_stream(q, docs[:200], 10, 200)  # rows not a multiple of 128
    with pytest.raises(ValueError):
        topk_stream(q.float(), docs, 10, 256)  # dtypes differ
    # past the widest width a launch takes at k=128, no layout
    widest = _topk.scan_max_h(torch.bfloat16, 128)
    wide = torch.zeros((256, widest + 8), dtype=torch.bfloat16, device=dev)
    before = topk_stream.launches
    with pytest.raises(ValueError, match=f"k=128: it takes H up to {widest}"):
        topk_stream(wide[:1], wide, 128, 256)
    assert topk_stream.launches == before
    half = wide[:, :2048].contiguous()
    vals, ids = topk_stream(half[:32], half, 128, 256)  # 32 rows, k=128 at H=2048: one launch
    assert ids.tolist() == [list(range(128))] * 32
    assert topk_stream.launches == before + 1
    values = torch.zeros((256, 64), dtype=torch.int8, device=dev)
    scales = torch.ones(256, device=dev)
    with pytest.raises(ValueError):
        topk_stream_int8(q.float(), values, scales, 10, 256)  # queries not bf16
    with pytest.raises(ValueError):
        topk_stream_int8(q, values, scales[:128], 10, 256)  # scales not per row
    with pytest.raises(ValueError):
        segmax_int8(torch.cat([q] * 9), values, scales, 256)
    with pytest.raises(ValueError):
        segmax_int8(q[:, :40], values[:, :40].contiguous(), scales, 256)  # int8 rows of 40 bytes


# ---------------------------------------------------------------------------
# fused attention (csrc/attention.cu)
# ---------------------------------------------------------------------------

# Kernel against plain version, as a share of the plain result's largest
# magnitude. A CPU run of the plain version against itself with float64
# sums (the same rounding points; R=512 T=128 and T=32, R=64 T=512, hd=32)
# differed by at most 5e-7 of it at f32 compute, and by 6.1e-4 at bf16
# compute, where a last-bit change of a sum can move p or ds across a bf16
# rounding boundary. Hence 1e-5 (f32) and one bf16 ulp, 2^-8 (bf16).
_ATTN_REL = {"float32": 1e-5, "bfloat16": 2 ** -8}


def _attention_case(dev, R, T, hd, in_dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((R, T, hd), generator=gen, device=dev) for _ in range(4))
    lengths = torch.randint(1, T + 1, (R,), generator=gen, device=dev)
    lengths[: min(R, 3)] = torch.tensor([0, 1, T], device=dev)[: min(R, 3)]
    bias = torch.where(torch.arange(T, device=dev)[None, :] < lengths[:, None], 0.0, -1e9)
    return (q.to(in_dtype), k.to(in_dtype), v.to(in_dtype), bias), do


def _close(got, want, rel, what):
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), (what, err, want.abs().max().item())


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,T,hd", [(8, 16, 8), (6, 33, 16), (128, 32, 32), (64, 128, 32),
                                    (16, 512, 32), (4, 200, 64)])
def test_attention_kernels_match_plain_version(dev, cdt, in_dtype, R, T, hd):
    """Forward and backward, rows of length 0, 1 and T among them; T=33 and
    T=200 leave a partial tile of rows, T=512 runs four query tiles."""
    args, do = _attention_case(dev, R, T, hd, in_dtype, seed=R + T + hd)
    scale = float(1.0 / np.sqrt(hd))
    before = attention_fwd.launches, attention_bwd.launches
    out = attention_fwd(*args, scale, cdt)
    grads = attention_bwd(*args, do, scale, cdt)
    assert (attention_fwd.launches, attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    _close(out, attention_fwd_reference(*args, scale, cdt), _ATTN_REL[cdt], "out")
    for name, g, r in zip("qkv", grads, attention_bwd_reference(*args, do, scale, cdt)):
        _close(g, r, _ATTN_REL[cdt], f"d{name}")
    assert all(bool(torch.isfinite(t).all()) for t in (out, *grads))
    # row 0 is fully masked: it attends uniformly, so every output row is
    # the mean of v (p = 1/T rounded to the compute dtype)
    v0 = args[2][0].to(torch.bfloat16 if cdt == "bfloat16" else torch.float32).float()
    torch.testing.assert_close(out[0], v0.mean(0).expand(T, hd), rtol=0, atol=4 * _ATTN_REL[cdt])


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16], ids=["f32-in", "bf16-in"])
@pytest.mark.parametrize("hd", [8, 32, 64])
@pytest.mark.parametrize("T", [1, 33, 128, 130, 512])
def test_attention_tensor_core_kernels_every_shape(dev, T, hd, in_dtype):
    """bf16 compute (the tensor-core kernels) at ragged and whole tiles up to
    T = 512, hd = 8 (depth padded to 16) to 64: forward and backward hold
    their plain versions within one bf16 ulp of the scale, row 0 (every key
    masked) attends uniformly over its T keys, and two calls give the same
    bits."""
    R = 5
    args, do = _attention_case(dev, R, T, hd, in_dtype, seed=T * hd)
    scale = float(1.0 / np.sqrt(hd))
    outs = [attention_fwd(*args, scale, "bfloat16") for _ in range(2)]
    grads = [attention_bwd(*args, do, scale, "bfloat16") for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(x, y) for x, y in zip(grads[0], grads[1]))
    _close(outs[0], attention_fwd_reference(*args, scale, "bfloat16"), _ATTN_REL["bfloat16"], "out")
    for name, g, r in zip("qkv", grads[0], attention_bwd_reference(*args, do, scale, "bfloat16")):
        _close(g, r, _ATTN_REL["bfloat16"], f"d{name}")
    assert all(bool(torch.isfinite(t).all()) for t in (outs[0], *grads[0]))
    v0 = args[2][0].to(torch.bfloat16).float()
    torch.testing.assert_close(outs[0][0], v0.mean(0).expand(T, hd), rtol=0,
                               atol=4 * _ATTN_REL["bfloat16"])


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16], ids=["f32-in", "bf16-in"])
@pytest.mark.parametrize("hd", [8, 32, 64])
@pytest.mark.parametrize("T", [1, 33, 128, 130, 512])
def test_attention_split_kernels_every_shape(dev, T, hd, in_dtype):
    """f32 compute (the split tensor-core kernels: six products of three
    bf16 pieces) at ragged and whole tiles and chunks up to T = 512, hd = 8
    (depth padded to 16) to 64, f32 and bf16 inputs: one forward and one
    backward launch a call on the split route, both within the f32
    tolerance of their plain versions, row 0 (every key masked) uniform
    over its T keys, two calls bit-identical."""
    R = 5
    args, do = _attention_case(dev, R, T, hd, in_dtype, seed=T * hd + 1)
    scale = float(1.0 / np.sqrt(hd))
    before = (attention_fwd.launches, attention_bwd.launches,
              attention_fwd.by_route["split"], attention_bwd.by_route["split"])
    outs = [attention_fwd(*args, scale, "float32") for _ in range(2)]
    grads = [attention_bwd(*args, do, scale, "float32") for _ in range(2)]
    assert (attention_fwd.launches, attention_bwd.launches, attention_fwd.by_route["split"],
            attention_bwd.by_route["split"]) == tuple(n + 2 for n in before)
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(x, y) for x, y in zip(grads[0], grads[1]))
    _close(outs[0], attention_fwd_reference(*args, scale, "float32"), _ATTN_REL["float32"], "out")
    for name, g, r in zip("qkv", grads[0], attention_bwd_reference(*args, do, scale, "float32")):
        _close(g, r, _ATTN_REL["float32"], f"d{name}")
    assert all(bool(torch.isfinite(t).all()) for t in (outs[0], *grads[0]))
    v0 = args[2][0].float()
    torch.testing.assert_close(outs[0][0], v0.mean(0).expand(T, hd), rtol=0,
                               atol=4 * _ATTN_REL["float32"] * v0.abs().max().item())


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
def test_attention_split_kernels_every_layout(dev, hd):
    """Every layout attention_plan can pick at f32 compute for this head
    width (query tile, chunk and key tile; one T each, the largest that
    takes it) launches, and its forward and backward hold their plain
    versions within the f32 tolerance."""
    from twotowermlretrieval_tpu_torch.ops.attention import MAX_T, attention_plan

    layouts = {}
    for T in range(1, MAX_T + 1):
        p = attention_plan(T, hd, "float32")
        layouts[(p["fwd"]["rows"], p["fwd"]["kc"], p["dkv"]["rows"])] = T
    assert len(layouts) >= 8
    for T in layouts.values():
        args, do = _attention_case(dev, 3, T, hd, torch.float32, seed=T + hd)
        _close(attention_fwd(*args, 0.3, "float32"),
               attention_fwd_reference(*args, 0.3, "float32"), _ATTN_REL["float32"], f"out T={T}")
        for name, g, r in zip("qkv", attention_bwd(*args, do, 0.3, "float32"),
                              attention_bwd_reference(*args, do, 0.3, "float32")):
            _close(g, r, _ATTN_REL["float32"], f"d{name} T={T}")


@pytest.mark.parametrize("T", [444, 480, 512])
def test_attention_f32_compute_hd64_long(dev, T):
    """f32 compute at hd = 64 over seven and eight chunks of 64 keys (the
    last one partial at T = 444 and 480): forward and backward against their
    plain versions at the f32 tolerance, rows of length 0, 1 and T among
    them, two calls bit-identical."""
    args, do = _attention_case(dev, 6, T, 64, torch.float32, seed=T)
    scale = 0.125
    out = attention_fwd(*args, scale, "float32")
    grads = attention_bwd(*args, do, scale, "float32")
    _close(out, attention_fwd_reference(*args, scale, "float32"), _ATTN_REL["float32"], "out")
    for name, g, r in zip("qkv", grads, attention_bwd_reference(*args, do, scale, "float32")):
        _close(g, r, _ATTN_REL["float32"], f"d{name}")
    assert torch.equal(out, attention_fwd(*args, scale, "float32"))
    assert all(torch.equal(a, b) for a, b in zip(grads, attention_bwd(*args, do, scale, "float32")))


def test_attention_kernels_are_deterministic(dev):
    args, do = _attention_case(dev, 512, 128, 32, torch.float32, seed=3)
    a = attention_bwd(*args, do, 0.17, "bfloat16")
    b = attention_bwd(*args, do, 0.17, "bfloat16")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(attention_fwd(*args, 0.17, "bfloat16"), attention_fwd(*args, 0.17, "bfloat16"))


def test_fused_attention_autograd_on_the_card(dev):
    """The autograd Function on the card against itself on the CPU, with
    bf16 inputs kept as f32 gradients (input_dtype)."""
    args, do = _attention_case(dev, 32, 64, 32, torch.float32, seed=5)
    outs = {}
    for where in (dev, torch.device("cpu")):
        q, k, v = (t.detach().to(where).requires_grad_(True) for t in args[:3])
        o = fused_attention(q, k, v, args[3].to(where), 0.2, "bfloat16", input_dtype=torch.bfloat16)
        o.backward(do.to(where))
        outs[where.type] = [o.detach().cpu(), q.grad.cpu(), k.grad.cpu(), v.grad.cpu()]
        assert q.grad.dtype == torch.float32
    for got, want in zip(outs["cuda"], outs["cpu"]):
        _close(got, want, _ATTN_REL["bfloat16"], "autograd")


def test_attention_wrappers_reject_what_the_kernel_does_not_take(dev):
    args, do = _attention_case(dev, 4, 16, 32, torch.float32, seed=0)
    q, k, v, bias = args
    with pytest.raises(ValueError, match="head widths"):
        attention_fwd(q[..., :24], k[..., :24], v[..., :24], bias, 0.2)
    long = torch.zeros((1, 513, 32), device=dev)
    with pytest.raises(ValueError, match="T <= 512"):
        attention_fwd(long, long, long, torch.zeros((1, 513), device=dev), 0.2)
    with pytest.raises(ValueError):
        attention_fwd(q, k.cpu(), v, bias, 0.2)
    with pytest.raises(ValueError):
        attention_bwd(q, k, v, bias, do[:, :8], 0.2)
    # hd = 64 at T = 444 and 512: both compute dtypes take it (f32 compute
    # streams its keys and values in chunks of 64)
    for T in (444, 512):
        (wq, wk, wv, wbias), wdo = _attention_case(dev, 3, T, 64, torch.float32, seed=T)
        for cdt in ("bfloat16", "float32"):
            out = attention_fwd(wq, wk, wv, wbias, 0.1, cdt)
            _close(out, attention_fwd_reference(wq, wk, wv, wbias, 0.1, cdt), _ATTN_REL[cdt], "out")


@pytest.mark.parametrize("fused", [True, None])
def test_transformer_tower_on_the_card_matches_the_cpu(dev, fused):
    """A small transformer two-tower, f32: encodes and gradients on the card
    (the kernels, or the torch route) equal the CPU's plain versions."""
    from twotowermlretrieval_tpu_torch.models.transformer import (
        TransformerSpec,
        init_transformer_encoder,
        transformer_encode,
    )
    from twotowermlretrieval_tpu_torch.models.two_tower import to_device
    from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves

    spec = TransformerSpec(vocab_size=60, embed_dim=16, hidden_dim=64, num_layers=2,
                           num_heads=2, ffn_dim=128, compute_dtype="float32", max_len=40,
                           fused_attention=fused)
    params = init_transformer_encoder(torch.Generator().manual_seed(0), spec)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 60, (12, 40), generator=gen)
    lengths = torch.randint(1, 41, (12,), generator=gen)
    lengths[:2] = torch.tensor([0, 40])
    res = {}
    for where in (dev, torch.device("cpu")):
        p = to_device(params, where)
        leaves = [t.requires_grad_(True) for _, t in named_leaves(p)]
        before = attention_bwd.launches
        out = transformer_encode(p, tokens.to(where), lengths.to(where), spec)
        grads = torch.autograd.grad((out * torch.arange(64.0, device=where)).sum(), leaves)
        if where.type == "cuda" and fused:
            assert attention_bwd.launches == before + 2
        res[where.type] = [out.detach().cpu()] + [g.cpu() for g in grads]
    for got, want in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the IVF index (plain PyTorch) on the card
# ---------------------------------------------------------------------------


def test_ivf_search_on_the_card_matches_the_cpu(dev):
    """One index searched on the card and on the CPU: the same ids, scores
    within 1e-5 relative (f32 sums of the same products in another order),
    every result on the card; an index built on the card partitions the
    corpus and, fully probed, returns the exact top-k."""
    from twotowermlretrieval_tpu_torch.ops.ivf import build_ivf, ivf_search

    rng = np.random.default_rng(5)
    centres = rng.standard_normal((48, 64)).astype(np.float32)
    docs = centres[rng.integers(0, 48, 20000)] + 0.3 * rng.standard_normal((20000, 64))
    docs = (docs / np.linalg.norm(docs, axis=1, keepdims=True)).astype(np.float32)
    q = torch.from_numpy(docs[:16] + 0.05).float()
    for storage in ("float32", "bfloat16", "int8"):
        cpu = build_ivf(docs, num_clusters=64, iters=4, storage_dtype=storage, device="cpu")
        card = cpu.to(dev)
        C = int(cpu.centroids.shape[0])
        for nprobe in (1, 8, C):
            c_vals, c_ids = ivf_search(q, cpu, 20, nprobe)
            g_vals, g_ids = ivf_search(q.to(dev), card, 20, nprobe)
            assert g_vals.is_cuda and g_ids.is_cuda
            assert torch.equal(g_ids.cpu(), c_ids), (storage, nprobe)
            torch.testing.assert_close(g_vals.cpu(), c_vals, rtol=1e-5, atol=0)
    built = build_ivf(docs, num_clusters=64, iters=4, storage_dtype="float32", device=dev)
    assert built.docs.is_cuda
    real = built.ids[built.ids >= 0]
    assert real.numel() == 20000 and torch.unique(real).numel() == 20000
    vals, ids = ivf_search(q.to(dev), built, 20, int(built.centroids.shape[0]))
    e_vals, e_ids = topk_oracle(q.to(dev), torch.from_numpy(docs).to(dev), 20)
    assert torch.equal(ids.long(), e_ids)
    torch.testing.assert_close(vals, e_vals, rtol=1e-5, atol=0)


def _sharded_docs(seed, n, h):
    rng = np.random.default_rng(seed)
    docs = rng.standard_normal((n, h)).astype(np.float32)
    q = rng.standard_normal((16, h)).astype(np.float32)
    return (docs / np.linalg.norm(docs, axis=1, keepdims=True)), q


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_sharded_index_on_a_repeated_card_matches_one_device(dev, storage, D):
    """A RetrievalIndex split over D shards of the one card (a device list
    that repeats it) against the single-device index: the same ids, int8
    scores bit for bit, bf16 and f32 within 1e-5 relative; each search
    launches its scan kernel once a shard and no plain version runs."""
    from twotowermlretrieval_tpu_torch.parallel.mesh import make_device_mesh
    from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex

    docs, q = _sharded_docs(40 + D, 70_000, 72)  # 72 columns: padded to 80 on the card
    mesh = make_device_mesh(D, 1, [dev] * D)
    one = RetrievalIndex(docs, storage, device=dev)
    sharded = RetrievalIndex(docs, storage, mesh=mesh)
    assert sharded.kernel_on() and all(t.is_cuda and t.shape[1] == 80 for t in sharded._docs)
    kernel = segmax_s8 if storage == "int8" else segmax
    for B in (1, 16):
        kernel.launches = 0
        vals, ids = sharded.search(q[:B], 50)
        assert kernel.launches == D
        o_vals, o_ids = one.search(q[:B], 50)
        np.testing.assert_array_equal(ids, o_ids)
        if storage == "int8":
            np.testing.assert_array_equal(vals, o_vals)
        else:
            np.testing.assert_allclose(vals, o_vals, rtol=1e-5, atol=0)


def test_sharded_scans_with_padding_only_shards(dev):
    """Small corpora over 4 shards of the card, where the tail shards hold
    only padding: each distributed search gives the single-device route's
    ids (s8 scores bit for bit, bf16 and per-row int8 within 1e-5
    relative), and a padding-only shard's own kernel search returns NEG_INF
    and -1."""
    from twotowermlretrieval_tpu_torch.parallel import topk as ptopk
    from twotowermlretrieval_tpu_torch.parallel.mesh import make_device_mesh

    mesh = make_device_mesh(4, 1, [dev] * 4)
    docs, q = _sharded_docs(50, 1000, 64)
    qt = torch.from_numpy(q).to(dev)
    k = 20
    small = docs[:20]  # 8 rows a shard: 8, 8, 4 and a shard of padding
    shards, n = ptopk.shard_corpus(small, mesh, torch.bfloat16)
    vals, ids = ptopk.distributed_topk(qt, shards, k, mesh, n_valid=n)
    want = fused_topk_segmax(qt.bfloat16(), torch.from_numpy(small).to(dev).bfloat16(), k=k)
    assert torch.equal(ids, want[1])
    torch.testing.assert_close(vals, want[0], rtol=1e-5, atol=0)
    e_vals, e_ids = fused_topk_segmax(qt.bfloat16(), shards[3], k=8, n_valid=0)
    assert (e_vals == NEG_INF).all() and (e_ids == -1).all()
    values, scales, n = ptopk.shard_corpus_int8(small, mesh)
    vals, ids = ptopk.distributed_topk_int8(qt, values, scales, k, mesh, n_valid=n)
    v, s = (torch.from_numpy(a).to(dev) for a in quantize_rows(small))
    want = fused_topk_int8(qt, v, s, k=k)
    assert torch.equal(ids, want[1])
    torch.testing.assert_close(vals, want[0], rtol=1e-5, atol=0)
    e_vals, e_ids = fused_topk_int8(qt, values[3], scales[3], k=8, n_valid=0)
    assert (e_vals == NEG_INF).all() and (e_ids == -1).all()
    values, seg_scales, n = ptopk.shard_corpus_s8(docs, mesh)  # 1024 rows a shard: 3 of padding
    vals, ids = ptopk.distributed_topk_s8(qt, values, seg_scales, k, mesh, n_valid=n)
    v, s = (torch.from_numpy(a).to(dev) for a in quantize_segments(np.pad(docs, ((0, 24), (0, 0)))))
    want = fused_topk_segmax_s8(qt, v, s, k=k, n_valid=1000)
    assert torch.equal(ids, want[1]) and torch.equal(vals, want[0])
    e_vals, e_ids = fused_topk_segmax_s8(qt, values[2], seg_scales[2], k=k, n_valid=0)
    assert (e_vals == NEG_INF).all() and (e_ids == -1).all()
