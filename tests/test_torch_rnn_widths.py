"""Every width on the recurrent kernels: their plans and the zero padding.

The forward kernel runs H rounded up to 8 and the backward H rounded up to
4; the model pads each layer once to ``kernel_width`` (H rounded up to 8)
with ``pad_layer``, and so do the wrappers for a call at another width.
A padded unit with zero xp, weights, bias and state stays zero and feeds
nothing into the real units, so the padded run of the plain versions
equals the unpadded one. Tolerance 1e-6: the same f32 arithmetic, the
products' sums taken over extra zero terms (which may change the
summation blocking of the CPU's matmul). The plans are pure functions of
the shape, so this file needs no card; the kernels themselves are held at
these widths on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from twotowermlretrieval_tpu.ops.rnn_scan import plan_fused
from twotowermlretrieval_tpu_torch.ops.rnn_scan import (
    _SMEM_LIMIT,
    H100_SXM_CLUSTER_SLOTS,
    _bwd_reference,
    _bwd_smem_bytes,
    _fwd_smem_bytes,
    bwd_plan,
    fwd_plan,
    kernel_width,
    pad_layer,
    pad_units,
    rnn_layer_fwd_reference,
)

_GATES = {"GRU": 3, "LSTM": 4, "RNN": 1}
_BATCHES = (1, 16, 128, 1024)
_CASES = [(c, d) for c in ("GRU", "LSTM", "RNN") for d in ("bfloat16", "float32")]


def _fwd_layout_ok(cell, H, cdt, plan) -> bool:
    """The plan's fields hang together. A CTA holds at most 32 (16 x 8)
    units (8 rows, at f32, count as one unit's), 48 in the large-batch
    layout (``wide``, bf16 and W resident only). Where W streams, its ring
    has at least 2 stages of whole k32 steps at bf16 (k16 steps at f32)
    and one or two h row blocks; where it is resident, no ring and two h
    row blocks (the large-batch layout: one, as regions). The pieces only
    at f32."""
    cb = torch.tensor([], dtype=getattr(torch, cdt)).element_size()
    Hk, nc, hc, R, kc = plan["H"], plan["nc"], plan["hc"], plan["rows"], plan["kc"]
    wsplit, wide, blocks = plan["wsplit"], plan["wide"], plan["blocks"]
    kp = -(-Hk // 32) * 32
    held = (-(-R // 16) * (hc // 8) <= (48 if wide else 32)
            and (R % 16 == 0 or (cb == 4 and R == 8)))
    if plan["resident"]:
        ring = plan["wstages"] == 0 and blocks == (1 if wide else 2)
    else:
        ring = 2 <= plan["wstages"] <= 8 and blocks in (1, 2) and not wide
    return (Hk >= H and Hk % 8 == 0 and Hk - H < 8 and 1 <= nc <= 16 and hc % 8 == 0
            and (nc <= 8 or H100_SXM_CLUSTER_SLOTS[nc] > 0)
            and nc * hc >= Hk > (nc - 1) * hc and held
            and kc % (32 if cb == 2 else 16) == 0 and (cb == 4 or not wsplit)
            and (cb == 2 or not wide)
            and plan["resident"] == (kc >= kp) and ring
            and plan["smem"] == _fwd_smem_bytes(cell, Hk, cb, R, hc, kc, plan["wstages"],
                                                blocks, wsplit, wide) <= _SMEM_LIMIT)


@pytest.mark.parametrize("cell,cdt", _CASES, ids=[f"{c}-{d}" for c, d in _CASES])
def test_fwd_plan_takes_every_width_up_to_1024(cell, cdt):
    """A layout within shared memory for every H in 1..1024 at every batch
    size the main path uses, both compute dtypes."""
    for B in _BATCHES:
        for H in range(1, 1025):
            plan = fwd_plan(cell, 32, B, H, 2, cdt)
            assert plan is not None and _fwd_layout_ok(cell, H, cdt, plan), (cell, cdt, B, H, plan)
            assert plan["clusters"] * plan["rows"] >= B


# the widest forward layer of each cell and compute dtype (module docstring;
# clusters of 16 past what clusters of 8 hold, one h row block past what
# two leave a ring of W for)
_FWD_WIDEST = {("GRU", "bfloat16"): 4032, ("GRU", "float32"): 4064,
               ("LSTM", "bfloat16"): 3520, ("LSTM", "float32"): 3520,
               ("RNN", "bfloat16"): 4096, ("RNN", "float32"): 4096}
# the widest backward layer at an f32 history (bf16: the bf16 history too);
# past one whole dhp row block the row block is exchanged in chunks, so the
# limit is a CTA's units (16 x 8 tiles, 4096 at clusters of 16) or, for
# LSTM at bf16, its staging buffers
_BWD_WIDEST = {("GRU", "bfloat16", "f32"): 4096, ("GRU", "bfloat16", "bf16"): 4096,
               ("GRU", "float32", "f32"): 4096, ("LSTM", "bfloat16", "f32"): 3328,
               ("LSTM", "bfloat16", "bf16"): 3584, ("LSTM", "float32", "f32"): 4096,
               ("RNN", "bfloat16", "f32"): 4096, ("RNN", "bfloat16", "bf16"): 4096,
               ("RNN", "float32", "f32"): 4096}


@pytest.mark.parametrize("cell,cdt", _CASES, ids=[f"{c}-{d}" for c, d in _CASES])
def test_fwd_plan_limit_and_beyond(cell, cdt):
    """The stated widest layer has a plan at every batch size; the next
    width has none (the wrapper refuses it), whatever the batch."""
    top = _FWD_WIDEST[cell, cdt]
    for B in _BATCHES:
        plan = fwd_plan(cell, 4, B, top, 2, cdt)
        assert plan is not None and _fwd_layout_ok(cell, top, cdt, plan)
        assert fwd_plan(cell, 4, B, top + 1, 2, cdt) is None


# the widest backward layer that two dhp row blocks leave room for
_BWD_TWO_BLOCKS = {("GRU", "bfloat16", "f32"): 816, ("GRU", "bfloat16", "bf16"): 832,
                   ("GRU", "float32", "f32"): 916, ("LSTM", "bfloat16", "f32"): 608,
                   ("LSTM", "bfloat16", "bf16"): 628, ("LSTM", "float32", "f32"): 700,
                   ("RNN", "bfloat16", "f32"): 2048, ("RNN", "bfloat16", "bf16"): 2048,
                   ("RNN", "float32", "f32"): 2048}


@pytest.mark.parametrize("cell,cdt,hist", list(_BWD_WIDEST),
                         ids=[f"{c}-{d}-{h}" for c, d, h in _BWD_WIDEST])
def test_bwd_plan_with_padding_takes_every_width_up_to_its_limit(cell, cdt, hist):
    """Every H up to the stated limit, the ragged ones padded to a multiple
    of 4, has a layout, and the next width has none. The main path's H=256
    keeps W resident and two dhp row blocks; past the room two blocks leave
    (816 / 608 / 2048 at bf16, 916 / 700 / 2048 at f32, f32 history) the
    plan keeps one, or exchanges the row block in chunks through two chunk
    buffers."""
    hdt = torch.bfloat16 if hist == "bf16" else torch.float32
    cb, hb = (2 if cdt == "bfloat16" else 4), hdt.itemsize
    top = _BWD_WIDEST[cell, cdt, hist]
    for B in _BATCHES:
        for H in range(1, top + 1):
            plan = bwd_plan(cell, 32, B, H, 2, cdt, hdt)
            assert plan is not None, (cell, cdt, hist, B, H)
            assert plan["H"] % 4 == 0 and 0 <= plan["H"] - H < 4
            assert plan["smem"] == _bwd_smem_bytes(cell, plan["H"], cb, hb, plan["rows"],
                                                   plan["hc"], plan["kc"], plan["stages"],
                                                   plan["blocks"], plan["xc"], plan["wstages"],
                                                   plan["kw"])
            assert plan["smem"] <= _SMEM_LIMIT
            kp = -(-_GATES[cell] * plan["H"] // 16) * 16
            chunked = plan["xc"] < kp
            assert not chunked or (plan["kc"] == plan["xc"] and plan["blocks"] == 2
                                   and plan["xc"] % 16 == 0)
            assert plan["blocks"] == 1 or chunked or H <= _BWD_TWO_BLOCKS[cell, cdt, hist]
    main = bwd_plan(cell, 32, 128, 256, 2, cdt, hdt)
    assert main["resident"] and main["blocks"] == 2 and main["nc"] == 8
    assert bwd_plan(cell, 32, 128, top + 1, 2, cdt, hdt) is None


_JAX_CASES = [(c, d) for c in ("GRU", "LSTM", "RNN") for d in ("bfloat16", "float32")]


@pytest.mark.parametrize("cell,cdt", _JAX_CASES, ids=[f"{c}-{d}" for c, d in _JAX_CASES])
def test_every_width_jax_keeps_on_its_kernels_has_both_plans(cell, cdt):
    """Wherever the JAX package's plan_fused keeps a layer on its Pallas
    kernels (H a multiple of 128 up to 4096, D=2, B in 16, 64, 128, 1024),
    both of the port's passes have a layout within shared memory at the
    model's history dtype (bf16 under bf16 compute, f32 under f32), so a
    card runs it on the hand-written kernels. The main path's H=256 keeps
    its layouts: clusters of 8 and, at bf16, W resident and two dhp row
    blocks (one at B=1024, the backward's large-batch layout)."""
    G = _GATES[cell]
    cb = 2 if cdt == "bfloat16" else 4
    hist = torch.bfloat16 if cdt == "bfloat16" else torch.float32
    covered = 0
    for B in (16, 64, 128, 1024):
        for H in range(128, 4097, 128):
            if plan_fused(B, H, G * H, 2, cb) is None:
                continue
            covered += 1
            fwd = fwd_plan(cell, 32, B, H, 2, cdt, hist)
            bwd = bwd_plan(cell, 32, B, H, 2, cdt, hist)
            assert fwd is not None and _fwd_layout_ok(cell, H, cdt, fwd), (cell, cdt, B, H)
            assert bwd is not None and bwd["smem"] <= _SMEM_LIMIT, (cell, cdt, B, H)
            assert bwd["nc"] <= 16 and H100_SXM_CLUSTER_SLOTS[bwd["nc"]] > 0
        main_f = fwd_plan(cell, 32, B, 256, 2, cdt, hist)
        main_b = bwd_plan(cell, 32, B, 256, 2, cdt, hist)
        assert main_f["nc"] == 8 and main_b["nc"] == 8
        if cdt == "bfloat16":  # the main path's compute dtype
            assert main_f["resident"] and main_b["resident"] and main_b["wide"] == (B == 1024)
            assert main_b["blocks"] == (1 if main_b["wide"] else 2)
            assert main_b["xc"] == G * 256
    assert covered >= 4 * 7  # every cell keeps H=128..896 on its kernels at every B


def _layer(cell, D, T, B, H, seed):
    G = _GATES[cell]
    rng = np.random.default_rng(seed)
    xps = [torch.from_numpy(rng.normal(size=(T, B, G * H)).astype(np.float32)) for _ in range(D)]
    lengths = np.r_[T, 0, 1, rng.integers(1, T + 1, B - 3)]
    mask = torch.from_numpy((np.arange(T)[:, None] < lengths[None, :]).astype(np.float32))
    w_hh = torch.from_numpy((rng.normal(size=(D, H, G * H)) * 0.1).astype(np.float32))
    b_hh = torch.from_numpy((rng.normal(size=(D, G * H)) * 0.1).astype(np.float32))
    return xps, mask, w_hh, b_hh


_PAD_CASES = [(c, h) for c in ("GRU", "LSTM", "RNN") for h in (30, 50, 150)]


@pytest.mark.parametrize("cell,H", _PAD_CASES, ids=[f"{c}-H{h}" for c, h in _PAD_CASES])
def test_zero_padding_is_exact_in_both_passes(cell, H):
    """The plain versions at the kernels' padded widths, their results
    sliced back, against the same plain versions at H: forward history,
    cell history and h_final; backward dxp, dW and db, and split mode's
    dxp and dhp."""
    D, T, B = 2, 5, 6
    cdt = "float32"
    xps, mask, w_hh, b_hh = _layer(cell, D, T, B, H, seed=H)
    outs, c_hist, fin = rnn_layer_fwd_reference(cell, xps, mask, w_hh, b_hh, cdt)

    Hp = kernel_width(H)
    assert Hp == fwd_plan(cell, T, B, H, D, cdt)["H"] and Hp % 8 == 0 and Hp > H
    w, b, xs = pad_layer(cell, Hp, w_hh, b_hh, xps)
    p_outs, p_c, p_fin = rnn_layer_fwd_reference(cell, xs, mask, w, b, cdt)
    for got, want in zip((*p_outs, *p_c, p_fin), (*outs, *c_hist, fin)):
        assert got.shape[-1] == Hp
        assert (got[..., H:] == 0).all()  # the padded units stay at zero
        torch.testing.assert_close(got[..., :H], want, rtol=0, atol=1e-6)

    rng = np.random.default_rng(H + 1)
    douts = [torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32)) for _ in range(D)]
    d_hfinal = torch.from_numpy(rng.normal(size=(D, B, H)).astype(np.float32))
    G = _GATES[cell]
    # the model's padding: both passes at the forward's width, the saved
    # history as the padded forward left it, the cotangents padded
    p_dos = [pad_units(d, 1, H, Hp) for d in douts]
    p_dhf = pad_units(d_hfinal, 1, H, Hp)

    def cut(x):
        return x.unflatten(-1, (G, Hp))[..., :H].flatten(-2)

    for split in (False, True):
        want = _bwd_reference(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal, cdt,
                              split)
        got = _bwd_reference(cell, xs, mask, w, b, p_outs, p_c, p_dos, p_dhf, cdt, split)
        assert all((cut_away == 0).all() for x in got[0] + got[1]
                   for cut_away in [x.unflatten(-1, (G, Hp))[..., H:]])
        got = ([cut(x) for x in got[0]], [cut(x) for x in got[1]],
               None if split else cut(got[2][:, :H]), None if split else cut(got[3]))
        for g, w_ in zip((*got[0], *got[1]), (*want[0], *want[1])):
            torch.testing.assert_close(g.float(), w_.float(), rtol=0, atol=1e-6)
        if not split:
            torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-6)
            torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-6)


@pytest.mark.parametrize("cell,cdt", _CASES, ids=[f"{c}-{d}" for c, d in _CASES])
def test_streamed_forward_plans_keep_a_ring_up_to_the_limit(cell, cdt):
    """Past 1024 and up to the widest layer, at a serving batch and the
    export's, every forward layout holds together and, where W streams,
    keeps a ring of at least 2 stages within shared memory."""
    for B in (16, 1024):
        for H in range(1032, _FWD_WIDEST[cell, cdt] + 1, 8):
            plan = fwd_plan(cell, 32, B, H, 2, cdt)
            assert plan is not None and _fwd_layout_ok(cell, H, cdt, plan), (B, H, plan)


@pytest.mark.parametrize("cell,cdt,hist", list(_BWD_WIDEST),
                         ids=[f"{c}-{d}-{h}" for c, d, h in _BWD_WIDEST])
def test_streamed_backward_plans_keep_a_ring(cell, cdt, hist):
    """Up to the widest layer, every backward layout that streams W keeps a
    ring of whole pieces of the chunk that orders the sums: where the dhp
    row block is exchanged whole, whole chunks, as many stages as fit (up
    to 8); where it is exchanged in chunks, two stages of the widest piece
    that leaves two (a multiple of 32 columns at bf16, 16 at f32), or
    whole chunks where they fit twice. Resident layouts have no ring."""
    hdt = torch.bfloat16 if hist == "bf16" else torch.float32
    cb, hb = (2 if cdt == "bfloat16" else 4), hdt.itemsize
    step = 32 if cb == 2 else 16
    for B in (16, 1024):
        for H in range(4, _BWD_WIDEST[cell, cdt, hist] + 1, 4):
            plan = bwd_plan(cell, 32, B, H, 2, cdt, hdt)
            if plan["resident"]:
                assert plan["wstages"] == 0
                continue
            kw, kc, S = plan["kw"], plan["kc"], plan["wstages"]
            kp = -(-_GATES[cell] * plan["H"] // 16) * 16

            def smem(stages, width):
                return _bwd_smem_bytes(cell, plan["H"], cb, hb, plan["rows"], plan["hc"], kc,
                                       plan["stages"], plan["blocks"], plan["xc"], stages, width)

            assert 1 <= S <= 8 and smem(S, kw) == plan["smem"] <= _SMEM_LIMIT, (B, H, plan)
            if plan["xc"] >= kp or kw == kc:  # whole chunks, as many as fit
                assert kw == kc and (S == 8 or smem(S + 1, kc) > _SMEM_LIMIT), (B, H, plan)
            else:  # two of the widest piece
                assert S == 2 and kw % step == 0
                assert smem(2, kc) > _SMEM_LIMIT, (B, H, plan)
                assert kw + step >= kc or smem(2, kw + step) > _SMEM_LIMIT, (B, H, plan)


# the reference towers' layouts before the W ring (the port at the commit
# that added it): H=256 at bf16 with a bf16 history, both passes; the
# forward at B=1024 in the large-batch layout since it came: 160 rows a
# cluster, 7 clusters a direction, one h row block (since its rebuild as
# 8 swizzled regions exchanged by bulk copies beside the warps' xp slots,
# 175,632 bytes; 138,112 as one padded block), one wave (before them
# 128 rows, 8 clusters a direction, two blocks, two waves of the 15 an
# H100 SXM holds); the backward at B=1024 in its large-batch layout since
# it came: 96 rows a cluster, 11 clusters a direction, nothing staged, one
# dhp row block, two waves (before them 32 rows, 32 clusters, two staging
# buffers and two blocks, five waves)
_MAIN_FWD = {16: (8, 32, 16, 1, 256, True, 2, 70528), 64: (8, 32, 32, 2, 256, True, 2, 87424),
             128: (8, 32, 32, 4, 256, True, 2, 87424),
             1024: (8, 32, 160, 7, 256, True, 1, 175632)}
_MAIN_BWD = {16: (8, 32, 16, 1, 768, True, 2, 2, 768, 8, 130176),
             64: (8, 32, 32, 2, 768, True, 2, 2, 768, 11, 210688),
             128: (8, 32, 32, 4, 768, True, 2, 2, 768, 11, 210688),
             1024: (8, 32, 96, 11, 768, True, 0, 1, 768, 11, 222496)}


@pytest.mark.parametrize("B", sorted(_MAIN_FWD))
def test_main_path_layouts_are_unchanged(B):
    """The reference towers (GRU H=256, bf16) keep W resident in both
    passes, field for field the layouts they had before the ring (at
    B=1024: the large-batch layouts'), and every cell at H=256
    and bf16 holds W resident with no ring."""
    f = fwd_plan("GRU", 32, B, 256, 2, "bfloat16", torch.bfloat16)
    b = bwd_plan("GRU", 32, B, 256, 2, "bfloat16", torch.bfloat16)
    assert tuple(f[k] for k in ("nc", "hc", "rows", "clusters", "kc", "resident", "blocks",
                                "smem")) == _MAIN_FWD[B]
    assert tuple(b[k] for k in ("nc", "hc", "rows", "clusters", "kc", "resident", "stages",
                                "blocks", "xc", "nsplit", "smem")) == _MAIN_BWD[B]
    assert f["wstages"] == 0 and b["wstages"] == 0
    for cell in ("GRU", "LSTM", "RNN"):
        for hist in (torch.bfloat16, torch.float32):
            f = fwd_plan(cell, 32, B, 256, 2, "bfloat16", hist)
            b = bwd_plan(cell, 32, B, 256, 2, "bfloat16", hist)
            assert f["resident"] and b["resident"] and f["wstages"] == b["wstages"] == 0


def test_f32_backward_takes_clusters_of_16_where_8_stream_w():
    """At f32 compute, where clusters of 8 would stream W, the backward's
    whole-block layouts try clusters of 16 first (each CTA draws half of W
    a step: GRU H=1024 B=64 T=32 took 7.15-7.49 ms in clusters of 16 against
    10.56 in 8 on an H100, PERF.md section 6); the reference towers keep W
    resident in clusters of 8, and bf16 keeps its layouts."""
    wide = bwd_plan("GRU", 32, 64, 1024, 2, "float32", torch.float32)
    assert (wide["nc"], wide["hc"], wide["rows"], wide["resident"], wide["xc"]) == \
        (16, 64, 8, False, 3 * 1024)
    for B in (64, 128):
        main = bwd_plan("GRU", 32, B, 256, 2, "float32", torch.float32)
        assert (main["nc"], main["rows"], main["resident"], main["blocks"]) == (8, 16, True, 2)
    bf16 = bwd_plan("GRU", 32, 64, 1024, 2, "bfloat16", torch.bfloat16)
    assert (bf16["nc"], bf16["hc"], bf16["rows"]) == (8, 128, 16)


# the forward's f32 layouts where W streams: (cell, H, B) -> (rows, kc,
# wsplit). W in its pieces in stages of any multiple of 16 rows, 32 at GRU
# H=1024 and 48 at RNN H=3072 (8 rows a CTA: 16, which the units allow,
# leave no ring of pieces beside the f32 h row block); in pieces of 16
# rows where f32 W would take 16 too; f32 where the pieces' stages would
# hold 16 rows and f32's 32, and where no ring of pieces fits
_F32_FWD_RINGS = {("GRU", 1024, 64): (16, 32, True), ("RNN", 3072, 16): (8, 48, True),
                  ("GRU", 3072, 16): (8, 16, True), ("LSTM", 1024, 64): (16, 32, False),
                  ("GRU", 4064, 16): (8, 16, False)}


@pytest.mark.parametrize("cell,H,B", list(_F32_FWD_RINGS),
                         ids=[f"{c}-H{h}-B{b}" for c, h, b in _F32_FWD_RINGS])
def test_f32_forward_w_form_follows_the_sweep(cell, H, B):
    """At f32 compute the forward holds W as its bf16 pieces or as f32 as
    the --layouts sweep on an H100 ordered them (PERF.md section 6): the
    pieces 1.25x faster in stages of 32 rows than f32 in 48 (GRU H=1024
    B=64), 1.11x in 48 against 64 (RNN H=3072 B=16), 1.04-1.08x slower in
    16 against 32."""
    plan = fwd_plan(cell, 32, B, H, 2, "float32", torch.float32)
    assert not plan["resident"] and plan["wstages"] >= 2
    assert (plan["rows"], plan["kc"], plan["wsplit"]) == _F32_FWD_RINGS[cell, H, B]


# the chunk that orders the backward's sums where W streams, at the shapes
# the streamed route was first timed (its bits are kept): (cell, H, B) -> kc
_BWD_CHUNKS = {("GRU", 512, 64): 928, ("GRU", 1024, 64): 208, ("GRU", 1792, 16): 512,
               ("LSTM", 1536, 16): 528, ("RNN", 3072, 16): 240}


@pytest.mark.parametrize("cell,H,B", list(_BWD_CHUNKS), ids=[f"{c}-H{h}-B{b}" for c, h, b in _BWD_CHUNKS])
def test_bwd_ring_pieces_keep_the_order_of_the_sums(cell, H, B):
    """The chain product sends the k16 step at chunk offset 64m + 16j to
    accumulator j. Walking a ring's pieces (kw columns of each kc chunk, a
    multiple of 32 or the whole chunk, 32 columns a step pair) gives every
    accumulator the same k16 steps in the same order as whole chunks did,
    at every piece width, so dh keeps its bits whatever the ring."""
    plan = bwd_plan(cell, 32, B, H, 2, "bfloat16", torch.bfloat16)
    assert not plan["resident"] and plan["kc"] == _BWD_CHUNKS[cell, H, B]
    kp = -(-_GATES[cell] * plan["H"] // 16) * 16
    kc = plan["kc"]
    whole = [[] for _ in range(4)]
    for k0 in range(0, kp, kc):
        klen = min(kc, kp - k0)
        for kk in range(0, klen, 64):  # one chunk at a time, four steps in flight
            for j in range(4):
                if kk + 16 * j < klen:
                    whole[j].append(k0 + kk + 16 * j)
    assert sorted(sum(whole, [])) == list(range(0, kp, 16))
    assert plan["kw"] in set(range(32, kc, 32)) | {kc}
    for kw in sorted(set(range(32, kc, 32)) | {kc}):
        pieces = [[] for _ in range(4)]
        for k0 in range(0, kp, kc):
            klen = min(kc, kp - k0)
            for p0 in range(0, klen, kw):  # the ring's pieces, a step pair at a time
                plen = min(kw, klen - p0)
                for kk in range(0, plen, 32):
                    hi = 2 if (p0 + kk) & 32 else 0
                    pieces[hi].append(k0 + p0 + kk)
                    if kk + 16 < plen:
                        pieces[hi + 1].append(k0 + p0 + kk + 16)
        assert pieces == whole, kw


# (cell, H, B) -> (cluster size, W resident) at bf16 with the model's bf16
# history: clusters of 16 where 8 would stream W and all of 16's clusters,
# at the rows 8 take, fit on an H100 SXM at once (7 of 16, 15 of 8)
_SIXTEEN = {("GRU", 512, 64): (16, True), ("GRU", 512, 96): (16, True),
            ("GRU", 512, 112): (8, False), ("GRU", 512, 128): (8, False),
            ("LSTM", 512, 64): (16, True), ("RNN", 1024, 16): (16, True),
            ("GRU", 1024, 16): (16, False), ("GRU", 1024, 64): (16, False),
            ("GRU", 1024, 1024): (8, False), ("GRU", 256, 64): (8, True)}


@pytest.mark.parametrize("cell,H,B", list(_SIXTEEN), ids=[f"{c}-H{h}-B{b}" for c, h, b in _SIXTEEN])
def test_fwd_plan_takes_clusters_of_16_in_one_wave(cell, H, B):
    """The forward's cluster size: resident in clusters of 16 over a
    streamed ring in clusters of 8 (GRU H=512 up to B=96), a ring in
    clusters of 16 where its clusters fit at once (GRU H=1024 at B=16, 64),
    clusters of 8 where 16 would take two waves (B=112 up), and the main
    path's H=256 unchanged in clusters of 8."""
    plan = fwd_plan(cell, 32, B, H, 2, "bfloat16", torch.bfloat16)
    assert (plan["nc"], plan["resident"]) == _SIXTEEN[cell, H, B]
    assert 2 * plan["clusters"] <= plan["slots"] or plan["nc"] == 8
