"""The recurrent forward's large-batch layout: its plans.

``ops/rnn_scan.py`` ``fwd_plan`` keeps its cluster route (4 units a warp,
every CTA keeping the whole h row block) except at bf16 and B >= 256 where
that route keeps W resident and takes more than one wave, and the
large-batch layout (6 units a warp, W resident beside one h row block)
takes fewer. Its h row block is one region a CTA (``regions``, rows of
``xld`` = hc elements, swizzled instead of padded), exchanged by bulk
copies. These tests hold the plans on an H100 SXM's cluster slots (pure
functions of the shape, no card), their shared memory against the
kernel's layout worked out by hand, and the instrumented build's phase
words against the kernel's. The kernel itself is held on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import hashlib
import re
from pathlib import Path

import pytest
import torch

from twotowermlretrieval_tpu_torch.ops.rnn_scan import (
    FWD_PHASE_NAMES,
    FWD_PHASE_WORDS,
    _SMEM_LIMIT,
    _UNITS_MAX,
    _UNITS_WIDE,
    H100_SXM_CLUSTER_SLOTS,
    _cluster_plan,
    _cluster_sizes,
    _fwd_regions,
    _fwd_smem_bytes,
    _up,
    fwd_plan,
    fwd_waves,
)

_CELLS = ("GRU", "LSTM", "RNN")
SLOTS = H100_SXM_CLUSTER_SLOTS

# The plans the change keeps, field for field the parent's: every plan of
# fwd_plan(cell, 32, B, H, 2, cdt, bf16) over the grid below that is not a
# large-batch layout (every f32 plan, every plan below B=256, and at bf16
# and B >= 256 those whose cluster route streams W, already took one wave,
# or as few as the large-batch layout), digested in the grid's order with
# the parent commit's fwd_plan (the port before the large-batch layout).
# 368 of the grid's 33,792 plans move.
_GRID_H = range(8, 4097, 8)
_GRID_B = (1, 16, 32, 64, 128, 192, 255, 256, 512, 1024, 2048)
_KEYS = ("H", "nc", "hc", "rows", "clusters", "kc", "resident", "wstages", "blocks", "smem",
         "slots", "wsplit")
_KEPT_DIGEST = "e01ce9d0eaebe0f7efb476d4d49f25e7a8831dfb9357d2afffd0793fad8391c5"
_KEPT_COUNT = 33424


def test_plans_off_the_large_batch_route_are_the_parents():
    """Every plan that is not a large-batch layout is the parent's, and the
    large-batch layout appears only at bf16 and B >= 256."""
    h = hashlib.sha256()
    kept = 0
    for cell in _CELLS:
        for cdt in ("bfloat16", "float32"):
            for H in _GRID_H:
                for B in _GRID_B:
                    plan = fwd_plan(cell, 32, B, H, 2, cdt, torch.bfloat16)
                    if plan is not None and plan["wide"]:
                        assert cdt == "bfloat16" and B >= 256, (cell, cdt, H, B)
                        continue
                    key = f"{cell} {cdt} {H} {B}"
                    h.update(repr((key, None if plan is None else [plan[k] for k in _KEYS]))
                             .encode())
                    kept += 1
    assert (h.hexdigest(), kept) == (_KEPT_DIGEST, _KEPT_COUNT)


def _fewest_resident_waves(cell, B, H, D=2):
    """The fewest waves any layout with W resident that the kernel takes at
    bf16 allows (a brute force over the cluster sizes and every multiple of
    16 rows a CTA's units hold: beside two h row blocks with 4 units a
    warp, or one with 6 as regions), on an H100 SXM's cluster slots."""
    Hk = _up(H, 8)
    kp = _up(Hk, 32)
    best = None
    for nc, hc in _cluster_sizes(Hk, SLOTS):
        for R in range(16, 257, 16):
            units = -(-R // 16) * (hc // 8)
            if units > _UNITS_WIDE:
                break
            wide = units > _UNITS_MAX
            if _fwd_smem_bytes(cell, Hk, 2, R, hc, kp, 0, 1 if wide else 2,
                               wide=wide) <= _SMEM_LIMIT:
                waves = -(-D * -(-B // R) // SLOTS[nc])
                best = waves if best is None else min(best, waves)
    return best


_LARGE = [(c, H, B) for c in _CELLS for H in (256, 1024) for B in (256, 512, 1024, 2048)]


@pytest.mark.parametrize("cell,H,B", _LARGE, ids=[f"{c}-H{h}-B{b}" for c, h, b in _LARGE])
def test_large_batch_plans_take_the_fewest_waves(cell, H, B):
    """At H=256 every batch up to 1024 takes one wave (B=1024: 160 rows, 7
    clusters of 8 a direction, 14 of the card's 15), and every batch as few
    waves as any layout with W resident allows, its shared memory its
    layout's, within the limit. At H=1024 W streams: the plan is the
    cluster route's at every batch (32 rows at B >= 1024, five waves at
    B=1024), since h carried beside W through L2 in three waves of 48 rows
    ran level with it on an H100 (PERF.md section 6)."""
    plan = fwd_plan(cell, 32, B, H, 2, "bfloat16", torch.bfloat16)
    waves = fwd_waves(plan, 2)
    assert plan["smem"] == _fwd_smem_bytes(cell, plan["H"], 2, plan["rows"], plan["hc"],
                                           plan["kc"], plan["wstages"], plan["blocks"],
                                           wide=plan["wide"])
    assert plan["smem"] <= _SMEM_LIMIT
    assert plan["clusters"] * plan["rows"] >= B
    if H == 256:
        assert plan["resident"] and waves == _fewest_resident_waves(cell, B, H), (plan, waves)
        if B <= 1024:
            assert waves == 1, plan
        assert plan["wide"] == (B >= 1024), plan
    else:
        assert not plan["resident"] and not plan["wide"], plan
        assert plan == _cluster_plan(cell, B, H, 2, 2, SLOTS)
        if B >= 1024:
            assert plan["rows"] == 32 and waves == -(-2 * -(-B // 32) // SLOTS[8]), plan


def test_export_shapes_take_the_expected_layouts():
    """The two export shapes: GRU H=256 B=1024 in the large-batch layout
    (W resident, 160 rows, 5 units a warp, one h row block, one wave; LSTM
    and RNN alike), GRU H=1024 B=1024 in the cluster route (clusters of 8,
    W streamed, 32 rows, five waves)."""
    for cell in _CELLS:
        p = fwd_plan(cell, 128, 1024, 256, 2, "bfloat16", torch.bfloat16)
        assert (p["wide"], p["nc"], p["rows"], p["clusters"], p["blocks"], fwd_waves(p, 2)) == \
            (True, 8, 160, 7, 1, 1)
    assert fwd_plan("GRU", 128, 1024, 256, 2, "bfloat16", torch.bfloat16)["smem"] == 175632
    p = fwd_plan("GRU", 128, 1024, 1024, 2, "bfloat16", torch.bfloat16)
    assert (p["wide"], p["nc"], p["hc"], p["rows"], p["clusters"], p["resident"],
            fwd_waves(p, 2)) == (False, 8, 128, 32, 32, False, 5)
    # f32 compute keeps the cluster route at every batch
    for B in (256, 1024, 2048):
        for H in (256, 1024):
            assert not fwd_plan("GRU", 32, B, H, 2, "float32")["wide"]


# the widths of _GRID_H whose plan moves, per cell and batch (368 in all)
_MOVED = {("GRU", 256): 0, ("GRU", 512): 16, ("GRU", 1024): 32, ("GRU", 2048): 40,
          ("LSTM", 256): 0, ("LSTM", 512): 8, ("LSTM", 1024): 24, ("LSTM", 2048): 32,
          ("RNN", 256): 20, ("RNN", 512): 52, ("RNN", 1024): 68, ("RNN", 2048): 76}
_MOVES = sorted(_MOVED)


@pytest.mark.parametrize("cell,B", _MOVES, ids=[f"{c}-B{b}" for c, b in _MOVES])
def test_large_batch_layout_moves_only_resident_plans_to_fewer_waves(cell, B):
    """Over every width, a plan moves to the large-batch layout only from a
    cluster-route plan that keeps W resident and takes more than one wave,
    to fewer waves at the same cluster size, more rows a cluster and one h
    row block, never streaming W; the others keep the cluster route's
    plan. The moves are counted."""
    moved = 0
    for H in _GRID_H:
        plan = fwd_plan(cell, 32, B, H, 2, "bfloat16", torch.bfloat16)
        base = _cluster_plan(cell, B, H, 2, 2, SLOTS)
        if plan is None or not plan["wide"]:
            assert plan == base, (H, plan, base)
            continue
        moved += 1
        assert base["resident"] and fwd_waves(base, 2) > 1, (H, base)
        assert fwd_waves(plan, 2) < fwd_waves(base, 2), (H, plan, base)
        assert (plan["nc"], plan["hc"], plan["kc"], plan["wstages"]) == \
            (base["nc"], base["hc"], base["kc"], 0), (H, plan, base)
        assert plan["resident"] and plan["blocks"] == 1 and plan["rows"] > base["rows"]
        assert -(-plan["rows"] // 16) * (plan["hc"] // 8) <= _UNITS_WIDE
    assert moved == _MOVED[cell, B]


# The regions at the widths the card tests take: (cell, H, B) -> (CTAs,
# columns a CTA, rows, regions, xld, smem). GRU H=256: W [256][104] bf16
# 53,248 B, 8 regions [160][32] 81,920, the bias [3][32] f32 384, 8 k32
# steps' offsets 128, the warps' slots of xp 8 x 6 x 16 rows of 24 bf16
# 36,864 and of the mask 3,072, the exchange's mbarrier 16: 175,632.
# H=264: 7 CTAs of 40 columns stop at 280 < 288, so a region of zeros is
# the 8th.
_REGIONS = {("GRU", 256, 1024): (8, 32, 160, 8, 32, 175632),
            ("LSTM", 256, 1024): (8, 32, 160, 8, 32, 216720),
            ("RNN", 256, 1024): (8, 32, 160, 8, 32, 118032),
            ("GRU", 264, 512): (7, 40, 80, 8, 40, 170112),
            ("RNN", 376, 512): (8, 48, 80, 8, 48, 120208),
            ("RNN", 520, 256): (8, 72, 48, 8, 72, 166976)}


@pytest.mark.parametrize("cell,H,B", sorted(_REGIONS), ids=[f"{c}-H{h}-B{b}"
                                                            for c, h, b in sorted(_REGIONS)])
def test_large_batch_regions_and_their_shared_memory(cell, H, B):
    """A large-batch plan holds one region a CTA (and one of zeros where the
    CTAs' columns stop short of H rounded up to 32), each row hc elements
    with no pad, and its shared memory is the kernel's layout: W resident
    with its pad, the regions, the bias, an int4 of offsets a k32 step, the
    warps' slots of their units' xp (rows of an odd number of 16-byte
    words) and mask, and the exchange's mbarrier, each rounded up to 16
    bytes."""
    plan = fwd_plan(cell, 32, B, H, 2, "bfloat16", torch.bfloat16)
    assert plan["wide"] and plan["blocks"] == 1 and plan["resident"]
    assert (plan["nc"], plan["hc"], plan["rows"], plan["regions"], plan["xld"],
            plan["smem"]) == _REGIONS[cell, H, B]
    G = {"GRU": 3, "LSTM": 4, "RNN": 1}[cell]
    kp, hc, R, nreg = _up(H, 32), plan["hc"], plan["rows"], plan["regions"]
    wld = G * hc + (16 if (G * hc // 8) % 2 else 8)
    assert -(-R // 16) * (hc // 8) <= _UNITS_WIDE
    assert nreg == _fwd_regions(H, hc) == -(-H // hc) + (-(-H // hc) * hc < kp)
    xrow = G * 8 + (0 if G % 2 else 8)
    by_hand = (_up(kp * wld * 2, 16) + _up(nreg * R * hc * 2, 16) + _up(G * hc * 4, 16)
               + kp // 32 * 16 + _up(8 * 6 * 16 * xrow * 2, 16) + _up(8 * 6 * 16 * 4, 16)
               + 16)
    assert plan["smem"] == by_hand <= _SMEM_LIMIT


def test_only_large_batch_plans_carry_regions():
    """The region fields belong to the large-batch plans alone: every other
    plan keeps the parent's keys (so the digest above covers all of it)."""
    keys = ("regions", "xld")
    for cell in _CELLS:
        for B in (64, 256, 1024):
            for H in (256, 384, 1024):
                for cdt in ("bfloat16", "float32"):
                    plan = fwd_plan(cell, 32, B, H, 2, cdt, torch.bfloat16)
                    assert all((k in plan) == plan["wide"] for k in keys), (cell, B, H)


def test_phase_words_size_the_phases_buffer():
    """FWD_PHASE_NAMES are the instrumented kernel's phases in its order,
    and FWD_PHASE_WORDS its words a CTA (the phases, the loop's cycles and
    its nanoseconds), so a buffer of D x nc x clusters x FWD_PHASE_WORDS
    int64 holds every CTA's."""
    src = (Path(__file__).resolve().parent.parent / "twotowermlretrieval_tpu_torch" / "csrc"
           / "rnn_fwd.cu").read_text()
    enum = re.search(r"enum Phase \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in enum.split(",")]
    assert names[-1] == "kPhases" and len(names) - 1 == len(FWD_PHASE_NAMES)
    assert [n[1:].lower() for n in names[:-1]] == \
        ["inputs", "product", "peers", "gate", "push", "barrier"]
    assert FWD_PHASE_NAMES == ("inputs", "product", "peers' reads", "gate math", "push",
                               "barrier")
    assert re.search(r"PHASE_WORDS = kPhases \+ 2;", src)
    assert FWD_PHASE_WORDS == len(FWD_PHASE_NAMES) + 2
