"""The recurrent backward's large-batch layout: its plans and the order of
its sums.

``ops/rnn_scan.py`` ``bwd_plan`` keeps its cluster route (at most 32 rows a
cluster) except at bf16 and B >= 256 where that route keeps W resident,
exchanges the dhp row block whole and takes more than one wave, and the
large-batch layout (W resident beside one row block, nothing staged, rows
a multiple of 32; H and each CTA's columns multiples of 16) takes fewer.
These tests hold the plans on an H100 SXM's cluster slots (pure functions
of the shape, no card) and, on the CPU, the order in which the kernel sums
db. The kernel itself is held on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import hashlib

import numpy as np
import pytest
import torch

from twotowermlretrieval_tpu_torch.ops import rnn_scan
from twotowermlretrieval_tpu_torch.ops.rnn_scan import (
    _GATES,
    _SMEM_LIMIT,
    _UNITS_MAX,
    _bwd_smem_bytes,
    _units,
    _up,
    bwd_plan,
    bwd_waves,
)

_CELLS = ("GRU", "LSTM", "RNN")

# The plans the change keeps, field for field the parent's: every plan of
# bwd_plan(cell, 32, B, H, 2, cdt, hist) over the grid below that is not a
# large-batch layout (every f32 plan, every plan below B=256, and at bf16
# and B >= 256 those whose cluster route streams W, exchanges the row block
# in chunks, already took one wave, or as few as the large-batch layout),
# digested in the grid's order with the parent commit's bwd_plan (the port
# before the large-batch layout). 590 of the grid's 23,040 plans move.
_GRID_H = range(8, 2049, 8)
_GRID_B = (1, 16, 64, 128, 255, 256, 512, 1000, 1024, 2048)
_DTYPES = (("bfloat16", torch.bfloat16), ("bfloat16", torch.float32), ("float32", torch.float32))
_KEYS = ("H", "nc", "hc", "rows", "clusters", "kc", "resident", "stages", "blocks", "xc", "nsplit",
         "wstages", "kw", "smem", "slots")
_KEPT_DIGEST = "318d69c0ee70c86cfd367ae223933117a0e820c976c727e6fcb3b2253a4ce6c9"
_KEPT_COUNT = 22450
_MOVED_COUNT = 590


def _cluster_route(monkeypatch, *args):
    """bwd_plan's cluster route alone: the plan before the large-batch
    layout."""
    with monkeypatch.context() as m:
        m.setattr(rnn_scan, "_bwd_wide_plan", lambda *a, **k: None)
        return bwd_plan(*args)


def test_plans_off_the_large_batch_route_are_the_parents():
    """Every plan that is not a large-batch layout is the parent's, field
    for field, and says so (``wide`` False); the large-batch layout appears
    only at bf16 and B >= 256."""
    h = hashlib.sha256()
    kept = moved = 0
    for cell in _CELLS:
        for cdt, hist in _DTYPES:
            for H in _GRID_H:
                for B in _GRID_B:
                    plan = bwd_plan(cell, 32, B, H, 2, cdt, hist)
                    if plan is not None and plan["wide"]:
                        assert cdt == "bfloat16" and B >= 256, (cell, cdt, H, B)
                        moved += 1
                        continue
                    assert plan is None or plan["wide"] is False
                    key = f"{cell} {cdt} {hist} {H} {B}"
                    h.update(repr((key, None if plan is None else [plan[k] for k in _KEYS]))
                             .encode())
                    kept += 1
    assert (h.hexdigest(), kept, moved) == (_KEPT_DIGEST, _KEPT_COUNT, _MOVED_COUNT)


_LARGE = [(c, H, hist) for c in _CELLS for H in (64, 128, 256, 384)
          for hist in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("cell,H,hist", _LARGE,
                         ids=[f"{c}-H{h}-{str(d)[6:]}" for c, h, d in _LARGE])
def test_large_batch_plans_take_fewer_waves_in_whole_partials(monkeypatch, cell, H, hist):
    """At every large batch, a large-batch plan replaces only a cluster-route
    plan that keeps W resident, exchanges the row block whole and takes more
    than one wave, and takes fewer waves; H and its CTAs' columns are
    multiples of 16; its rows are a multiple of 32 (of the route's db rows,
    16 or 32) that the CTA's units hold; its shared
    memory is its layout's by the chain_smem mirror, within the limit; its
    sums keep the route's order (db_rows its rows, khalf where the route's
    product split k between two warps)."""
    for B in (256, 384, 512, 1000, 1024, 2048):
        plan = bwd_plan(cell, 32, B, H, 2, "bfloat16", hist)
        base = _cluster_route(monkeypatch, cell, 32, B, H, 2, "bfloat16", hist)
        if not plan["wide"]:
            assert plan == base, (B, plan, base)
            continue
        kp = _up(_GATES[cell] * plan["H"], 16)
        assert base["resident"] and base["xc"] >= kp and bwd_waves(base, 2) > 1, (B, base)
        assert bwd_waves(plan, 2) < bwd_waves(base, 2), (B, plan, base)
        assert plan["H"] % 16 == 0 and plan["hc"] % 16 == 0  # k16 steps within one region
        assert plan["rows"] % 32 == 0 and plan["rows"] % plan["db_rows"] == 0
        assert plan["rows"] > base["rows"] and plan["db_rows"] == base["rows"] in (16, 32)
        assert _units(plan["rows"], plan["hc"]) <= _UNITS_MAX
        assert (plan["resident"], plan["stages"], plan["blocks"], plan["xc"], plan["wstages"]) == \
            (True, 0, 1, kp, 0)
        assert plan["smem"] == _bwd_smem_bytes(cell, plan["H"], 2, hist.itemsize, plan["rows"],
                                               plan["hc"], plan["kc"], 0, 1) <= _SMEM_LIMIT
        halves = 2 * _units(base["rows"], base["hc"]) <= 8
        assert plan["khalf"] == ((kp // 16 + 1) // 2 * 16 if halves else 0)
        assert {k: plan[k] for k in ("H", "kc", "nsplit")} == \
            {k: base[k] for k in ("H", "kc", "nsplit")}


def test_in_batch_training_shapes_take_the_expected_waves():
    """GRU H=256 (the reference towers): B=1024 (in-batch training) takes 96
    rows a cluster, 11 clusters of 8 a direction, two waves (five before);
    B=512 (one rank of two) 96 rows, one wave (three before); B=256 (one
    rank of four) 64 rows, one wave (two before); with a bf16 or an f32
    history, at T=32 and T=128 alike."""
    for hist in (torch.bfloat16, torch.float32):
        for T in (32, 128):
            got = {}
            for B in (1024, 512, 256):
                p = bwd_plan("GRU", T, B, 256, 2, "bfloat16", hist)
                got[B] = (p["wide"], p["nc"], p["hc"], p["rows"], p["clusters"], p["db_rows"],
                          p["khalf"], bwd_waves(p, 2))
            assert got == {1024: (True, 8, 32, 96, 11, 32, 0, 2),
                           512: (True, 8, 32, 96, 6, 32, 0, 1),
                           256: (True, 8, 32, 64, 4, 32, 0, 1)}
    assert bwd_plan("GRU", 32, 1024, 256, 2, "bfloat16", torch.bfloat16)["smem"] == 222496
    # f32 compute and the small batches keep the cluster route
    for B in (64, 128, 255, 1024):
        assert not bwd_plan("GRU", 32, B, 256, 2, "float32", torch.float32)["wide"]
    assert not bwd_plan("GRU", 32, 255, 256, 2, "bfloat16", torch.bfloat16)["wide"]


def _kernel_db(dhp: torch.Tensor, rows: int, db_rows: int) -> torch.Tensor:
    """db [G*H] summed in the kernel's order from f32 dhp [T, B, G*H] (T in
    the direction's processing order): each (row, column) over the steps
    in turn (the chain's db partial, in shared memory or in registers);
    each cluster of ``rows`` rows writes a partial per ``db_rows`` of them,
    each summed over its rows in order, zero past the batch; the last
    launch adds the partials in order (rnn_bwd_reduce_kernel)."""
    T, B, GH = dhp.shape
    acc = torch.zeros((_up(B, rows), GH), dtype=torch.float32)
    for t in range(T):
        acc[:B] = acc[:B] + dhp[t]
    parts = []
    for r0 in range(0, _up(B, rows), rows):
        for g0 in range(r0, r0 + rows, db_rows):
            if g0 >= B:
                continue
            s = torch.zeros(GH, dtype=torch.float32)
            for r in range(g0, g0 + db_rows):
                s = s + acc[r]
            parts.append(s)
    db = torch.zeros(GH, dtype=torch.float32)
    for s in parts:
        db = db + s
    return db


@pytest.mark.parametrize("B,db_rows", [(256, 32), (1000, 32), (1000, 16)])
def test_db_partials_grouped_by_the_route_rows_keep_the_sums(B, db_rows):
    """The large-batch layout writes one db partial per db_rows rows of its
    larger clusters (ws_b [D, ceil(B/db_rows), G*H]), so the fixed-order sum
    adds the same terms in the same order as the cluster route's partials
    of db_rows-row clusters: db keeps its bits at every large-batch row
    count, a ragged last cluster included. One partial per larger cluster
    would change them. Both stay within f32 rounding of the plain
    version's sum (dW does not depend on the rows: one product over T*B)."""
    rng = np.random.default_rng(B + db_rows)
    dhp = torch.from_numpy(rng.standard_normal((6, B, 24)).astype(np.float32))
    want = _kernel_db(dhp, db_rows, db_rows)
    for rows in (64, 96, 128, 160):
        assert torch.equal(_kernel_db(dhp, rows, db_rows), want), rows
    assert not torch.equal(_kernel_db(dhp, 96, 96), want)
    plain = dhp.double().sum(dim=(0, 1))
    torch.testing.assert_close(want.double(), plain, rtol=0, atol=2e-4)
