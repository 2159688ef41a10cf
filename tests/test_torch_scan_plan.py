"""The layouts of the port's scan kernels, checked on the CPU.

``ops/topk.py`` ``scan_plan`` picks the layout ``csrc/segmax.cu`` and launch 1
of ``csrc/topk_stream.cu`` run with: tensor-core tiles fed by a ring of
cp.async stages (``csrc/doc_mma.cuh``), the query fragments of bf16 and
per-row int8 corpora resident in shared memory where that leaves two blocks a
SM, else, and always for f32 (three bf16 pieces a value), riding the ring
beside each stage's rows; ``s8_plan`` the layout of
``csrc/segmax_s8.cu`` (s8 tensor-core tiles on the same ring). Their
shared-memory sizes mirror the .cu files region by region; these tests hold
them for every batch size and the widths the wrappers take, and show that the
wrappers refuse what the kernels do not take before any launch (on meta
tensors: no card, no build).
"""

import pytest
import torch

from twotowermlretrieval_tpu_torch.ops import _build
from twotowermlretrieval_tpu_torch.ops import topk as T

LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
SM = 233_472  # bytes a SM holds for its blocks, 1,024 of them reserved a block
ELEM = {torch.bfloat16: 2, torch.float32: 4, torch.int8: 1}


def _expected(B, H, storage, k):
    """The layout, recomputed region by region from the .cu files."""
    elem = ELEM[storage]
    if (H * elem) % 16 or H > 1 << 16:
        return None
    lists = 0 if k is None else B * (2 * k + 128 + 1) * 8 + -(-4 * B // 16) * 16
    most = 4 if k is None else 3  # the kernels' launch bounds
    nt = -(-B // 8)
    chunks = -(-H * elem // 128)  # 128-byte stages of each row
    extra = 4 * nt * 8 * 4 if k is None else lists  # segmax: the 4 warps' column maxima
    # a stage's query fragments: a uint2 a (k16 step, piece, n tile, lane) of
    # its k16 steps (2 f32, 4 bf16, 8 int8) and bf16 pieces (3 f32, else 1)
    frag = (128 // elem // 16) * (3 if storage == torch.float32 else 1) * nt * 32 * 8

    def per_sm(smem):
        return min(most, SM // (smem + 1024))

    def layout(stage, resident):
        sizes = {s: s * stage + resident + extra for s in (4, 3, 2)}
        return {s: sizes[s] for s in (4, 3, 2) if sizes[s] <= LIMIT}

    # riding the ring (a stage's rows, then its fragments): the most blocks
    # a SM, then the deepest ring
    ring = layout(128 * 128 + frag, 0)
    stages = max(ring, key=lambda s: (per_sm(ring[s]), s))
    want = {"route": "mma", "nt": nt, "chunks": chunks, "stages": stages, "smem": ring[stages],
            "k_tail": chunks * 128 // elem - H, "blocks_per_sm": per_sm(ring[stages]),
            "query_frags": "ring", "stage_bytes": 128 * 128 + frag,
            "query_frag_bytes": chunks * frag}
    if storage != torch.float32:
        # resident (the most stages that keep two blocks a SM, else the most
        # that fit) where that keeps two blocks a SM or as many as the ring
        res = layout(128 * 128, chunks * frag)
        if res:
            s = ([s for s in res if per_sm(res[s]) >= 2] or list(res))[0]
            if per_sm(res[s]) >= min(2, want["blocks_per_sm"]):
                want = {"route": "mma", "nt": nt, "chunks": chunks, "stages": s, "smem": res[s],
                        "k_tail": chunks * 128 // elem - H, "blocks_per_sm": per_sm(res[s]),
                        "query_frags": "shared memory"}
    return want


@pytest.mark.parametrize("H", [8, 16, 24, 40, 256, 1024])
@pytest.mark.parametrize("storage", [torch.bfloat16, torch.int8, torch.float32],
                         ids=["bf16", "int8", "f32"])
def test_scan_plan_every_batch_and_width(storage, H):
    """Every B in 1..32 and k (segmax, and the running top-k at k 1, 50,
    128): a layout exactly where the kernels take the shape, its shared
    memory region by region, its route (bf16 and int8 query fragments
    resident where that keeps two blocks a SM, or as many as the ring; f32's
    and the rest riding the ring), the most stages that keep two blocks a SM
    (resident) or the most blocks a SM, then the deepest ring (riding the
    ring), n8 query tiles covering B, and the zero-padded k-tail inside the
    last stage."""
    for B in range(1, 33):
        for k in (None, 1, 50, 128):
            plan, want = T.scan_plan(B, H, storage, k), _expected(B, H, storage, k)
            assert (plan is None) == (want is None), (B, k)
            if plan is None:
                continue
            assert plan == want, (B, k)
            assert plan["smem"] <= LIMIT and plan["blocks_per_sm"] >= 1
            assert 0 <= plan["k_tail"] < 128 // ELEM[storage]
            assert plan["nt"] * 8 >= B > plan["nt"] * 8 - 8
            assert 2 <= plan["stages"] <= 4


def _expected_s8(B, H):
    """segmax_s8.cu's layout, recomputed region by region (s8_smem): the
    ring, a uint2 of query fragment a (k32 step, n8 tile, lane), 4 k32 steps
    a 128-byte stage, and the 4 warps' int32 column maxima of two tiles; the
    most blocks a SM (at most 4, the launch bounds), then the deepest ring
    they leave room for."""
    nt = -(-B // 8)
    chunks = -(-H // 128)
    fixed = chunks * 4 * nt * 32 * 8 + 2 * 4 * nt * 8 * 4
    best = None
    for stages in range(2, 9):
        smem = stages * 128 * 128 + fixed
        if smem > LIMIT:
            break
        per_sm = min(4, SM // (smem + 1024))
        flight = per_sm * (stages - 1) * 128 * 128
        if best is None or per_sm >= best["blocks_per_sm"]:
            best = {"route": "mma-s8", "nt": nt, "chunks": chunks, "stages": stages,
                    "k_tail": chunks * 128 - H, "smem": smem, "blocks_per_sm": per_sm,
                    "in_flight": flight}
    return best


@pytest.mark.parametrize("H", [16, 48, 256, 1024, 1056, 2048, 4096])
def test_s8_plan_every_batch_and_width(H):
    """Every B in 1..32: a layout at every width up to 4096 (the widest
    tower width the port trains, with margin), its shared memory region by
    region, n8 query tiles covering B, the k-tail inside the last stage, and
    the widest width it lays out at B (s8_max_h) just past H's."""
    for B in range(1, 33):
        plan, want = T.s8_plan(B, H), _expected_s8(B, H)
        assert plan is not None and want is not None, B
        for key, value in want.items():
            assert plan[key] == value, (B, key)
        assert plan["smem"] <= LIMIT and plan["blocks_per_sm"] >= 1
        assert 2 <= plan["stages"] <= 8 and 0 <= plan["k_tail"] < 128
        assert plan["nt"] * 8 >= B > plan["nt"] * 8 - 8
        widest = T.s8_max_h(B)
        assert widest >= 4096 and widest % 16 == 0
        assert T.s8_plan(B, widest) is not None and T.s8_plan(B, widest + 16) is None
        assert _expected_s8(B, widest + 16) is None
    assert T.s8_plan(16, H + 8) is None  # not a multiple of 16
    assert T.s8_plan(33, H) is None and T.s8_plan(0, H) is None


def test_scan_plan_at_the_served_shape():
    """H=256, B=16: the layouts the main path launches, the parent's: the
    query fragments stay resident with the most stages that keep two blocks
    a SM. On an H100 (``tools/bench_f32_scans.py --storage bf16 / int8``,
    four runs a side, PERF.md section 6) the most blocks a SM instead left
    bf16 segmax at B=1 and 16 no faster and int8 segmax at B=1 slower, so
    the served plans stay."""
    seg = T.scan_plan(16, 256, torch.bfloat16)
    assert (seg["route"], seg["stages"], seg["nt"], seg["k_tail"]) == ("mma", 4, 2, 0)
    assert seg["query_frags"] == "shared memory"
    assert seg["smem"] == 4 * 16384 + 4 * 4 * 2 * 256 + 4 * 2 * 8 * 4
    assert seg["blocks_per_sm"] == 3
    top = T.scan_plan(16, 256, torch.bfloat16, 50)
    assert top["smem"] == 4 * 16384 + 8192 + 16 * 229 * 8 + 64 and top["blocks_per_sm"] == 2
    assert T.scan_plan(16, 256, torch.int8)["smem"] == seg["smem"]  # 2 stages of 128 columns
    f32 = T.scan_plan(16, 256, torch.float32)
    assert (f32["route"], f32["stages"], f32["nt"], f32["chunks"]) == ("mma", 2, 2, 8)
    assert f32["smem"] == 2 * (16384 + 2 * 3 * 2 * 256) + 4 * 2 * 8 * 4  # no resident fragments
    assert f32["blocks_per_sm"] == 4 and f32["query_frag_bytes"] == 8 * 2 * 3 * 2 * 256
    # 32 rows at k=50 give up stages to keep two blocks a SM; at k=128 no
    # layout keeps two, so they keep four stages, resident (the ring keeps
    # no more blocks)
    assert T.scan_plan(32, 256, torch.bfloat16, 50)["stages"] == 2
    plan = T.scan_plan(32, 256, torch.bfloat16, 128)
    assert (plan["stages"], plan["blocks_per_sm"], plan["query_frags"]) == (4, 1, "shared memory")


def test_scan_wrappers_refuse_before_any_launch(monkeypatch):
    """What the kernels do not take raises a ValueError before a build or a
    launch: too many query rows, rows short of 16 bytes' multiple, a corpus
    not in 128-row segments, k beyond 128, an s8 segment width the kernel
    does not take, and widths past the widest each scan takes (named)."""
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load", no_build)
    meta = {"device": "meta"}

    def z(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, **meta)

    def s8(B, H, npad=256, seg=128):
        return lambda: T.segmax_s8(z(B, H, dtype=torch.int8), z(npad, H, dtype=torch.int8), seg)

    # the widest widths take 32 query rows a launch; 16 bytes of columns
    # past them take none
    wide_bf16 = T.scan_max_h(torch.bfloat16) + 8
    wide_f32 = T.scan_max_h(torch.float32) + 4
    wide_i8 = T.scan_max_h(torch.int8) + 16
    wide_k = T.scan_max_h(torch.bfloat16, 128) + 8
    wide_k8 = T.scan_max_h(torch.int8, 50) + 16
    before = (T.segmax.launches, T.segmax_int8.launches, T.topk_stream.launches,
              T.topk_stream_int8.launches, T.segmax_s8.launches)
    cases = [
        (lambda: T.segmax(z(33, 64), z(256, 64), 256), "query rows"),
        (lambda: T.segmax(z(4, 12), z(256, 12), 256), "16-byte"),
        (lambda: T.segmax(z(4, 64), z(200, 64), 200), "Npad"),
        (lambda: T.segmax(z(32, wide_bf16), z(256, wide_bf16), 256),
         f"takes B=32 H={wide_bf16}.*up to {wide_bf16 - 8}"),
        (lambda: T.segmax(z(1, wide_f32, dtype=torch.float32),
                          z(256, wide_f32, dtype=torch.float32), 256),
         f"takes B=1 H={wide_f32}.*up to {wide_f32 - 4}"),
        (lambda: T.segmax_int8(z(8, wide_i8), z(256, wide_i8, dtype=torch.int8),
                               z(256, dtype=torch.float32), 256), f"up to {wide_i8 - 16}"),
        (lambda: T.segmax_int8(z(4, 40), z(256, 40, dtype=torch.int8),
                               z(256, dtype=torch.float32), 256), "16-byte"),
        (lambda: T.segmax_int8(z(33, 64), z(256, 64, dtype=torch.int8),
                               z(256, dtype=torch.float32), 256), "query rows"),
        (lambda: T.topk_stream(z(4, 64), z(256, 64), 129, 256), "k in"),
        (lambda: T.topk_stream(z(32, wide_k), z(256, wide_k), 128, 256),
         f"k=128: it takes H up to {wide_k - 8}"),
        (lambda: T.topk_stream_int8(z(4, wide_k8), z(256, wide_k8, dtype=torch.int8),
                                    z(256, dtype=torch.float32), 50, 256), "topk_stream_int8"),
        (lambda: T.topk_stream(z(4, 64), z(200, 64), 10, 200), "Npad"),
        (lambda: T.topk_stream_int8(z(33, 64), z(256, 64, dtype=torch.int8),
                                    z(256, dtype=torch.float32), 10, 256), "query rows"),
        (s8(33, 64), "query rows"),
        (s8(4, 40), "multiple of 16"),
        (s8(4, 64, npad=256, seg=16), "seg in"),
        (s8(4, 64, npad=192, seg=64), "Npad"),
        (s8(32, T.s8_max_h(32) + 16), f"shared memory.*up to {T.s8_max_h(32)}"),
        (s8(8, T.s8_max_h(8) + 128), f"up to {T.s8_max_h(8)} at B=8"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call()
    after = (T.segmax.launches, T.segmax_int8.launches, T.topk_stream.launches,
             T.topk_stream_int8.launches, T.segmax_s8.launches)
    assert after == before
    # a shape the kernels take gets past its plan, to the device check; so
    # do 32 rows at the widest tower widths and at the widest width a launch
    # takes
    with pytest.raises(ValueError, match="cpu or cuda"):
        T.segmax(z(16, 256), z(1024, 256), 1000)
    for B, H, dt, k in ((32, 3360, torch.bfloat16, 50), (32, 3200, torch.float32, 50),
                        (32, wide_bf16 - 8, torch.bfloat16, None),
                        (32, wide_f32 - 4, torch.float32, None),
                        (32, wide_k - 8, torch.bfloat16, 128)):
        if k is None:
            call = lambda: T.segmax(z(B, H, dtype=dt), z(256, H, dtype=dt), 256)  # noqa: E731
        else:
            call = lambda: T.topk_stream(z(B, H, dtype=dt), z(256, H, dtype=dt), k, 256)  # noqa: E731
        with pytest.raises(ValueError, match="cpu or cuda"):
            call()
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="cpu or cuda"):
            T.segmax(z(32, 3360 if dt == torch.bfloat16 else 3200, dtype=dt),
                     z(256, 3360 if dt == torch.bfloat16 else 3200, dtype=dt), 256)
    with pytest.raises(ValueError, match="cpu or cuda"):
        T.segmax_int8(z(32, 3360), z(256, 3360, dtype=torch.int8),
                      z(256, dtype=torch.float32), 256)
    for B, H in ((16, 256), (32, 1056), (32, 4096)):
        with pytest.raises(ValueError, match="cpu or cuda"):
            s8(B, H)()


@pytest.mark.parametrize("B", [1, 7, 8, 16, 32])
@pytest.mark.parametrize("tiles", [1, 576, 1023, 1024, 8192, 20000])
def test_topk_stream_grid_covers_every_tile(B, tiles):
    """Launch 1's blocks cover every tile once; a pilot over every 32nd
    tile runs from 1,024 tiles and 8 query rows; the workspace holds the
    larger launch's blocks."""
    plan = T.scan_plan(B, 256, torch.bfloat16, 50)
    g = T.topk_stream_grid(plan, B, tiles, sms=132)
    most = plan["blocks_per_sm"] * 132
    chunks = -(-tiles // g["per_chunk"])
    assert chunks <= most and (chunks - 1) * g["per_chunk"] < tiles <= chunks * g["per_chunk"]
    assert g["stride"] == (32 if tiles >= 1024 and B >= 8 else 1)
    sample = -(-tiles // g["stride"])
    pilot = -(-sample // g["pilot_per_chunk"])
    assert pilot <= most and (pilot - 1) * g["pilot_per_chunk"] < sample
    assert g["grid"] == max(chunks, pilot)


_TOWER_WIDTHS = {torch.bfloat16: range(8, 3361, 8), torch.float32: range(4, 3201, 4),
                 torch.int8: range(16, 3361, 16)}


@pytest.mark.parametrize("storage", [torch.bfloat16, torch.int8, torch.float32],
                         ids=["bf16", "int8", "f32"])
def test_query_blocks_every_batch_at_every_tower_width(storage):
    """Every B in 1..32 at every width a tower of the port emits (bf16 and
    per-row int8 up to the RNN's 3360, f32 up to 3200), for segmax and the
    running top-k at k 50 and 128: one launch, of all B rows, whose plan is
    the one scan_plan gives (the query fragments ride the ring wherever
    they do not stay resident, so no batch is cut into blocks of rows)."""
    for H in _TOWER_WIDTHS[storage]:
        for k in (None, 50, 128):
            for B in range(1, 33):
                plan = T.scan_plan(B, H, storage, k)
                assert plan is not None, (H, k, B)
                assert T.query_blocks("scan", B, H, storage, k) == [(0, B, plan)], (H, k, B)


def test_query_blocks_at_the_widest_towers():
    """32 queries at the RNN tower's widths run in one launch at bf16 and
    per-row int8 H=3360 and f32 H=3200 (segmax and the running top-k at
    k=50 and 128: the query fragments ride the ring there, so the block's
    shared memory does not grow with H), as at the served width; one query
    row at H=3360 keeps its fragments resident (the route the wide batch is
    held against, bit for bit, on the card); past scan_max_h no row fits."""
    for H, dt in ((3360, torch.bfloat16), (3360, torch.int8), (3200, torch.float32)):
        for k in (None, 50, 128):
            assert [b for _, b, _ in T.query_blocks("scan", 32, H, dt, k)] == [32], (H, dt, k)
            assert T.scan_plan(32, H, dt, k)["query_frags"] == "ring"
            if dt != torch.float32:
                assert T.scan_plan(1, H, dt, k)["query_frags"] == "shared memory"
    assert len(T.query_blocks("scan", 32, 256, torch.bfloat16, 50)) == 1
    # the widest widths stay at or above those of the routes they replaced:
    # f32's CUDA-core route (6,680 for segmax, 6,624 and 6,584 for the top-k
    # at k=50, 128) and the resident bf16 / int8 route (one query row:
    # 12,416, 12,352, 12,224 / 12,416, 12,288, 12,160)
    for dt, before in ((torch.float32, (6680, 6624, 6584)),
                       (torch.bfloat16, (12416, 12352, 12224)),
                       (torch.int8, (12416, 12288, 12160))):
        for k, old in zip((None, 50, 128), before):
            assert T.scan_max_h(dt, k) >= old, (dt, k)
    for dt in (torch.bfloat16, torch.float32, torch.int8):
        for k in (None, 50, 128):
            widest = T.scan_max_h(dt, k)
            step = 16 // ELEM[dt]
            assert T.scan_plan(32, widest, dt, k) is not None
            assert T.scan_plan(1, widest + step, dt, k) is None
            with pytest.raises(ValueError, match=f"up to {widest}"):
                T.query_blocks("scan", 1, widest + step, dt, k)


@pytest.mark.parametrize("k", [None, 1, 50, 128], ids=["segmax", "k1", "k50", "k128"])
@pytest.mark.parametrize("storage", [torch.bfloat16, torch.int8, torch.float32],
                         ids=["bf16", "int8", "f32"])
def test_ring_plans_do_not_grow_with_h(storage, k):
    """Where the query fragments ride the ring, a block's shared memory, its
    stages and its blocks a SM are the same at every width for a batch
    size (only the device workspace, a stage's fragments times the stages of
    a row, grows with H), and the widest width is the same for every batch;
    the resident route's shared memory grows with H."""
    step = 16 // ELEM[storage]
    for B in (1, 8, 9, 16, 17, 32):
        rings = [T.scan_plan(B, H, storage, k) for H in range(step, 8193, 37 * step)]
        rings = [p for p in rings if p["query_frags"] == "ring"]
        assert rings or storage != torch.float32
        for p in rings:
            assert (p["smem"], p["stages"], p["blocks_per_sm"], p["stage_bytes"]) == (
                rings[0]["smem"], rings[0]["stages"], rings[0]["blocks_per_sm"],
                rings[0]["stage_bytes"]), B
            assert p["query_frag_bytes"] == p["chunks"] * (p["stage_bytes"] - 128 * 128)
        assert T.scan_plan(B, T.scan_max_h(storage, k), storage, k)["query_frags"] == "ring"
    if storage != torch.float32:
        def resident(H):  # the resident route's two-stage layout
            return next(p for p in T.scan_layouts(1, H, storage, k)
                        if p["query_frags"] == "shared memory" and p["stages"] == 2)
        assert resident(1024)["smem"] > resident(64)["smem"]
