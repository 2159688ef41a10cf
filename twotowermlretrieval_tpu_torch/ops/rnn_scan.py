"""Recurrent time loop (GRU / LSTM / RNN), forward and backward: CUDA
kernels + plain versions.

:func:`rnn_layer_fwd` keeps the JAX package's signature (``ops/rnn_scan.py``
``rnn_layer_fwd``): per-direction ``xps`` [T, B, G*H] in original time
order, a [T, B] f32 mask, ``w_hh`` [D, H, G*H], ``b_hh`` [D, G*H]. It
returns ``(outs, c_hist, h_final)``: per-direction state histories
[T, B, H] (f32, or the compute dtype under ``history_in_cdt``), the LSTM
cell histories (else ``()``), and ``h_final`` [D, B, H] f32.

On a CUDA tensor it launches ``csrc/rnn_fwd.cu``: one thread-block cluster
of up to 8 CTAs (16 for wide layers) per (direction, block of batch rows) walks the whole time
loop, each CTA keeping its hidden columns' slice of W_hh in shared memory
(for wide layers, streamed through a ring of stages that bulk copies keep
full across steps, from a copy of W the wrapper's scratch holds packed
chunk by chunk), the step's product on the tensor cores (at f32 compute
as split products: three bf16 pieces a value, six products), and each
step's h exchanged through distributed shared memory with one
cluster barrier a step (two where the CTA keeps one h row block to make
room for the ring). At bf16 and large batches, where W stays resident,
it takes more rows a CTA in fewer waves, each CTA's h sent to its peers
by the copy engine. :func:`fwd_plan` picks the layout. On a CPU tensor it runs :func:`rnn_layer_fwd_reference`, the plain
PyTorch version of the same arithmetic. Both read xp rounded to the
compute dtype, as the TPU kernel does (its caller casts xp before the
call), and round h to the compute dtype before every step's product.

The backward keeps the JAX signatures too. :func:`rnn_layer_bwd` takes the
forward's inputs, its saved ``outs`` / ``c_hist``, the cotangents
``douts`` (read in the history's dtype, as the custom VJP delivers them)
and ``d_hfinal``, and returns ``(dxps, dw_hh, db_hh)`` in f32, the weight
gradients computed inside ``csrc/rnn_bwd.cu``. The same kernel in split
mode emits dxp and, for GRU, the recurrent pre-activation cotangent dhp
instead (:func:`rnn_layer_bwd_split`, :func:`_bwd_hoisted_call`); the
weight gradient is then one product outside
(:func:`_hoisted_weight_grad`), as in the JAX package. On CPU tensors all
of them run :func:`_bwd_reference`'s plain loop.

The backward runs in three parts (see the note in ``csrc/rnn_bwd.cu``):
the gate recompute as one product before the time loop, the dh chain in
thread-block clusters that keep their rows of W in shared memory, and the
weight gradient as one product after it, each on the tensor cores (at
f32 compute as split products, the two GEMMs' operands split into their
bf16 pieces once a call). :func:`bwd_plan` picks the
layout; where a CTA's rows of W do not fit, the kernel streams them
through a ring of stages, as the forward does. At bf16 and large batches,
where W stays resident, it takes more rows a cluster in fewer waves,
summing in the order of the layout it stands in for.

Widths. The forward kernel takes H a multiple of 8 and the backward H a
multiple of 4; the wrappers zero-pad other widths (:func:`pad_layer`: a
padded unit with zero xp, weights, bias and state stays zero and feeds
nothing into the real units) and slice the results back. The model runs
each layer at :func:`kernel_width` (``models/rnn.py``: its weights are
padded, so the input projection yields the padded xp), so on its path
neither wrapper pads. Both kernels run in clusters of up to 8 CTAs, and of
up to 16 where 8 would hold more hidden columns than a CTA takes (the
forward also where 8 would stream W and 16 all fit on the card at once;
:func:`cluster_slots` reads from the card how many clusters of each size
it holds at once). The forward kernel takes every H up to 4032 (GRU), 3520
(LSTM) and 4096 (RNN) at bf16 compute, and up to 4064, 3520 and 4096 at
f32, streaming W where its columns do not fit; the backward every H up to
4096 (LSTM at bf16: 3328 with an f32 history, 3584 with a bf16 one),
exchanging its dhp row block in chunks where one whole block does not fit.
That covers every width where the JAX package's ``plan_fused`` keeps a
layer on its Pallas kernels. Beyond a limit, where the plan is None, a call
on card tensors raises a ValueError that names the limit, before any
launch: a wrapper launches its kernel or raises, and never runs the plain
loop on the card. (The JAX package runs its XLA scan where ``plan_fused``
finds no plan.)
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from twotowermlretrieval_tpu_torch.ops import _build
from twotowermlretrieval_tpu_torch.utils.dtypes import matmul_f32, torch_dtype

_GATES = {"GRU": 3, "LSTM": 4, "RNN": 1}
_CELL_CODE = {"RNN": 0, "GRU": 1, "LSTM": 2}

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int

_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
_SMS = 132  # streaming multiprocessors of an H100 SXM
# (16 x 8) output units of a chain product one CTA holds (4 per warp), at
# either compute dtype; a CTA of 8 rows (f32) holds units of 8 rows
_UNITS_MAX = 4 * 8
# The forward's large-batch layouts (bf16, W resident): 6 units a warp
# (8 spilled registers and ran slower on an H100), up to 256 rows
_UNITS_WIDE = 6 * 8
_WIDE_ROWS = tuple(range(16, 257, 16))
_WIDE_BATCH = 256  # the least batch they take (every smaller batch keeps its plan)
# The backward's large-batch layouts: rows a cluster, whole db partials of
# the 32 (or 16) rows the cluster route sums apart
_WIDE_BWD_ROWS = tuple(range(64, 257, 32))
# The forward at f32: rows x columns a CTA takes at most, a choice within
# the units it holds. The f32 h row block grows with the rows, and where W
# streams its room is the ring's: at RNN H=3072 B=16 T=32 on an H100
# (--layouts, PERF.md section 6) 16 rows a CTA, which the units allow,
# left W f32 stages of 16 rows and took 8.05-8.22 ms, 8 rows 4.15 with W
# in pieces in stages of 48.
_F32_ROWS_COLS = 8 * 256
# Clusters of nc one-CTA-per-SM blocks an H100 SXM (H100 80GB HBM3) holds at
# once, by cluster size: cudaOccupancyMaxActiveClusters of both recurrent
# kernels there, not 132 / nc (a cluster stays within one GPC). The plans'
# default; on a card the wrappers read the card's own (cluster_slots).
H100_SXM_CLUSTER_SLOTS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15,
                          9: 9, 10: 7, 11: 7, 12: 7, 13: 7, 14: 7, 15: 7, 16: 7}
_FWD_MULTIPLE = 8  # the forward kernel's H: whole (16 x 8) units, 16-byte pushes of bf16 h
_BWD_MULTIPLE = 4  # the backward kernel's H: its rows copied in 8-byte words
_GEMM_TILE = 128  # output tile of the two chain-free products
_RING_MAX = 8  # stages of a streamed W ring, at most


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _units(rows: int, hc: int) -> int:
    """The (16 x 8) output units of a CTA of ``rows`` rows and ``hc``
    columns (8 rows count as one unit's)."""
    return -(-rows // 16) * (hc // 8)


# the instrumented build of the forward (csrc/rnn_fwd.cu, RNN_FWD_PHASES):
# the time loop's phase times at bf16 with W resident, for
# tools/bench_rnn_stream.py --step-phases. "peers' reads": the wait for
# every peer to have read the one h row block; "push": the pushes (the
# large-batch layout: starting its bulk copies); "barrier": the cluster
# barrier that ends a step (the large-batch layout: the waits for the
# peers' copies)
FWD_PHASES = ("RNN_FWD_PHASES",)
FWD_PHASE_NAMES = ("inputs", "product", "peers' reads", "gate math", "push", "barrier")
FWD_PHASE_WORDS = len(FWD_PHASE_NAMES) + 2  # the phases' cycles, the loop's cycles and ns


def _lib(defines=()):
    lib = _build.load("rnn_fwd", defines)
    if not getattr(lib, "_ttr_bound", False):
        lib.rnn_fwd_launch.restype = _INT
        lib.rnn_fwd_launch.argtypes = [
            _INT, _INT, _INT, _INT,  # device, cell, cdt_bf16, hist_bf16
            _INT, _INT, _INT, _INT,  # T, B, H, D
            _INT, _INT, _INT, _INT, _INT, _INT, _INT,  # nc, rows, hc, kc, wstages, blocks, wsplit
            _INT,  # wide
            _VOIDP, _VOIDP, _VOIDP, _VOIDP,  # xp0, xp1, mask, w_hh
            _VOIDP, ctypes.c_longlong, _VOIDP,  # wpk, wpk_elems, b_hh
            _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,  # out0, out1, c0, c1, h_final
            _VOIDP, _VOIDP,  # phases, stream
        ]
        lib.rnn_fwd_error_string.restype = ctypes.c_char_p
        lib.rnn_fwd_error_string.argtypes = [_INT]
        lib.rnn_fwd_cluster_slots.restype = _INT
        # device, cell, cdt_bf16, hist_bf16, nc, out
        lib.rnn_fwd_cluster_slots.argtypes = [_INT] * 5 + [ctypes.POINTER(_INT)]
        lib._ttr_bound = True
    return lib


def _check_args(cell, xps, mask, w_hh, b_hh):
    if cell not in _GATES:
        raise ValueError(f"cell must be one of {list(_GATES)}, got {cell!r}")
    D = len(xps)
    if D not in (1, 2):
        raise ValueError(f"one or two directions expected, got {D}")
    T, B, GH = xps[0].shape
    H = GH // _GATES[cell]
    if GH != H * _GATES[cell] or any(x.shape != (T, B, GH) for x in xps):
        raise ValueError(f"xps must all be [T, B, {_GATES[cell]}*H]: {[tuple(x.shape) for x in xps]}")
    if tuple(mask.shape) != (T, B):
        raise ValueError(f"mask must be [T, B] = {(T, B)}, got {tuple(mask.shape)}")
    if tuple(w_hh.shape) != (D, H, GH) or tuple(b_hh.shape) != (D, GH):
        raise ValueError(
            f"w_hh must be {(D, H, GH)} and b_hh {(D, GH)}: "
            f"{tuple(w_hh.shape)}, {tuple(b_hh.shape)}"
        )
    return D, T, B, H, GH


def _fwd_wld(G: int, hc: int, cdt_bytes: int, wsplit: bool = False) -> int:
    """Elements of a row of the forward's W in shared memory: the CTA's G
    gate blocks of ``hc`` columns and the pad that keeps ldmatrix's eight
    16-byte rows on distinct banks (``fwd_smem``'s wld in csrc/rnn_fwd.cu;
    ``wsplit``: W in its bf16 pieces, laid out as bf16)."""
    wb = 2 if wsplit else cdt_bytes
    epw = 16 // wb
    return G * hc + (2 * epw if wb == 2 and (G * hc // 8) % 2 else epw)


def _fwd_smem_bytes(cell: str, H: int, cdt_bytes: int, rows: int, hc: int, kc: int,
                    wstages: int = 0, blocks: int = 2, wsplit: bool = False,
                    wide: bool = False) -> int:
    """Shared memory of one CTA of the forward kernel: the CTA's columns of
    round(W) (all ``kc`` >= H rows where resident; else a ring of
    ``wstages`` stages of ``kc`` rows each with a full and an empty
    barrier a stage, or, ``wstages`` 0, one buffer of ``kc`` rows; with
    ``wsplit``, f32 compute, as three bf16 planes),
    ``blocks`` rounded h row blocks (2, or 1 with a second cluster barrier
    a step) and the bias of its gate columns (``fwd_smem`` in
    csrc/rnn_fwd.cu, region by region). ``wide``: the large-batch layouts'
    h row block instead, as :func:`_fwd_regions` regions [rows][hc] (no
    pad: their words are swizzled), each k32 step's k8 offsets in them
    (int32 x 4), each warp's slots of its units' step xp (6 units of 16
    rows of G x 8, padded to an odd number of 16-byte words) and mask (f32),
    and the exchange's mbarrier. H is the kernel's width, a multiple of
    8."""
    G = _GATES[cell]
    kp = _up(H, 32)
    wld = _fwd_wld(G, hc, cdt_bytes, wsplit)
    wrow = wld * (3 * 2 if wsplit else cdt_bytes)
    hld = kp + 16 // cdt_bytes
    ring = wstages if kc < kp and wstages else 0
    w = _up(min(kc, kp) * wrow, 16) * max(ring, 1) + 16 * ring
    if wide:
        regions = _fwd_regions(H, hc)
        slots = 8 * 6 * 16  # warps x units x rows
        xrow = G * 8 + (0 if G % 2 else 8)
        return (w + _up(regions * rows * hc * cdt_bytes, 16) + _up(G * hc * 4, 16)
                + kp // 32 * 16 + _up(slots * xrow * cdt_bytes, 16) + _up(slots * 4, 16)
                + 16)
    return w + _up(blocks * rows * hld * cdt_bytes, 16) + _up(G * hc * 4, 16)


def _fwd_regions(H: int, hc: int) -> int:
    """The regions of the large-batch layouts' h row block: one a CTA's
    ``hc`` columns, and one of zeros where the CTAs' columns stop short of
    H rounded up to 32 (the product's k32 steps read them there)."""
    nc = -(-H // hc)
    return nc + (nc * hc < _up(H, 32))


def _fwd_packed_elems(cell: str, plan: dict, D: int, cdt_bytes: int) -> int:
    """Elements of the forward's packed W (``rnn_fwd_pack_w`` in
    csrc/rnn_fwd.cu: [D][nc][chunks][kc][wld]; ``wsplit``,
    ``rnn_fwd_pack_w_split``: [D][nc][chunks][3][kc][wld] bf16) where the
    plan streams W, else 0."""
    if plan["resident"]:
        return 0
    kc, wsplit = plan["kc"], plan.get("wsplit", False)
    return (D * plan["nc"] * -(-_up(plan["H"], 32) // kc) * (3 if wsplit else 1) * kc
            * _fwd_wld(_GATES[cell], plan["hc"], cdt_bytes, wsplit))


def fwd_waves(plan: dict, D: int) -> int:
    """How many times the card runs the whole time loop: the plan's
    clusters, both directions, over the clusters of its size the card
    holds at once."""
    return -(-D * plan["clusters"] // plan["slots"])


def _fwd_layout(cell: str, Hk: int, cb: int, R: int, hc: int):
    """The forward's layout at these rows and columns a CTA: (kc, wstages,
    blocks, smem, wsplit), W resident where it fits beside two h row
    blocks (kc = H rounded up to 32, no ring), else streamed through a ring
    of two stages of the most rows that fit (a multiple of 32 at bf16, 16
    at f32; as many more stages as the room holds, up to 8), with one h
    row block where that makes the stages wider and so the chunks a step
    fewer; None where no ring of two fits. At f32 compute W is held as its
    three bf16 pieces (``wsplit``: split once a call, not every step)
    wherever they keep the layout's kind (resident, or a ring of two
    stages), else as f32, and as f32 where the pieces' stages would hold
    16 rows and f32's 32 or more. On an H100 (the --layouts sweep, PERF.md
    section 6) the pieces ran 1.02-1.42x faster than f32 in each of the
    155 layouts that took both at the same stage rows, 1.25x faster in
    stages of 32 rows than f32 in stages of 48, 1.11x in stages of 48
    against 64, and 1.04-1.08x slower in stages of 16 against 32. f32 W
    also stays where it is resident and the pieces would stream, and at
    the widest layers, where two stages of 16 rows in pieces (6 bytes a
    value against 4) do not fit beside the f32 h row block."""
    kp = _up(Hk, 32)
    step = 32 if cb == 2 else 16
    forms = (True, False) if cb == 4 else (False,)
    for wsplit in forms:
        smem = _fwd_smem_bytes(cell, Hk, cb, R, hc, kp, wsplit=wsplit)
        if smem <= _SMEM_LIMIT:
            return kp, 0, 2, smem, wsplit
    rings = []
    for wsplit in forms:
        wrow = _fwd_wld(_GATES[cell], hc, cb, wsplit) * (6 if wsplit else cb)
        best = None
        for blocks in (2, 1):
            room = _SMEM_LIMIT - _fwd_smem_bytes(cell, Hk, cb, R, hc, 0, 0, blocks)
            kc = min(kp - step, (room // 2 - 16) // wrow // step * step)
            if kc >= step and (best is None or -(-kp // kc) < -(-kp // best[0])):
                stages = min(_RING_MAX, room // (kc * wrow + 16))
                best = (kc, stages, blocks,
                        _fwd_smem_bytes(cell, Hk, cb, R, hc, kc, stages, blocks, wsplit), wsplit)
        rings.append(best)
    if cb == 4 and rings[0] is not None and (rings[0][0] > 16 or rings[1][0] < 32):
        return rings[0]
    return rings[-1]


def _wide_plan(cell: str, B: int, Hk: int, D: int, slots):
    """The large-batch plan (bf16, W resident; :func:`fwd_plan`): over the
    cluster sizes and the rows a CTA of 6 units a warp holds (multiples of
    16 up to 256 and the batch) with W resident beside one h row block (as
    ``regions`` regions [rows][``xld``], one a CTA's columns, exchanged by
    bulk copies: csrc/rnn_fwd.cu) and the warps' slots of the step's xp,
    the fewest waves; then clusters of 8 before 16; then the fewest rows.
    None where W resident fits at no rows. Worked out once a shape
    (:func:`_planned`)."""
    return _planned(_wide_plan_of, cell, B, Hk, D, slots)


def _planned(fn, *args):
    """``fn(*args[:-1], slots)`` through its cache (``fn`` takes the
    slots as sorted items), as a fresh dict: the search runs in Python, and
    at every call it held the card idle before short launches (PERF.md
    section 6)."""
    *head, slots = args
    plan = fn(*head, tuple(sorted(slots.items())))
    return None if plan is None else dict(plan)


@functools.lru_cache(maxsize=4096)
def _wide_plan_of(cell: str, B: int, Hk: int, D: int, slot_items):
    slots = dict(slot_items)
    kp = _up(Hk, 32)
    best = None
    for nc, hc in _cluster_sizes(Hk, slots):
        for R in _WIDE_ROWS:
            if _units(R, hc) > _UNITS_WIDE or R > _up(B, 16):
                break
            smem = _fwd_smem_bytes(cell, Hk, 2, R, hc, kp, 0, 1, wide=True)
            if smem > _SMEM_LIMIT:
                break
            plan = {"H": Hk, "nc": nc, "hc": hc, "rows": R, "clusters": -(-B // R), "kc": kp,
                    "resident": True, "wstages": 0, "blocks": 1, "smem": smem,
                    "slots": slots[nc], "wsplit": False, "wide": True,
                    "regions": _fwd_regions(Hk, hc), "xld": hc}
            key = (fwd_waves(plan, D), nc, R)
            if best is None or key < best[0]:
                best = (key, plan)
    return None if best is None else best[1]


def _cluster_sizes(Hk: int, slots):
    """The cluster sizes a plan tries in turn, with each CTA's columns: at
    most 8 CTAs (the portable size), then at most 16 where 8 hold more
    columns than a CTA takes and the card holds clusters of that size."""
    out = []
    for most in (8, 16):
        nc = max(1, min(most, Hk // 16))
        hc = _up(-(-Hk // nc), 8)
        nc = -(-Hk // hc)  # no CTA without columns
        if (not out or nc > out[-1][0]) and slots.get(nc, 0) > 0:
            out.append((nc, hc))
    return out


def _cluster_plan(cell: str, B: int, Hk: int, D: int, cb: int, slots):
    """:func:`fwd_plan`'s cluster route (4 units a warp, every CTA keeping
    the whole h row block), or None; worked out once a shape."""
    return _planned(_cluster_plan_of, cell, B, Hk, D, cb, slots)


@functools.lru_cache(maxsize=4096)
def _cluster_plan_of(cell: str, B: int, Hk: int, D: int, cb: int, slot_items):
    slots = dict(slot_items)
    kp = _up(Hk, 32)
    cands = (16, 32, 64, 128) if cb == 2 else (8, 16, 32, 64)
    plans = []
    for nc, hc in _cluster_sizes(Hk, slots):
        held = [R for R in cands if _units(R, hc) <= _UNITS_MAX
                and (cb == 2 or R * hc <= _F32_ROWS_COLS)]
        if plans:  # where 8 stream W: 16 at the rows 8 took, all on the card at once
            R = plans[0]["rows"]
            if plans[0]["resident"] or R not in held or D * -(-B // R) > slots[nc]:
                continue
            held = [R]
        layouts = [(R, *lay) for R in held
                   for lay in [_fwd_layout(cell, Hk, cb, R, hc)] if lay is not None]
        if not layouts:
            continue
        least = cands[0] if B <= cands[0] else cands[1]
        big = [lay for lay in layouts if lay[0] >= least] or layouts[-1:]
        R, kc, stages, blocks, smem, wsplit = next(
            (lay for lay in big if D * -(-B // lay[0]) <= slots[nc]), big[-1])
        plans.append({"H": Hk, "nc": nc, "hc": hc, "rows": R, "clusters": -(-B // R), "kc": kc,
                      "resident": kc >= kp, "wstages": stages, "blocks": blocks, "smem": smem,
                      "slots": slots[nc], "wsplit": wsplit, "wide": False})
    return plans[-1] if plans else None


def fwd_plan(cell: str, T: int, B: int, H: int, D: int, compute_dtype="bfloat16",
             history_dtype=torch.float32, slots=H100_SXM_CLUSTER_SLOTS):
    """The forward kernel's layout for one call, or None when none fits
    shared memory. ``H``: the kernel's width, the layer's rounded up to 8
    (the wrapper zero-pads). ``nc`` CTAs per cluster (at most 8, the
    portable size; 16 where 8 hold more columns than fit, or would
    stream W while 16 all fit at once), each owning
    ``hc`` hidden columns;
    ``rows`` batch rows per cluster (``clusters`` of them per direction);
    ``kc`` rows of the CTA's columns of W a stage holds (``resident``:
    all of them, loaded once; else streamed every step through a ring of
    ``wstages`` stages that the copies keep full across steps, 0 where
    resident); ``wsplit``: at f32 compute, W held as its three bf16
    pieces (:func:`_fwd_layout`); ``blocks`` rounded h row blocks (2; 1 where a second
    cluster barrier a step frees room for a ring of at least 3 stages that
    two blocks do not leave); ``smem`` bytes per CTA. There is no staging
    depth for xp: a step's xp goes to registers, the next step's is
    prefetched to L2. ``rows`` is the
    smallest (at least 32 where the batch has them; 16 at bf16 or 8 at f32
    for smaller batches) whose clusters all fit on the card at once, else
    the largest: each further wave of clusters costs a whole time loop,
    while a step of four times the rows costs less than four steps.
    Where W streams, the ring takes two stages of the most rows that fit
    (:func:`_fwd_layout`): each chunk costs its warps about a microsecond
    beyond its bytes whatever the ring's depth, so fewer, larger chunks
    win. Where clusters of 8 would stream W or cannot hold the layer, and
    clusters of 16 at the same rows all fit on the card at once, the plan
    takes clusters of 16: each CTA then draws half the W a step, or holds
    it (GRU and LSTM H=512 at B <= 96, RNN H=1024). On an H100 SXM
    (``tools/bench_rnn_stream.py --layouts``, PERF.md section 6) that was
    0.28-0.32 ms against 0.39-0.41 in clusters of 8 at GRU H=512 B=64 T=32,
    0.46-0.48 against 0.68-0.77 at GRU H=1024 B=16, 0.67-0.70 against
    1.00-1.03 at B=64, 1.18-1.27 against 2.50-2.60 at LSTM H=1536 B=16;
    where 16 at those rows took two waves, clusters of 8 won (GRU H=512
    B=128 T=128: 1.31-1.34 ms, against 1.71-1.82 in 16 and 1.50 in 16 at
    twice the rows; GRU H=1024 B=1024 T=128: 18.5-18.6 against 22.8-23.1).
    Large batches (bf16, B >= 256): where that plan keeps W resident and
    takes more than one wave (a CTA of 4 units a warp holds at most 128
    rows at H=256), the large-batch layout (:func:`_wide_plan`: 6 units a
    warp, W resident beside the h row block as ``regions`` regions of
    ``xld`` columns, one a CTA's, exchanged by bulk copies, and the step's
    xp; ``wide``) takes over where it needs fewer waves. GRU H=256 B=1024 then takes 160 rows a cluster, 14
    clusters of 8 in one wave (two before). Where W streams (GRU H=1024
    B=1024: 32 rows, five waves) the plan stays the cluster route's: h
    carried beside W through L2 in three waves of 48 rows ran level with
    it, and 8 units a warp (64 rows) spilled registers and ran slower
    (PERF.md section 6).
    ``slots``: how many clusters of each size the card holds at once (the
    H100 SXM's by default, the card's own from the wrapper).
    ``history_dtype`` changes no layout. The kernel checks the plan and
    refuses one that does not fit."""
    del T, history_dtype  # the layout depends on neither
    Hk = _up(max(H, 1), 8)
    cb = torch_dtype(compute_dtype).itemsize
    plan = _cluster_plan(cell, B, Hk, D, cb, slots)
    if plan is None:
        return None
    if cb == 2 and B >= _WIDE_BATCH and plan["resident"] and fwd_waves(plan, D) > 1:
        wide = _wide_plan(cell, B, Hk, D, slots)
        if wide is not None and fwd_waves(wide, D) < fwd_waves(plan, D):
            return wide
    return plan


def kernel_width(H: int) -> int:
    """The width both recurrent kernels take as it is: H rounded up to 8.
    ``models/rnn.py`` runs every layer at it, so that neither pass pads
    or slices anything on the model's path."""
    return _up(max(H, 1), _FWD_MULTIPLE)


def pad_units(x: torch.Tensor, G: int, H: int, Hk: int) -> torch.Tensor:
    """[..., G*H] -> [..., G*Hk]: each of the G gate blocks zero-padded from
    H to Hk columns (``x`` itself where Hk == H); differentiable."""
    if Hk == H:
        return x
    return torch.nn.functional.pad(x.unflatten(-1, (G, H)), (0, Hk - H)).flatten(-2)


def pad_layer(cell: str, Hk: int, w_hh: torch.Tensor, b_hh: torch.Tensor, xps=()):
    """One layer's (w_hh, b_hh, xps) zero-padded from H to Hk hidden units:
    W_hh's rows and every gate's columns, b_hh and each xp per gate. A
    padded unit has zero xp, weights, bias and state, so it stays at zero
    (GRU: (1-0.5)*tanh(0) + 0.5*0; LSTM: c = 0.5*0 + 0.5*tanh(0); RNN:
    tanh(0)) and, its row of W_hh being zero, feeds nothing into the real
    units: the real outputs are unchanged, the padded ones are sliced away,
    and so are the padded gradients."""
    G, H = _GATES[cell], w_hh.shape[-2]
    if Hk == H:
        return w_hh, b_hh, tuple(xps)
    # [D, H, G, H] -> [D, Hk, G, Hk]: rows and each gate's columns in one pad
    w = torch.nn.functional.pad(w_hh.unflatten(-1, (G, H)), (0, Hk - H, 0, 0, 0, Hk - H))
    return (w.flatten(-2), pad_units(b_hh, G, H, Hk),
            tuple(pad_units(x, G, H, Hk) for x in xps))


def _operand(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in ``dtype``, contiguous and on the 16-byte alignment of the
    kernels' vector copies."""
    x = x.to(dtype).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _widest(plan, cell: str, T: int, B: int, D: int, cdt, hist, slots) -> int:
    """The widest H that ``plan`` (fwd_plan or bwd_plan) lays out at these
    other arguments, for the message of a refused call."""
    return max((h for h in range(4, 4097, 4)
                if plan(cell, T, B, h, D, cdt, hist, slots) is not None), default=0)


_SLOTS = {}  # (which kernel, device index, cell, compute dtype, history dtype) -> slots


def cluster_slots(which: str, cell: str, cdt, hist, device: torch.device) -> dict:
    """How many clusters of each size (1 to 16 CTAs) the card holds at once
    for the recurrent kernel ``which`` ("fwd" or "bwd") at this cell and
    these dtypes: cudaOccupancyMaxActiveClusters, read once per device."""
    cdt, hist = torch_dtype(cdt), torch_dtype(hist)
    idx = device.index if device.index is not None else torch.cuda.current_device()
    key = (which, idx, cell, cdt, hist)
    if key not in _SLOTS:
        lib = _lib() if which == "fwd" else _bwd_lib()
        fn = getattr(lib, f"rnn_{which}_cluster_slots")
        out, slots = ctypes.c_int(0), {}
        for nc in range(1, 17):
            err = fn(idx, _CELL_CODE[cell], int(cdt == torch.bfloat16),
                     int(hist == torch.bfloat16), nc, ctypes.byref(out))
            if err:
                raise RuntimeError(f"rnn_{which}_cluster_slots failed: "
                                   f"{getattr(lib, f'rnn_{which}_error_string')(err).decode()}")
            slots[nc] = out.value
        _SLOTS[key] = slots
    return _SLOTS[key]


def rnn_layer_fwd(
    cell: str,
    xps: Sequence[torch.Tensor],
    mask: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    compute_dtype="bfloat16",
    history_in_cdt: bool = False,
    *,
    phases=None,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...], torch.Tensor]:
    """One recurrent layer over all directions (see the module docstring).
    ``phases`` (a timing tool's): an int64 tensor of D * nc * clusters *
    FWD_PHASE_WORDS on the card, which the instrumented build fills with
    the time loop's phase times (bf16 compute, W resident)."""
    D, T, B, H, GH = _check_args(cell, xps, mask, w_hh, b_hh)
    dev = xps[0].device
    for name, t in (("xps", xps[-1]), ("mask", mask), ("w_hh", w_hh), ("b_hh", b_hh)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xps[0] on {dev}")
    if dev.type == "cpu":
        return rnn_layer_fwd_reference(
            cell, xps, mask, w_hh, b_hh, compute_dtype, history_in_cdt
        )
    if dev.type != "cuda":
        raise ValueError(f"rnn_layer_fwd runs on cpu or cuda tensors, not {dev}")

    cdt = torch_dtype(compute_dtype)
    if cdt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the forward kernel computes in bfloat16 or float32, not {cdt}")
    Hk = kernel_width(H)
    if Hk != H:  # the kernel's width: the zero-padded layer, its results sliced back
        w, b, xs = pad_layer(cell, Hk, w_hh, b_hh, xps)
        outs, c_hist, h_final = rnn_layer_fwd(cell, xs, mask, w, b, compute_dtype, history_in_cdt,
                                              phases=phases)
        return (tuple(o[..., :H] for o in outs), tuple(c[..., :H] for c in c_hist),
                h_final[..., :H])
    hist = cdt if history_in_cdt else torch.float32
    slots = cluster_slots("fwd", cell, cdt, hist, dev)
    plan = fwd_plan(cell, T, B, H, D, cdt, hist, slots)
    if plan is None:
        raise ValueError(
            f"rnn_layer_fwd: no layout of the forward kernel fits shared memory at {cell} "
            f"H={H} {cdt}; it takes H up to "
            f"{_widest(fwd_plan, cell, T, B, D, cdt, hist, slots)}")
    if phases is not None and (phases.dtype != torch.int64 or phases.device != dev or
                               phases.numel() != D * plan["nc"] * plan["clusters"]
                               * FWD_PHASE_WORDS):
        raise ValueError("phases must be int64 on the tensors' device, "
                         f"{D} x {plan['nc'] * plan['clusters']} x {FWD_PHASE_WORDS} words")
    # the kernel reads xp in the compute dtype, as the TPU kernel does
    xs = [_operand(x, cdt) for x in xps]
    w = _operand(w_hh, cdt)
    b = b_hh.to(torch.float32).contiguous()
    m = mask.to(torch.float32).contiguous()
    outs = [torch.empty((T, B, H), dtype=hist, device=dev) for _ in range(D)]
    c_hist = (
        [torch.empty((T, B, H), dtype=hist, device=dev) for _ in range(D)]
        if cell == "LSTM" else []
    )
    h_final = torch.empty((D, B, H), dtype=torch.float32, device=dev)
    # where W streams, the kernel's scratch for W packed chunk by chunk
    n_pack = _fwd_packed_elems(cell, plan, D, cdt.itemsize)
    wsplit = plan.get("wsplit", False)
    wpk = (torch.empty(n_pack, dtype=torch.bfloat16 if wsplit else cdt, device=dev)
           if n_pack else None)

    def ptr(ts, i):
        return ts[i].data_ptr() if i < len(ts) else None

    lib = _lib(() if phases is None else FWD_PHASES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnn_fwd_launch(
            torch.cuda.current_device(),  # the tensors' device (inside the with)
            _CELL_CODE[cell], int(cdt == torch.bfloat16), int(hist == torch.bfloat16),
            T, B, H, D, plan["nc"], plan["rows"], plan["hc"], plan["kc"], plan["wstages"],
            plan["blocks"], int(wsplit), int(plan["wide"]), ptr(xs, 0), ptr(xs, 1),
            m.data_ptr(), w.data_ptr(), None if wpk is None else wpk.data_ptr(), n_pack,
            b.data_ptr(), ptr(outs, 0), ptr(outs, 1), ptr(c_hist, 0), ptr(c_hist, 1),
            h_final.data_ptr(), None if phases is None else phases.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"rnn_fwd kernel launch failed: {lib.rnn_fwd_error_string(err).decode()}")
    rnn_layer_fwd.launches += 1
    return tuple(outs), tuple(c_hist), h_final


rnn_layer_fwd.launches = 0  # kernel launches, counted where the kernel is launched


def rnn_layer_fwd_reference(
    cell: str,
    xps: Sequence[torch.Tensor],
    mask: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    compute_dtype="bfloat16",
    history_in_cdt: bool = False,
):
    """Plain PyTorch version of the kernel: a Python loop over time, the
    directions' products in f32 (:func:`_mm`) on operands rounded to the
    compute dtype."""
    D, T, B, H, GH = _check_args(cell, xps, mask, w_hh, b_hh)
    cdt = torch_dtype(compute_dtype)
    hist = cdt if history_in_cdt else torch.float32
    xs = [x.to(cdt).float() for x in xps]
    w = w_hh.to(cdt).float()
    b = b_hh.float()
    m_all = mask.float()
    dev = xs[0].device
    h = [torch.zeros((B, H), dtype=torch.float32, device=dev) for _ in range(D)]
    c = [torch.zeros((B, H), dtype=torch.float32, device=dev) for _ in range(D)]
    outs = [[None] * T for _ in range(D)]
    cs = [[None] * T for _ in range(D)]
    for i in range(T):
        for d in range(D):
            t = i if d == 0 else T - 1 - i
            xp = xs[d][t]
            m = m_all[t][:, None]
            h_prev = h[d]
            hp = _mm(h_prev.to(cdt).float(), w[d]) + b[d]
            if cell == "GRU":
                r = torch.sigmoid(xp[:, :H] + hp[:, :H])
                z = torch.sigmoid(xp[:, H : 2 * H] + hp[:, H : 2 * H])
                n = torch.tanh(xp[:, 2 * H :] + r * hp[:, 2 * H :])
                h_new = (1.0 - z) * n + z * h_prev
            elif cell == "LSTM":
                g_all = xp + hp
                i_g = torch.sigmoid(g_all[:, :H])
                f_g = torch.sigmoid(g_all[:, H : 2 * H])
                g_g = torch.tanh(g_all[:, 2 * H : 3 * H])
                o_g = torch.sigmoid(g_all[:, 3 * H :])
                c_new = f_g * c[d] + i_g * g_g
                h_new = o_g * torch.tanh(c_new)
                c[d] = m * c_new + (1.0 - m) * c[d]
                cs[d][t] = c[d].to(hist)
            else:
                h_new = torch.tanh(xp + hp)
            h[d] = m * h_new + (1.0 - m) * h_prev
            outs[d][t] = h[d].to(hist)
    out_t = tuple(torch.stack(o) for o in outs)
    c_t = tuple(torch.stack(o) for o in cs) if cell == "LSTM" else ()
    return out_t, c_t, torch.stack(h)


def rnn_fwd_bound(T: int, B: int, H: int, D: int, G: int, cdt_bytes: int, hist_bytes: int):
    """Least time the card could take for one call, from its bytes (each
    input read once, each output written once) and its operations.
    Returns (bytes, flops)."""
    nbytes = (
        D * T * B * G * H * cdt_bytes  # xp
        + T * B * 4  # mask
        + D * H * G * H * cdt_bytes + D * G * H * 4  # w_hh, b_hh
        + D * T * B * H * hist_bytes * (2 if G == 4 else 1)  # outs (+ c history)
        + D * B * H * 4  # h_final
    )
    flops = 2 * T * D * B * H * G * H
    return nbytes, flops


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

# the instrumented build of the backward (csrc/rnn_bwd.cu, RNN_BWD_PHASES):
# the chain's phase times, for tools/bench_rnn_stream.py --step-phases
BWD_PHASES = ("RNN_BWD_PHASES",)
BWD_PHASE_NAMES = ("inputs", "gate math", "push wait", "push", "barrier", "product")
BWD_PHASE_WORDS = len(BWD_PHASE_NAMES) + 2  # the phases' cycles, the loop's cycles and ns


def _bwd_lib(defines=()):
    lib = _build.load("rnn_bwd", defines)
    if not getattr(lib, "_ttr_bound", False):
        lib.rnn_bwd_launch.restype = _INT
        lib.rnn_bwd_launch.argtypes = [
            _INT, _INT, _INT, _INT, _INT,  # device, cell, cdt_bf16, hist_bf16, split
            _INT, _INT, _INT, _INT, _INT,  # T, B, H, D, dir0
            _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT,  # nc, rows, hc, kc, stages, blocks,
                                                             # nsplit, xc
            _INT, _INT,  # wstages, kw
            _INT, _INT, _INT,  # wide, db_rows, khalf
            _VOIDP, _VOIDP, _VOIDP,  # xp0, xp1, mask
            _VOIDP, _VOIDP, _VOIDP, _VOIDP,  # out0, out1, hr0, hr1
            _VOIDP, _VOIDP, _VOIDP, _VOIDP,  # c0, c1, dout0, dout1
            _VOIDP, _VOIDP, ctypes.c_longlong,  # w_hh, wpk, wpk_elems
            _VOIDP, _VOIDP,  # b_hh, d_hfinal
            _VOIDP, _VOIDP, _VOIDP, _VOIDP,  # dxp0, dxp1, dhp0, dhp1
            _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,  # hp_ws, ws_w, ws_b, dw, db
            _VOIDP, ctypes.c_longlong,  # split_ws, split_ws_elems
            _VOIDP, _VOIDP,  # phases, stream
        ]
        lib.rnn_bwd_split_elems.restype = ctypes.c_longlong
        lib.rnn_bwd_split_elems.argtypes = [_INT] * 6  # cell, T, B, H, D, split
        lib.rnn_bwd_error_string.restype = ctypes.c_char_p
        lib.rnn_bwd_error_string.argtypes = [_INT]
        lib.rnn_bwd_cluster_slots.restype = _INT
        lib.rnn_bwd_cluster_slots.argtypes = [_INT] * 5 + [ctypes.POINTER(_INT)]
        lib._ttr_bound = True
    return lib


def _bwd_smem_bytes(cell: str, H: int, cdt_bytes: int, hist_bytes: int, rows: int, hc: int,
                    kc: int, stages: int, blocks: int = 2, xc: int = None, wstages: int = 0,
                    kw: int = None) -> int:
    """Shared memory of one CTA of the backward's chain kernel: the CTA's
    rows of round(W) (all G*H columns where ``kc`` covers them; else a ring
    of ``wstages`` stages of ``kw`` columns each with a full and an empty
    barrier a stage, or, ``wstages`` 0, one buffer of ``kc`` columns),
    ``blocks`` rounded dhp row blocks (``xc`` columns of each held at once:
    where fewer than G*H, the CTA's own rounded dhp too), the staging
    buffers, the dh (and dc) carry and the db partial (``chain_smem`` in
    csrc/rnn_bwd.cu, region by region). ``stages`` 0 is the large-batch
    layout (bf16): its row block is a region [rows][:func:`_wide_ld`] of
    each of the ceil(H / hc) CTAs' columns and each k16 step's offsets in
    them (int32 x 4), and it has an mbarrier a part of 32 rows; no staging
    and no db partial (in registers; after the loop it passes through
    [G][rows][hc] f32 laid over W and the row block)."""
    G = _GATES[cell]
    kp = _up(G * H, 16)
    xw = kp if xc is None else min(xc, kp)
    padk = 16 // cdt_bytes
    stage = 2 * _up(rows * hc * hist_bytes, 16) + _up(rows * 4, 16)
    if cell != "RNN":
        stage += _up(G * rows * hc * 4, 16) + _up(G * rows * hc * cdt_bytes, 16)
    carries = 2 if cell == "LSTM" else 1
    own = _up(rows * G * hc * cdt_bytes, 16) if xw < kp else 0
    if kc < kp and wstages:
        w = wstages * (_up(hc * (kw + padk) * cdt_bytes, 16) + 16)
    else:
        w = _up(hc * (min(kc, kp) + padk) * cdt_bytes, 16)
    db = _up(G * rows * hc * 4, 16)
    if not stages:  # the large-batch layout
        regions = _up(-(-H // hc) * rows * _wide_ld(G, hc) * cdt_bytes, 16) + kp // 16 * 16
        bars = _up(8 * (rows // 32), 16)  # an mbarrier a part of 32 rows
        return max(w + regions + carries * _up(rows * hc * 4, 16) + bars, db)
    return (w + _up(blocks * rows * (xw + padk) * cdt_bytes, 16) + own + stages * stage
            + carries * _up(rows * hc * 4, 16) + db)


def _wide_ld(G: int, hc: int) -> int:
    """Elements of a row of a CTA's region in the backward's large-batch
    layout: its G*hc columns and the pad that keeps ldmatrix's eight
    16-byte rows on distinct banks (``wide_ld`` in csrc/rnn_bwd.cu)."""
    return G * hc + (16 if (G * hc // 8) % 2 else 8)


def _bwd_packed_elems(cell: str, plan: dict, D: int, cdt_bytes: int) -> int:
    """Elements of the backward's packed W (``rnn_bwd_pack_w`` in
    csrc/rnn_bwd.cu: [D][nc][pieces][hc][kw + pad]) where the plan streams
    W, else 0."""
    if plan["resident"]:
        return 0
    kp = _up(_GATES[cell] * plan["H"], 16)
    kc, kw = plan["kc"], plan["kw"]
    nch = -(-kp // kc)
    pieces = (nch - 1) * -(-kc // kw) + -(-(kp - (nch - 1) * kc) // kw)
    return D * plan["nc"] * pieces * plan["hc"] * (kw + 16 // cdt_bytes)


def _bwd_ring(cell: str, H: int, cb: int, hb: int, rows: int, hc: int, kc: int, stages: int,
              blocks: int, xc: int):
    """The ring a streamed backward layout takes: (kw, wstages, stages,
    blocks, smem). ``kc`` stays: it is where the chain product's four
    accumulators restart, so it fixes the order of the sums. Each piece of
    W costs its warps about a microsecond whatever its size, so pieces are
    as wide as they can be: where the dhp row block is exchanged whole, a
    stage holds a whole ``kc`` chunk and the ring as many as fit (one where
    a second does not: each chunk's copy then waits for the last reads of
    the one before); where it is exchanged in chunks, each with its own
    cluster barrier, two stages of the widest piece that leaves two (a
    multiple of 32 columns at bf16, 16 at f32), so that the next piece
    lands while the CTAs meet at the barrier. Where the layout leaves no
    room for the barriers, one staging buffer and then (whole-block
    exchange) one row block make it; neither changes a result. None where
    even that leaves no stage."""
    padk = 16 // cb
    chunked = xc < _up(_GATES[cell] * H, 16)

    def stage(w):
        return _up(hc * (w + padk) * cb, 16) + 16

    tries = [(stages, blocks), (1, blocks)] + ([] if chunked else [(stages, 1), (1, 1)])
    for st, bl in dict.fromkeys(tries):
        rest = _bwd_smem_bytes(cell, H, cb, hb, rows, hc, 0, st, bl, xc) - _up(hc * padk * cb, 16)
        room = _SMEM_LIMIT - rest
        kw, wstages = kc, min(_RING_MAX, room // stage(kc))
        if chunked:
            step = 32 if cb == 2 else 16
            two = [w for w in range(step, kc, step) if 2 * stage(w) <= room]
            if wstages < 2 and two:
                kw, wstages = two[-1], 2
        if wstages >= 1:
            return kw, wstages, st, bl, _bwd_smem_bytes(cell, H, cb, hb, rows, hc, kc, st, bl,
                                                        xc, wstages, kw)
    return None


def bwd_waves(plan: dict, D: int) -> int:
    """How many times the card runs the backward's whole time loop: the
    plan's clusters, both directions, over the clusters of its size the
    card holds at once."""
    return -(-D * plan["clusters"] // plan["slots"])


def _bwd_wide_plan(cell: str, B: int, H: int, D: int, hb: int, slots, base: dict):
    """The backward's large-batch layout in place of ``base``, a cluster-route
    plan with W resident and the row block exchanged whole (bf16, H a
    multiple of 16; :func:`bwd_plan`): over the cluster sizes whose CTAs
    take a multiple of 16 columns and the rows a CTA's units hold
    (multiples of 32 from 64), W resident beside one dhp row block in
    per-CTA regions exchanged by bulk copies, and no staging
    buffer (stages 0; the gate math reads its inputs from L2 and keeps the
    db partial in registers), the fewest waves; then clusters of 8 before
    16; then the fewest rows. Its sums keep ``base``'s order, so it
    gives ``base``'s bits: a db partial per ``db_rows`` = ``base``'s rows,
    and where ``base``'s product split k between two warps (``halves`` in
    csrc/rnn_bwd.cu), the two halves summed apart (``khalf``, where the
    second starts; 0 where ``base`` did not split). None where no such
    layout fits."""
    kp = _up(_GATES[cell] * H, 16)
    # csrc/rnn_bwd.cu's halves: two of its 8 warps a unit where they hold twice the units
    halves = 2 * _units(base["rows"], base["hc"]) <= 8
    khalf = (kp // 16 + 1) // 2 * 16 if halves else 0
    best = None
    for nc, hc in _cluster_sizes(H, slots):
        for R in _WIDE_BWD_ROWS:
            if hc % 16 or _units(R, hc) > _UNITS_MAX or R > _up(B, 32):
                break
            smem = _bwd_smem_bytes(cell, H, 2, hb, R, hc, kp, 0, 1)
            if smem > _SMEM_LIMIT:
                break
            plan = dict(base, nc=nc, hc=hc, rows=R, clusters=-(-B // R), stages=0, blocks=1,
                        smem=smem, slots=slots[nc], wide=True, db_rows=base["rows"],
                        khalf=khalf)
            key = (bwd_waves(plan, D), nc, R)
            if best is None or key < best[0]:
                best = (key, plan)
    return None if best is None else best[1]


def bwd_plan(cell: str, T: int, B: int, H: int, D: int, compute_dtype="bfloat16",
             history_dtype=torch.float32, slots=H100_SXM_CLUSTER_SLOTS):
    """The backward kernel's layout for one call, or None when none fits
    shared memory. ``nc`` CTAs per cluster (at most 8; 16 where 8 do not
    fit and the card holds clusters of 16), each owning ``hc`` hidden
    columns; ``rows`` batch rows per cluster (``clusters`` of them per
    direction); ``kc`` columns of the CTA's W rows a chunk (``resident``:
    all of G*H, loaded once; else streamed every step through a ring of
    ``wstages`` stages of ``kw`` columns, :func:`_bwd_ring`, 0 where
    resident);
    ``stages`` staging buffers (2: a step's inputs load during the step
    before); ``blocks`` dhp row blocks (2, or 1 with a second cluster
    barrier a step); ``xc`` the columns of the row block exchanged at a
    time (G*H rounded up to 16: all of it; fewer where even one row block
    does not fit, in chunks of ``xc``, each with its own cluster barrier and
    W streamed in the same chunks); ``nsplit`` slices of the
    weight-gradient product; ``smem`` bytes per CTA; ``H`` the kernel's
    width, the layer's rounded up to 4 (the wrapper zero-pads). Tried in
    turn: the whole row block in clusters of 8, then of 16, then the
    chunked exchange in clusters of 16, then of 8. Of the layouts that fit
    one of these, the one that streams W in the fewest chunks a step (1:
    resident), then the first of two row blocks before one, 32 rows before
    16 and two staging buffers before one, sized as if one chunk buffer
    held W (so ``kc``, which orders the sums, is what it was before the
    ring). Large batches (bf16, B >= 256): where that plan keeps W resident
    and the row block whole and takes more than one wave (32 rows a
    cluster at most, so GRU H=256 B=1024 takes five), the large-batch
    layout (:func:`_bwd_wide_plan`; ``wide``, with ``db_rows`` and
    ``khalf``) takes over where it needs fewer waves: GRU H=256 B=1024
    then takes 96 rows a cluster, 11 clusters of 8 a direction, two waves.
    Every other plan is that route's, with ``wide`` False. ``slots``: as
    fwd_plan's. The kernel checks the plan and refuses one that does not
    fit."""
    G = _GATES[cell]
    H = _up(max(H, 1), _BWD_MULTIPLE)
    GH = G * H
    kp = _up(GH, 16)
    cb = torch_dtype(compute_dtype).itemsize
    hb = history_dtype.itemsize
    sizes = _cluster_sizes(H, slots)
    rows_all = (32, 16) if cb == 2 else (16, 8)
    if B <= rows_all[1]:
        rows_all = rows_all[1:]
    whole = sizes
    if cb == 4 and len(sizes) > 1 and _bwd_smem_bytes(
            cell, H, cb, hb, rows_all[-1], sizes[0][1], kp, 1, 1) > _SMEM_LIMIT:
        # f32: where clusters of 8 would stream W, clusters of 16 first, each
        # CTA drawing half of W a step (the --layouts sweep at GRU H=1024 B=64
        # T=32 on an H100: 7.15-7.49 ms against 10.56, PERF.md section 6)
        whole = sizes[::-1]
    best = None
    for chunked, (nc, hc) in [(False, x) for x in whole] + [(True, x) for x in sizes[::-1]]:
        for blocks in ((2,) if chunked else (2, 1)):
            for rows in rows_all:
                if _units(rows, hc) > _UNITS_MAX:
                    continue
                for resident in ((False,) if chunked else (True, False)):
                    for stages in (2, 1):
                        xc = kp
                        if chunked:  # the widest chunk, of W and the row block alike
                            base = _bwd_smem_bytes(cell, H, cb, hb, rows, hc, 0, stages, 2, 0)
                            xc = min(kp - 16, (_SMEM_LIMIT - base) // ((hc + 2 * rows) * cb)
                                     // 16 * 16)
                            while xc >= 16 and _bwd_smem_bytes(cell, H, cb, hb, rows, hc, xc,
                                                               stages, 2, xc) > _SMEM_LIMIT:
                                xc -= 16
                            if xc < 16:
                                continue
                            kc = xc
                        elif resident:
                            kc = kp
                        else:  # the widest chunk that fits beside the rest
                            rest = _bwd_smem_bytes(cell, H, cb, hb, rows, hc, 0, stages, blocks)
                            rest -= _up(hc * (16 // cb) * cb, 16)
                            kc = min(kp - 16,
                                     ((_SMEM_LIMIT - rest) // (hc * cb) - 16 // cb) // 16 * 16)
                            if kc < 16:
                                continue
                        smem = _bwd_smem_bytes(cell, H, cb, hb, rows, hc, kc, stages, blocks, xc)
                        if smem > _SMEM_LIMIT:
                            continue
                        # the fewest chunks of W a step (each costs a copy and two
                        # block barriers), the first in this order on a tie
                        chunks = -(-kp // kc)
                        if best is None or chunks < best[0]:
                            best = (chunks, nc, hc, blocks, rows, kc, resident, stages, xc, smem)
        if best is not None:
            break
    if best is None:
        return None
    _, nc, hc, blocks, rows, kc, resident, stages, xc, smem = best
    kw, wstages = kc, 0
    if not resident:
        ring = _bwd_ring(cell, H, cb, hb, rows, hc, kc, stages, blocks, xc)
        if ring is None:
            return None
        kw, wstages, stages, blocks, smem = ring
    tiles = D * -(-H // _GEMM_TILE) * -(-GH // _GEMM_TILE)
    nsplit = max(1, min(-(-2 * _SMS // tiles), -(-T * B // 64)))
    plan = {"H": H, "nc": nc, "hc": hc, "rows": rows, "clusters": -(-B // rows), "kc": kc,
            "resident": resident, "stages": stages, "blocks": blocks, "xc": xc,
            "nsplit": nsplit, "wstages": wstages, "kw": kw, "smem": smem, "slots": slots[nc],
            "wide": False}
    if (cb == 2 and B >= _WIDE_BATCH and H % 16 == 0 and resident and xc >= kp
            and bwd_waves(plan, D) > 1):
        wide = _bwd_wide_plan(cell, B, H, D, hb, slots, plan)
        if wide is not None and bwd_waves(wide, D) < bwd_waves(plan, D):
            return wide
    return plan


def _check_bwd_args(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal):
    D, T, B, H, GH = _check_args(cell, xps, mask, w_hh, b_hh)
    if len(outs) != D or len(douts) != D or len(c_hist) != (D if cell == "LSTM" else 0):
        raise ValueError(
            f"{D} directions need {D} outs and douts and "
            f"{D if cell == 'LSTM' else 0} cell histories"
        )
    for name, ts in (("outs", outs), ("c_hist", c_hist), ("douts", douts)):
        if any(tuple(x.shape) != (T, B, H) for x in ts):
            raise ValueError(f"{name} must be [T, B, H] = {(T, B, H)}")
    if tuple(d_hfinal.shape) != (D, B, H):
        raise ValueError(f"d_hfinal must be {(D, B, H)}, got {tuple(d_hfinal.shape)}")
    return D, T, B, H, GH


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain versions' f32 products, forward and backward (operands
    already rounded). At f32 compute the kernels form them as split
    products; a test puts ``utils/dtypes.py`` ``matmul_split`` here to run
    that arithmetic on the CPU."""
    return torch.matmul(a, b)


def _prev(x: torch.Tensor, direction: int) -> torch.Tensor:
    """h_prev (or c_prev) in original time order: the saved history shifted
    by the direction's processing order, zero at its first position."""
    zero = torch.zeros_like(x[:1])
    return torch.cat([zero, x[:-1]]) if direction == 0 else torch.cat([x[1:], zero])


def _bwd_reference(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal,
                   compute_dtype, split: bool, dir0: int = 0):
    """Plain PyTorch version of the backward kernel, both modes, in the
    kernel's order and with its rounding points: the gate recompute for all
    steps as one product before the loop, a Python loop over time that
    carries only dh (and dc), and, unless ``split``, the weight gradient as
    one product after it. Returns (dxps, dhps) in the compute dtype (dhps
    is dxps but for GRU) and, unless ``split``, (dw [D, H, G*H], db
    [D, G*H]) f32."""
    D, T, B, H, GH = _check_bwd_args(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal)
    cdt = torch_dtype(compute_dtype)
    hist = outs[0].dtype
    dev = xps[0].device

    def rnd(x):  # rounded to the compute dtype, computed on in f32
        return x.to(cdt).float()

    xs = [rnd(x) for x in xps]
    w = rnd(w_hh)
    m_all = mask.float()
    hs = [o.float() for o in outs]
    h_prevs = [_prev(h, dir0 + e) for e, h in enumerate(hs)]
    c_prevs = [_prev(c.float(), dir0 + e) for e, c in enumerate(c_hist)]
    dos = [d.to(hist).float() for d in douts]
    # the gate recompute, off the chain: [T, B, H] x [H, G*H] per direction
    hps = [_mm(rnd(h_prevs[e]), w[e]) + b_hh[e].float() for e in range(D)] \
        if cell != "RNN" else None
    dh = [d_hfinal[e].float() for e in range(D)]
    dc = [torch.zeros((B, H), dtype=torch.float32, device=dev) for _ in range(D)]
    dxps = [torch.empty((T, B, GH), dtype=cdt, device=dev) for _ in range(D)]
    dhps = [torch.empty((T, B, GH), dtype=cdt, device=dev) for _ in range(D)] \
        if cell == "GRU" else dxps
    dhp32 = None if split else torch.empty((D, T, B, GH), dtype=torch.float32, device=dev)
    for step in range(T):
        for e in range(D):
            t = T - 1 - step if dir0 + e == 0 else step
            h_prev = h_prevs[e][t]
            xp = xs[e][t]
            m = m_all[t][:, None]
            dh_t = dh[e] + dos[e][t]
            dh_new = dh_t * m
            dh_direct = dh_t * (1.0 - m)
            if cell == "GRU":
                hp = hps[e][t]
                r = torch.sigmoid(xp[:, :H] + hp[:, :H])
                z = torch.sigmoid(xp[:, H : 2 * H] + hp[:, H : 2 * H])
                n = torch.tanh(xp[:, 2 * H :] + r * hp[:, 2 * H :])
                h_n = hp[:, 2 * H :]
                dz = dh_new * (h_prev - n)
                dn_pre = dh_new * (1.0 - z) * (1.0 - n * n)
                dr_pre = dn_pre * h_n * r * (1.0 - r)
                dz_pre = dz * z * (1.0 - z)
                dxp = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
                dhp = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)
                dh[e] = _mm(rnd(dhp), w[e].T) + dh_new * z + dh_direct
                dhps[e][t] = dhp.to(cdt)
            elif cell == "LSTM":
                c_prev = c_prevs[e][t]
                dc_new = dc[e] * m
                dc_direct = dc[e] * (1.0 - m)
                g_all = xp + hps[e][t]
                i_g = torch.sigmoid(g_all[:, :H])
                f_g = torch.sigmoid(g_all[:, H : 2 * H])
                g_g = torch.tanh(g_all[:, 2 * H : 3 * H])
                o_g = torch.sigmoid(g_all[:, 3 * H :])
                c_new = f_g * c_prev + i_g * g_g
                tanh_c = torch.tanh(c_new)
                do = dh_new * tanh_c
                dc_new = dc_new + dh_new * o_g * (1.0 - tanh_c * tanh_c)
                dxp = dhp = torch.cat([
                    dc_new * g_g * i_g * (1.0 - i_g),
                    dc_new * c_prev * f_g * (1.0 - f_g),
                    dc_new * i_g * (1.0 - g_g * g_g),
                    do * o_g * (1.0 - o_g),
                ], dim=-1)
                dc[e] = dc_new * f_g + dc_direct
                dh[e] = _mm(rnd(dhp), w[e].T) + dh_direct
            else:  # RNN: the saved output stands in for h_new where m == 1
                h_t = hs[e][t]
                dxp = dhp = dh_new * (1.0 - h_t * h_t)
                dh[e] = _mm(rnd(dhp), w[e].T) + dh_direct
            dxps[e][t] = dxp.to(cdt)
            if not split:
                dhp32[e, t] = dhp
    if split:
        return tuple(dxps), tuple(dhps), None, None
    # the weight gradient, off the chain: [H, T*B] x [T*B, G*H] per direction
    dw = torch.stack([_mm(rnd(h_prevs[e]).reshape(-1, H).T, rnd(dhp32[e]).reshape(-1, GH))
                      for e in range(D)])
    db = dhp32.reshape(D, -1, GH).sum(dim=1)
    return tuple(dxps), tuple(dhps), dw, db


def _bwd_call(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal,
              compute_dtype, split: bool, dir0: int = 0, phases=None):
    """Launch the backward kernel on CUDA tensors, or run its plain version
    on CPU tensors; returns what :func:`_bwd_reference` returns. ``phases``
    (a timing tool's): an int64 tensor of D * nc * clusters *
    BWD_PHASE_WORDS on the card, which the instrumented build fills with
    the chain's phase times."""
    D, T, B, H, GH = _check_bwd_args(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal)
    if dir0 not in (0, 1) or dir0 + D > 2:
        raise ValueError(f"dir0={dir0} with {D} directions")
    dev = xps[0].device
    for name, t in (("mask", mask), ("w_hh", w_hh), ("b_hh", b_hh), ("d_hfinal", d_hfinal),
                    *(("outs/c_hist/douts", x) for x in (*outs, *c_hist, *douts))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xps[0] on {dev}")
    if dev.type == "cpu":
        return _bwd_reference(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal,
                              compute_dtype, split, dir0)
    if dev.type != "cuda":
        raise ValueError(f"the rnn backward runs on cpu or cuda tensors, not {dev}")

    cdt = torch_dtype(compute_dtype)
    if cdt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the backward kernel computes in bfloat16 or float32, not {cdt}")
    hist = outs[0].dtype
    if hist not in (torch.float32, cdt):
        raise ValueError(f"the history must be f32 or the compute dtype, got {hist}")
    Hk = _up(H, _BWD_MULTIPLE)
    if Hk != H:  # the kernel's width: the zero-padded layer, its results sliced back
        G = _GATES[cell]
        w, b, xs = pad_layer(cell, Hk, w_hh, b_hh, xps)
        hs, cs, dos = ([pad_units(x, 1, H, Hk) for x in ts] for ts in (outs, c_hist, douts))
        dxps, dhps, dw, db = _bwd_call(cell, xs, mask, w, b, hs, cs, dos,
                                       pad_units(d_hfinal, 1, H, Hk), compute_dtype, split, dir0,
                                       phases)

        def cut(x):
            return x.unflatten(-1, (G, Hk))[..., :H].flatten(-2)

        return (tuple(cut(x) for x in dxps), tuple(cut(x) for x in dhps),
                None if dw is None else cut(dw[:, :H]), None if db is None else cut(db))
    slots = cluster_slots("bwd", cell, cdt, hist, dev)
    plan = bwd_plan(cell, T, B, H, D, compute_dtype, hist, slots)
    if plan is None:
        raise ValueError(
            f"rnn_layer_bwd: no layout of the backward kernel fits shared memory at {cell} "
            f"H={H} {cdt} with a {hist} history; it takes H up to "
            f"{_widest(bwd_plan, cell, T, B, D, cdt, hist, slots)}")
    xs = [_operand(x, cdt) for x in xps]
    hs = [_operand(o, hist) for o in outs]
    cs = [_operand(c, hist) for c in c_hist]
    dos = [_operand(d, hist) for d in douts]
    w = _operand(w_hh, cdt)
    b = b_hh.to(torch.float32).contiguous()
    dhf = d_hfinal.to(torch.float32).contiguous()
    hr = [h if hist == cdt else h.to(cdt) for h in hs]  # the products' operand
    m = mask.to(torch.float32).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dxps = [torch.empty((T, B, GH), dtype=cdt, device=dev) for _ in range(D)]
    # GRU's dhp: an output in split mode, the weight-gradient operand otherwise
    dhps = [torch.empty((T, B, GH), dtype=cdt, device=dev) for _ in range(D)] \
        if cell == "GRU" else []
    hp_ws = torch.empty((D, T * B, GH), **f32) if cell != "RNN" else None
    if split:
        ws_w = ws_b = dw = db = None
    else:
        ws_w = torch.empty((D, plan["nsplit"], H, GH), **f32)
        # a db partial per cluster (large-batch layout: per db_rows rows)
        ws_b = torch.empty((D, -(-B // (plan["db_rows"] if plan["wide"] else plan["rows"])), GH),
                           **f32)
        dw = torch.empty((D, H, GH), **f32)
        db = torch.empty((D, GH), **f32)

    # where W streams, the chain's scratch for W packed piece by piece
    n_pack = _bwd_packed_elems(cell, plan, D, cdt.itemsize)
    wpk = torch.empty(n_pack, dtype=cdt, device=dev) if n_pack else None
    lib = _bwd_lib(() if phases is None else BWD_PHASES)
    # f32 compute: the GEMMs' operands in their bf16 pieces, written once a call
    n_split = (lib.rnn_bwd_split_elems(_CELL_CODE[cell], T, B, H, D, int(split))
               if cdt == torch.float32 else 0)
    split_ws = torch.empty(n_split, dtype=torch.bfloat16, device=dev) if n_split else None

    def ptr(x):
        return None if x is None else x.data_ptr()

    def at(ts, i):
        return ts[i].data_ptr() if i < len(ts) else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnn_bwd_launch(
            torch.cuda.current_device(), _CELL_CODE[cell], int(cdt == torch.bfloat16),
            int(hist == torch.bfloat16), int(split), T, B, H, D, dir0,
            plan["nc"], plan["rows"], plan["hc"], plan["kc"], plan["stages"], plan["blocks"],
            plan["nsplit"], plan["xc"], plan["wstages"], plan["kw"], int(plan["wide"]),
            plan["db_rows"] if plan["wide"] else plan["rows"], plan["khalf"] if plan["wide"] else 0,
            at(xs, 0), at(xs, 1), m.data_ptr(),
            at(hs, 0), at(hs, 1), at(hr, 0), at(hr, 1), at(cs, 0), at(cs, 1),
            at(dos, 0), at(dos, 1),
            w.data_ptr(), ptr(wpk), n_pack, b.data_ptr(), dhf.data_ptr(),
            at(dxps, 0), at(dxps, 1), at(dhps, 0), at(dhps, 1),
            ptr(hp_ws), ptr(ws_w), ptr(ws_b), ptr(dw), ptr(db), ptr(split_ws), n_split,
            ptr(phases), stream,
        )
    if err:
        raise RuntimeError(f"rnn_bwd kernel launch failed: {lib.rnn_bwd_error_string(err).decode()}")
    rnn_layer_bwd.launches += 1
    return tuple(dxps), (tuple(dhps) if dhps else tuple(dxps)), dw, db


def rnn_layer_bwd(
    cell: str,
    xps: Sequence[torch.Tensor],
    mask: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    outs: Sequence[torch.Tensor],
    c_hist: Sequence[torch.Tensor],
    douts: Sequence[torch.Tensor],
    d_hfinal: torch.Tensor,
    compute_dtype="bfloat16",
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """One recurrent layer's backward, weight gradients accumulated in the
    kernel: (dxps per direction [T, B, G*H], dw_hh [D, H, G*H], db_hh
    [D, G*H]), all f32 (dxp is computed in the compute dtype)."""
    dxps, _, dw, db = _bwd_call(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal,
                                compute_dtype, split=False)
    return tuple(d.float() for d in dxps), dw, db


rnn_layer_bwd.launches = 0  # kernel launches (either mode), counted where launched


def rnn_layer_bwd_reference(
    cell: str,
    xps: Sequence[torch.Tensor],
    mask: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    outs: Sequence[torch.Tensor],
    c_hist: Sequence[torch.Tensor],
    douts: Sequence[torch.Tensor],
    d_hfinal: torch.Tensor,
    compute_dtype="bfloat16",
):
    """Plain PyTorch version of :func:`rnn_layer_bwd`, on any device."""
    dxps, _, dw, db = _bwd_reference(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts,
                                     d_hfinal, compute_dtype, split=False)
    return tuple(d.float() for d in dxps), dw, db


def rnn_layer_bwd_split(
    cell: str,
    xp: torch.Tensor,  # [T, B, G*H], original time order
    mask: torch.Tensor,
    w_hh1: torch.Tensor,  # [1, H, G*H]
    b_hh1: torch.Tensor,  # [1, G*H]
    out: torch.Tensor,  # [T, B, H] this direction's history
    c_hist1,  # [T, B, H] (LSTM) or None
    dout: torch.Tensor,
    d_hfinal1: torch.Tensor,  # [1, B, H]
    direction: int = 0,
    compute_dtype="bfloat16",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One direction in split mode: (dxp, dhp) [T, B, G*H] in the compute
    dtype (dhp is dxp except in GRU's candidate third)."""
    dxps, dhps, _, _ = _bwd_call(
        cell, (xp,), mask, w_hh1, b_hh1, (out,), () if c_hist1 is None else (c_hist1,),
        (dout,), d_hfinal1, compute_dtype, split=True, dir0=direction,
    )
    return dxps[0], dhps[0]


def _hoisted_weight_grad(out: torch.Tensor, dhp: torch.Tensor, direction: int, cdt):
    """(dw [H, G*H], db [G*H]) f32 for one direction from its emitted dhp:
    dw = sum_t h_prev(t)^T dhp(t) as one [H, T*B] x [T*B, G*H] product.
    h_prev in original time order is the saved output shifted by the
    direction's processing order; masked steps have zero dhp."""
    cdt = torch_dtype(cdt)
    H = out.shape[-1]
    h_prev = _prev(out, direction)
    dhp2 = dhp.reshape(-1, dhp.shape[-1])
    dw = matmul_f32(h_prev.reshape(-1, H).T, dhp2, cdt)
    db = dhp2.float().sum(dim=0)
    return dw, db


def _bwd_hoisted_call(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal,
                      compute_dtype="bfloat16"):
    """Both directions in one split-mode launch: (dxps, dhps) per direction
    in the compute dtype."""
    dxps, dhps, _, _ = _bwd_call(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal,
                                 compute_dtype, split=True)
    return dxps, dhps


def rnn_layer_bwd_hoisted(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal,
                          compute_dtype="bfloat16"):
    """Drop-in equivalent of :func:`rnn_layer_bwd`: one split-mode launch
    for both directions, weight gradients as one product per direction."""
    dxps, dhps = _bwd_hoisted_call(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts,
                                   d_hfinal, compute_dtype)
    grads = [_hoisted_weight_grad(outs[d], dhps[d], d, compute_dtype) for d in range(len(xps))]
    return (
        tuple(d.float() for d in dxps),
        torch.stack([g[0] for g in grads]),
        torch.stack([g[1] for g in grads]),
    )


def rnn_layer_bwd_split_full(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal,
                             compute_dtype="bfloat16"):
    """The JAX package's split plan: one split-mode launch per direction,
    then the hoisted weight gradients. Same results as
    :func:`rnn_layer_bwd_hoisted`."""
    dxps, dws, dbs = [], [], []
    for d in range(len(xps)):
        dxp, dhp = rnn_layer_bwd_split(
            cell, xps[d], mask, w_hh[d : d + 1], b_hh[d : d + 1], outs[d],
            c_hist[d] if c_hist else None, douts[d], d_hfinal[d : d + 1],
            direction=d, compute_dtype=compute_dtype,
        )
        dw, db = _hoisted_weight_grad(outs[d], dhp, d, compute_dtype)
        dxps.append(dxp.float())
        dws.append(dw)
        dbs.append(db)
    return tuple(dxps), torch.stack(dws), torch.stack(dbs)


def rnn_bwd_bound(T: int, B: int, H: int, D: int, G: int, cdt_bytes: int, hist_bytes: int,
                  split: bool = False):
    """Bytes (each input read once, each output written once) and
    operations of one backward call. Returns (bytes, flops). The gate
    recompute is a product only for GRU and LSTM; split mode does no
    weight-gradient product and writes dhp (GRU) instead of dW/db."""
    GH = G * H
    stream = D * T * B * GH * cdt_bytes  # one [T, B, G*H] tensor per direction
    nbytes = (
        stream  # xp
        + T * B * 4  # mask
        + D * T * B * H * hist_bytes * (3 if G == 4 else 2)  # outs, douts (+ c history)
        + D * H * GH * cdt_bytes + D * GH * 4 + D * B * H * 4  # w_hh, b_hh, d_hfinal
        + stream  # dxp
    )
    nbytes += stream * (G == 3) if split else D * H * GH * 4 + D * GH * 4
    products = (1 if G > 1 else 0) + 1 + (0 if split else 1)
    return nbytes, 2 * products * T * D * B * H * GH
