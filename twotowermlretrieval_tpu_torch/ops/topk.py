"""Exact top-k retrieval: CUDA scan kernels + torch selection.

The port of the JAX package's ``ops/topk.py``. Five kernel wrappers over
three CUDA sources, each with a plain PyTorch version beside it (a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises) and a launch count:

- :func:`segmax` (``csrc/segmax.cu``): phase 1 of :func:`fused_topk_segmax`
  over a bf16/f32 corpus. Scores every doc row against the queries in the
  storage dtype with f32 sums, masks rows >= ``n_valid`` with ``NEG_INF``
  and keeps only the maximum of each 128-row segment ([S, B] f32), plus
  optionally every masked score ([Npad, B] f32, ``phase2="gather"``). An
  f32 corpus is scored on the tensor cores from three bf16 pieces of each
  value (:func:`split_scores`: the six leading products, as XLA's HIGHEST
  precision takes them on the TPU).
- :func:`segmax_int8` (``csrc/segmax.cu``): the same over a corpus
  quantized per row (:func:`quantize_rows`), each sum times its row's scale;
  phase 1 of :func:`fused_topk_segmax_int8`.
- :func:`segmax_s8` (``csrc/segmax_s8.cu``): phase 1 of int8 serving
  (:func:`fused_topk_segmax_s8`) over a corpus quantized per segment
  (:func:`quantize_segments`) with per-row int8 queries: exact integer
  scores on s8 tensor-core tiles, integer segment maxima, no padding mask.
- :func:`topk_stream` / :func:`topk_stream_int8` (``csrc/topk_stream.cu``):
  the running top-k behind :func:`fused_topk` / :func:`fused_topk_int8`.

Phase 2 of the segment-max searches is plain torch: the k segments with
the largest maxima per query cover the true top-k (the segment holding the
i-th best score has a maximum >= it, and fewer than i other segments can
beat that), so re-scoring (or gathering) those candidates and taking their
top-k is exact. :func:`topk_segmented` and its int8 siblings are the
two-phase path over a full [B, N] product, as the JAX package has them.

The int8 paths keep the JAX package's arithmetic to the bit at every
width: integer scores are exact (int32 sums in the s8 kernel and in the
CPU's products; on a card the plain route sums exact f32 products of
pieces of at most 1040 columns in int32, see :func:`_int_matmul`) and
convert to f32 once, rounding to nearest even as XLA's convert does; the
dequantizing multiplies run in the same order. The s8 kernel takes every
H that is a multiple of 16 up to the widest layout that fits a block
(:func:`s8_plan`: 6144 at 32 query rows) and refuses wider ones before
any launch.

Ties: ``lax.top_k`` breaks ties toward the lower index and ``torch.topk``
on CUDA promises no order. Every selection here is a stable descending
sort, so each breaks ties by position as ``lax.top_k`` does. The final one
runs over the candidates in the layout ``sort_candidates`` picks (see
:func:`_select_segments`), the same as the JAX package's, so even a
bitwise tie at the k boundary resolves as there.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from twotowermlretrieval_tpu_torch.ops import _build
from twotowermlretrieval_tpu_torch.utils.dtypes import matmul_split
from twotowermlretrieval_tpu_torch.utils.profiling import annotate

NEG_INF = float(-3.0e38)  # fits f32; safer than -inf for max/compare chains
_SEG = 128  # covering-segment width; int8 index files of the JAX package use it too
# The kernels hold at most this many query rows (in registers and shared
# memory); larger batches run one corpus pass per block of queries.
_MAX_KERNEL_B = 32
_S8_SEGS = (32, 64, 128)  # segment widths the s8 kernel takes
_F32_EXACT_H = 1040  # 127 * 127 * H < 2^24: an f32 product of int8 values is exact
_TOPK_MAX_K = 128  # keys the running top-k kernel keeps per query row
_ROW_TILE = 8192  # an index pads its rows once to this tile (the scans' tile_n)
_COL_TILE = 16  # on a card, an index pads its embedding widths to this (16-byte int8 rows)
# The running top-k first finds the top k of every 32nd tile (a pilot) and
# starts every block's threshold at its k-th key: a block then admits few
# keys and merges rarely. Its two extra launches pay where merges are dear,
# with 8 query rows or more over 1,024 tiles or more; one query row loses.
_PILOT_STRIDE, _PILOT_MIN_TILES, _PILOT_MIN_B = 32, 1024, 8
_INV_127 = float(np.float32(1.0) / np.float32(127.0))  # exact in f32

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong

# C entry points of each kernel library; each begins with the device
# ordinal and ends with the stream.
_SIGNATURES = {
    "segmax": {
        # device, storage, B, H, npad, n_valid, stages, blocks,
        # q, docs, scales, segmax, cache, qf, stream
        "segmax_launch": [_INT, _INT, _INT, _INT, _LL, _LL, _INT, _INT] + [_VOIDP] * 7,
    },
    "segmax_s8": {
        # device, B, H, npad, seg, stages, blocks, q, docs, segmax, cache, stream
        "segmax_s8_launch": [_INT, _INT, _INT, _LL, _INT, _INT, _INT] + [_VOIDP] * 5,
    },
    "topk_stream": {
        # device, storage, B, H, k, npad, n_valid, tiles_per_chunk, stages,
        # pilot_stride, pilot_tiles_per_chunk, q, docs, scales, thr, cand, vals, ids, qf,
        # stream
        "topk_stream_launch": [_INT, _INT, _INT, _INT, _INT, _LL, _LL] + [_INT] * 4
        + [_VOIDP] * 9,
    },
}


def _lib(name: str):
    lib = _build.load(name)
    if not getattr(lib, "_ttr_bound", False):
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).restype = _INT
            getattr(lib, fn).argtypes = argtypes
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [_INT]
        lib._ttr_bound = True
    return lib


def _launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call the C launcher ``fn`` of library ``name`` on ``device``'s
    current stream; raise on a non-zero CUDA error."""
    lib = _lib(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # the tensors' device (inside the with): the library carries its own runtime
        err = getattr(lib, fn)(torch.cuda.current_device(), *args, stream)
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{fn} failed: {msg}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _require_cuda(fn: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{fn} runs on cpu or cuda tensors, not {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: every tensor must be contiguous and 16-byte aligned")


def col_pad(H: int, device: torch.device) -> int:
    """Zero columns an index appends to its H-wide rows on ``device``: the
    card's scan kernels read 16-byte rows, and a zero column adds nothing
    to any score (queries are padded alike)."""
    return (-H) % _COL_TILE if device.type == "cuda" else 0


def _stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis; ties go to the lower position."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _block_queries(fn, queries, *args, **kwargs):
    """Batches beyond the kernels' 32 query rows run one call (one corpus
    pass) per block of rows; every result row depends on its query alone."""
    parts = [fn(queries[i : i + _MAX_KERNEL_B], *args, **kwargs)
             for i in range(0, queries.shape[0], _MAX_KERNEL_B)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _pad_docs(docs: torch.Tensor, tile_n: int, *extra: Tuple[torch.Tensor, float]):
    """Zero-pad rows to a multiple of ``tile_n`` (a no-op for the serving
    index, which pads once); ``extra`` pairs (per-row or per-segment
    vector, fill value) are padded alongside, in proportion."""
    n_pad = (-docs.shape[0]) % tile_n
    if not n_pad:
        return (docs, *(v for v, _ in extra))
    out = [torch.cat([docs, docs.new_zeros((n_pad, docs.shape[1]))])]
    for vec, fill in extra:
        per = docs.shape[0] // vec.shape[0]  # rows per entry: 1 or the segment width
        out.append(torch.cat([vec, vec.new_full((n_pad // per,), fill)]))
    return tuple(out)


def _check_search_args(B, H, docs, k, tile_n, seg=_SEG, phase2="rescore"):
    N = docs.shape[0]
    if docs.shape[1] != H:
        raise ValueError(f"dim mismatch: queries H={H}, docs H={docs.shape[1]}")
    if k > N:
        raise ValueError(f"k={k} larger than corpus N={N}")
    if tile_n % seg:
        raise ValueError(f"tile_n={tile_n} must be a multiple of {seg}")
    if phase2 not in ("rescore", "gather"):
        raise ValueError(f"phase2 must be 'rescore' or 'gather': {phase2!r}")


def topk_oracle(queries: torch.Tensor, docs: torch.Tensor, k: int):
    """Exact top-k by a full f32 product and a stable sort."""
    scores = torch.matmul(queries.float(), docs.float().T)
    return _stable_topk(scores, k)


# ---------------------------------------------------------------------------
# the f32 route's arithmetic (csrc/doc_mma.cuh, "The f32 path"), on the CPU
# ---------------------------------------------------------------------------


def split_scores(q: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """[B, N] f32 scores of ``q`` [B, H] against ``docs`` [N, H] (f32) as the
    f32 route forms them: ``utils/dtypes.py``'s ``matmul_split`` with the
    docs as the kernel's left operand."""
    return matmul_split(docs, q.T).T


# ---------------------------------------------------------------------------
# quantization (numpy on the host, bit for bit the JAX package's)
# ---------------------------------------------------------------------------


def quantize_segments(x: np.ndarray, seg: int = _SEG) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-SEGMENT int8 quantization: values [N, H] int8 +
    scales [N/seg] f32 with ``x[i] ~= values[i] * scales[i // seg]``.
    N must be a multiple of ``seg`` (the serving index pads rows first;
    all-zero padding segments get scale 1.0 -> values 0)."""
    x = np.asarray(x, np.float32)
    N, H = x.shape
    if N % seg:
        raise ValueError(f"rows {N} must be a multiple of segment {seg}")
    blocks = x.reshape(N // seg, seg * H)
    scales = np.abs(blocks).max(axis=1) / 127.0
    scales = np.where(scales == 0.0, 1.0, scales).astype(np.float32)
    values = np.clip(
        np.rint(x / np.repeat(scales, seg)[:, None]), -127, 127
    ).astype(np.int8)
    return values, scales


def quantize_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization: values [N, H] int8 + scales
    [N] f32 with ``x ~= values * scales[:, None]``."""
    x = np.asarray(x, np.float32)
    scales = np.abs(x).max(axis=1) / 127.0
    scales = np.where(scales == 0.0, 1.0, scales).astype(np.float32)
    values = np.clip(np.rint(x / scales[:, None]), -127, 127).astype(np.int8)
    return values, scales


def quantize_query_rows(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 query quantization: (q_i8 [B, H], scales
    [B, 1] f32). ``torch.round`` rounds half to even, as ``jnp.round``
    does. The scale is ``absmax`` times the f32 reciprocal of 127: the JAX
    package writes ``absmax / 127.0``, and XLA compiles that division by a
    constant into this product inside every jitted search. A per-row
    positive factor never changes that row's ranking, so phase-1 segment
    selection ignores the scale."""
    q32 = queries.float()
    q_absmax = q32.abs().amax(dim=1, keepdim=True)
    q_scale = torch.where(q_absmax == 0.0, torch.ones_like(q_absmax), q_absmax * _INV_127)
    q_i8 = torch.clamp(torch.round(q32 / q_scale), -127, 127).to(torch.int8)
    return q_i8, q_scale


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 operands ``a`` [..., M, H] and ``b``
    [..., H, N], converted once to f32 (round to nearest even, as XLA's
    convert of the JAX package's int32 sums). ``torch.matmul`` of int8 CPU
    tensors wraps in int8, so the CPU takes int32. A card takes f32
    products with TF32 off (as ``resolve_device`` leaves it), exact while
    every partial sum stays below 2^24, i.e. over at most 1040 columns:
    wider operands are cut into pieces of at most 1040 columns, each piece's
    exact f32 product is summed in int32 (|sum| <= 127 * 127 * H < 2^31),
    and the sum is converted once."""
    if a.device.type == "cpu":
        return torch.matmul(a.int(), b.int()).float()
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact int8 scores need TF32 off: torch.backends.cuda.matmul."
                           "allow_tf32 is set (resolve_device('cuda') clears it)")
    H = a.shape[-1]
    if H <= _F32_EXACT_H:
        return torch.matmul(a.float(), b.float())
    total = None
    for k0 in range(0, H, _F32_EXACT_H):
        part = torch.matmul(a[..., k0 : k0 + _F32_EXACT_H].float(),
                            b[..., k0 : k0 + _F32_EXACT_H, :].float()).int()
        total = part if total is None else total.add_(part)
    return total.float()


# ---------------------------------------------------------------------------
# the scans' layouts
# ---------------------------------------------------------------------------

_STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # the C launchers' codes
_ELEM = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
_SM_SMEM = 233_472  # bytes of shared memory a SM holds for its blocks
_BLOCK_RESERVED = 1_024  # of which the card reserves this much a block
_STAGE_BYTES = 128 * 128  # a stage of the ring: 128 bytes of each of a tile's 128 rows
# the kernels' __launch_bounds__ minimum blocks a SM, which they keep
# registers for: segmax four, the running top-k three (its merges hold more)
_SEGMAX_BLOCKS_PER_SM, _TOPK_BLOCKS_PER_SM = 4, 3
# Query fragments (csrc/doc_mma.cuh): a uint2 a (k16 step, n8 tile, lane),
# three of them (bf16 pieces) on the f32 route, whose stage of 128 bytes
# holds 32 columns (two k16 steps); bf16 stages hold four k16 steps, int8 ones
# eight.
_FRAG_PIECES = {torch.float32: 3, torch.bfloat16: 1, torch.int8: 1}
# Where the fragments ride the ring (always at f32), a block's shared memory
# does not grow with H; the plans stop at 65,536, about 20 times the widest
# tower the port trains (the fragments then take 12 MiB of device memory at
# 32 f32 rows, 4 MiB at bf16 or int8).
_RING_MAX_H = 1 << 16
# bf16 and int8 fragments stay resident in shared memory where that leaves
# this many blocks a SM (or as many as the ring route would): one block
# reduces or merges while another streams.
_RESIDENT_MIN_BLOCKS = 2


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _frag_stage_bytes(storage: torch.dtype, nt: int) -> int:
    """Bytes of one stage's query fragments (``frag_stage_bytes`` in
    csrc/doc_mma.cuh)."""
    return 128 // _ELEM[storage] // 16 * _FRAG_PIECES[storage] * nt * 32 * 8


def scan_layouts(B: int, H: int, storage: torch.dtype, k: int | None = None) -> list:
    """Every layout ``csrc/segmax.cu`` (``k`` None) or launch 1 of
    ``csrc/topk_stream.cu`` (the running top-k with ``k`` keys a row) can
    take for B query rows of width H over a ``storage`` corpus: each route of
    the query fragments (``query_frags``: "shared memory", resident, for bf16
    and int8; "ring", riding the ring beside each stage's rows, for every
    storage) and each ring depth (``stages`` 4, 3, 2) that fits a block's
    shared memory, as plans (see :func:`scan_plan`), with ``blocks_per_sm``
    the most a SM holds by their bytes. Empty where the kernels do not take
    the shape."""
    elem = _ELEM[storage]
    if not 1 <= B <= _MAX_KERNEL_B or not 1 <= H <= _RING_MAX_H or (H * elem) % 16:
        return []
    nt = -(-B // 8)
    chunks = -(-H * elem // 128)
    # the running top-k's lists: kept [2][B][k], fresh [B][128], thresholds
    # [B] (64-bit keys) and counts [B]; segmax: the 4 warps' column maxima
    extra = 4 * nt * 8 * 4 if k is None else B * (2 * k + 129) * 8 + _up(4 * B, 16)
    frag = _frag_stage_bytes(storage, nt)
    routes = [("ring", _STAGE_BYTES + frag, 0)]
    if storage != torch.float32:
        routes.insert(0, ("shared memory", _STAGE_BYTES, chunks * frag))
    out = []
    for route, stage, resident in routes:
        for stages in (4, 3, 2):
            smem = stages * stage + resident + extra
            if smem > _SMEM_LIMIT:
                continue
            plan = {"route": "mma", "nt": nt, "chunks": chunks, "stages": stages,
                    "k_tail": chunks * 128 // elem - H, "smem": smem, "query_frags": route}
            if route == "ring":
                plan.update(stage_bytes=stage, query_frag_bytes=chunks * frag)
            plan["blocks_per_sm"] = _per_sm(smem, k)
            out.append(plan)
    return out


def scan_plan(B: int, H: int, storage: torch.dtype, k: int | None = None):
    """The layout ``csrc/segmax.cu`` (``k`` None) or launch 1 of
    ``csrc/topk_stream.cu`` (the running top-k with ``k`` keys a row)
    takes for B query rows of width H over a ``storage`` corpus, or None
    where the kernels do not take the shape (H past ``_RING_MAX_H``).

    Every storage dtype takes ``route`` "mma" (doc_mma.cuh): tensor-core
    tiles of 128 rows fed by a ring of ``stages`` cp.async buffers (4, 3 or
    2), ``nt`` n8 tiles of queries, ``chunks`` stages of columns a row,
    ``k_tail`` zero columns past H in the last stage. The query fragments
    take one of two routes (``query_frags``). bf16 and int8 keep them
    resident in shared memory ("shared memory") where that leaves
    ``_RESIDENT_MIN_BLOCKS`` blocks a SM (or as many as the ring route
    would); elsewhere, and always at f32 (whose rows are split into three
    bf16 pieces in registers, its fragments three pieces each), they are
    written once a call into device memory (``query_frag_bytes``, the
    workspace the wrapper allocates) and ride the ring, each stage's beside
    its 16 KiB of rows (``stage_bytes``): the plan's shared memory then does
    not grow with H, so one launch takes 32 query rows at every width up to
    ``_RING_MAX_H``. Both routes give the same bits. The ring route takes
    the most blocks a SM, then the deepest ring they leave room for (on the
    card more blocks beat deeper rings there); the resident route the most
    stages that keep two blocks a SM, else the most that fit (the served
    width's layouts; ``tools/bench_f32_scans.py --layouts`` times the
    others). ``smem``: bytes a block, region by region as the .cu files lay
    them out; ``blocks_per_sm``: the blocks a SM holds by that (at most four
    for segmax, three for the running top-k: what the kernels' launch bounds
    keep registers for)."""
    layouts = scan_layouts(B, H, storage, k)
    ring = [p for p in layouts if p["query_frags"] == "ring"]
    if not ring:
        return None
    ring = max(ring, key=lambda p: (p["blocks_per_sm"], p["stages"]))
    resident = [p for p in layouts if p["query_frags"] == "shared memory"]
    if resident:  # listed from the most stages down
        resident = next((p for p in resident if p["blocks_per_sm"] >= 2), resident[0])
        if resident["blocks_per_sm"] >= min(_RESIDENT_MIN_BLOCKS, ring["blocks_per_sm"]):
            return resident
    return ring


def _per_sm(smem: int, k: int | None = None) -> int:
    """Blocks of ``smem`` bytes a SM holds at once, at most the kernel's
    launch bounds (segmax: ``k`` None)."""
    most = _SEGMAX_BLOCKS_PER_SM if k is None else _TOPK_BLOCKS_PER_SM
    return min(most, _SM_SMEM // (smem + _BLOCK_RESERVED))


# segmax_s8.cu: the deepest ring it takes, and its launch bounds' minimum
# blocks a SM
_S8_MAX_STAGES, _S8_BLOCKS_PER_SM = 8, 4


@functools.lru_cache(maxsize=None)
def s8_plan(B: int, H: int):
    """The layout ``csrc/segmax_s8.cu`` takes for B int8 query rows of width
    H, or None where none fits a block's shared memory (H past
    :func:`s8_max_h`) or the kernel does not take the shape.

    mma.sync m16n8k32 s8 tiles of 128 rows (doc_mma.cuh's s8 path) fed by a
    ring of ``stages`` cp.async buffers of 128 bytes a row (2 to 8), the
    query fragments of ``nt`` n8 tiles over ``chunks`` stages of columns in
    shared memory, ``k_tail`` zero columns past H in the last stage. The
    scan is bound by the bytes of the corpus. Each block waits at a barrier
    a stage, so a SM keeps its bytes moving through those waits by holding
    several blocks: the plan takes the most blocks a SM holds (at most what
    the kernel's launch bounds keep registers for), then the deepest ring
    that many blocks leave room for. ``in_flight``: the bytes a SM then
    keeps in flight (the stages each block has issued beyond the one it
    multiplies, times its blocks). ``smem``: bytes a block, region by
    region as ``s8_smem`` in the .cu lays them out. Cached (every int8
    search asks for it): the dict is shared, read it only."""
    if not 1 <= B <= _MAX_KERNEL_B or H < 16 or H % 16:
        return None
    nt = -(-B // 8)
    chunks = -(-H // 128)
    qfrag = chunks * 4 * nt * 32 * 8  # a uint2 a (k32 step, n tile, lane)
    red = 2 * 4 * nt * 8 * 4  # the 4 warps' integer column maxima of two tiles
    best = None
    for stages in range(2, _S8_MAX_STAGES + 1):
        smem = stages * _STAGE_BYTES + qfrag + red
        if smem > _SMEM_LIMIT:
            break
        per_sm = min(_S8_BLOCKS_PER_SM, _SM_SMEM // (smem + _BLOCK_RESERVED))
        in_flight = per_sm * (stages - 1) * _STAGE_BYTES
        if best is None or per_sm >= best["blocks_per_sm"]:
            best = {"route": "mma-s8", "nt": nt, "chunks": chunks, "stages": stages,
                    "k_tail": chunks * 128 - H, "smem": smem, "blocks_per_sm": per_sm,
                    "in_flight": in_flight}
    return best


def s8_max_h(B: int) -> int:
    """The widest H (a multiple of 16) that :func:`s8_plan` lays out at B
    query rows: two stages beside the query fragments."""
    nt = -(-B // 8)
    chunks = (_SMEM_LIMIT - 2 * _STAGE_BYTES - 2 * 4 * nt * 8 * 4) // (4 * nt * 32 * 8)
    return chunks * 128


@functools.lru_cache(maxsize=None)
def scan_max_h(storage: torch.dtype, k: int | None = None) -> int:
    """The widest H that :func:`scan_plan` lays out (at every batch: a ring
    plan's shared memory does not grow with H)."""
    step = 16 // _ELEM[storage]
    lo, hi = 0, 2 * _RING_MAX_H  # scan_plan(1, lo) fits (or lo is 0); hi does not
    while hi - lo > step:
        mid = (lo + hi) // 2 // step * step
        lo, hi = (mid, hi) if scan_plan(1, mid, storage, k) else (lo, mid)
    return lo


def query_blocks(fn: str, B: int, H: int, storage: torch.dtype, k: int | None = None):
    """The launches of a scan of B query rows (1..32) at width H: a list of
    (first row, rows, plan). Every B up to 32 takes one launch at every
    width up to :func:`scan_max_h` (its query fragments riding the ring
    where they do not stay resident). Raises a ``ValueError`` naming the
    widest H before any launch past it."""
    plan = scan_plan(B, H, storage, k)
    if plan is None:
        raise ValueError(f"{fn}: no layout of the kernel takes B={B} H={H} {storage}"
                         + ("" if k is None else f" k={k}")
                         + f": it takes H up to {scan_max_h(storage, k)}")
    return [(0, B, plan)]


def _query_frag_workspace(plan: dict, device: torch.device) -> torch.Tensor | None:
    """The device memory of a plan's query fragments where they ride the
    ring (written by the launch's first kernel), None where they stay
    resident."""
    nbytes = plan.get("query_frag_bytes")
    return None if nbytes is None else torch.empty(nbytes, dtype=torch.uint8, device=device)


def _blocks(plan: dict, sms: int, work: int) -> int:
    """Persistent blocks for ``work`` tiles: as many as ``sms`` SMs hold at
    once by the plan, at most one a tile."""
    return max(1, min(work, plan["blocks_per_sm"] * sms))


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def topk_stream_grid(plan: dict, B: int, tiles: int, sms: int) -> dict:
    """The running top-k's launches over ``tiles`` 128-row tiles on a card
    of ``sms`` SMs: ``per_chunk`` tiles a block of launch 1, and, where it
    pays (``_PILOT_MIN_TILES`` tiles, ``_PILOT_MIN_B`` query rows), a pilot
    over every ``stride``-th tile, ``pilot_per_chunk`` a block (stride 1: no
    pilot); ``grid``: the larger launch's blocks (the workspace's rows)."""
    per_chunk = -(-tiles // _blocks(plan, sms, tiles))
    stride = _PILOT_STRIDE if tiles >= _PILOT_MIN_TILES and B >= _PILOT_MIN_B else 1
    sample = -(-tiles // stride)  # the pilot's tiles
    pilot_per_chunk = -(-sample // _blocks(plan, sms, sample))
    grid = max(-(-tiles // per_chunk), -(-sample // pilot_per_chunk))
    return {"per_chunk": per_chunk, "stride": stride, "pilot_per_chunk": pilot_per_chunk,
            "grid": grid}


# ---------------------------------------------------------------------------
# phase-1 kernels and their plain versions
# ---------------------------------------------------------------------------


def segmax(
    q: torch.Tensor, docs: torch.Tensor, n_valid: int, with_cache: bool = False
) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """Phase 1: ([S, B] segment maxima, [Npad, B] scores or None).

    ``q`` [B, H] and ``docs`` [Npad, H] share the storage dtype; Npad is a
    multiple of 128. CUDA tensors launch the kernel (1..32 query rows in one
    launch, :func:`query_blocks`), CPU tensors run
    :func:`segmax_reference`."""
    B, H = q.shape
    npad = docs.shape[0]
    if docs.shape[1] != H or npad % _SEG:
        raise ValueError(f"docs must be [Npad % {_SEG} == 0, {H}], got {tuple(docs.shape)}")
    if q.dtype != docs.dtype or q.device != docs.device:
        raise ValueError(
            f"q ({q.dtype}, {q.device}) and docs ({docs.dtype}, {docs.device}) must match"
        )
    if docs.device.type == "cpu":
        return segmax_reference(q, docs, n_valid, with_cache)
    if docs.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"storage dtype must be bfloat16 or float32, got {docs.dtype}")
    if not 1 <= B <= _MAX_KERNEL_B:
        raise ValueError(f"the kernel takes 1..{_MAX_KERNEL_B} query rows, got {B}")
    if H % (8 if docs.dtype == torch.bfloat16 else 4):
        raise ValueError(f"the kernel needs 16-byte doc rows; H={H} with {docs.dtype}")
    ((_, _, plan),) = query_blocks("segmax", B, H, docs.dtype)
    q = q.contiguous()
    _require_cuda("segmax", q, docs)
    out = torch.empty((npad // _SEG, B), dtype=torch.float32, device=docs.device)
    cache = torch.empty((npad, B), dtype=torch.float32, device=docs.device) if with_cache else None
    qf = _query_frag_workspace(plan, docs.device)
    _launch("segmax", "segmax_launch", docs.device, _STORAGE[docs.dtype], B, H, npad,
            int(n_valid), plan["stages"], _blocks(plan, _sms(docs.device), npad // _SEG),
            q.data_ptr(), docs.data_ptr(), None, out.data_ptr(), _ptr(cache), _ptr(qf))
    segmax.launches += 1
    return out, cache


segmax.launches = 0  # kernel launches, counted where the kernel is launched


def segmax_reference(
    q: torch.Tensor, docs: torch.Tensor, n_valid: int, with_cache: bool = False
):
    """Plain PyTorch phase 1: full [Npad, B] f32 scores, mask, segment max."""
    scores = torch.matmul(docs.float(), q.float().T)  # [Npad, B]
    return _mask_rows_segmax(scores, n_valid, with_cache)


def _mask_rows_segmax(scores: torch.Tensor, n_valid: int, with_cache: bool):
    rows = torch.arange(scores.shape[0], device=scores.device)[:, None]
    scores = torch.where(rows < n_valid, scores, torch.full_like(scores, NEG_INF))
    seg = scores.reshape(-1, _SEG, scores.shape[1]).amax(dim=1)
    return seg, (scores if with_cache else None)


def segmax_int8(
    q: torch.Tensor, doc_values: torch.Tensor, doc_scales: torch.Tensor, n_valid: int
) -> torch.Tensor:
    """Phase 1 over the per-row int8 corpus: [S, B] maxima of
    ``(q . v) * scale`` per 128-row segment, rows >= ``n_valid`` NEG_INF.

    ``q`` [B, H] bf16, ``doc_values`` [Npad, H] int8, ``doc_scales``
    [Npad] f32. CUDA tensors launch the kernel (1..32 query rows in one
    launch, :func:`query_blocks`), CPU tensors run
    :func:`segmax_int8_reference`."""
    B, H = q.shape
    npad = doc_values.shape[0]
    if doc_values.shape[1] != H or npad % _SEG or doc_scales.shape != (npad,):
        raise ValueError(f"doc_values must be [Npad % {_SEG} == 0, {H}] with [Npad] scales")
    if (q.dtype, doc_values.dtype, doc_scales.dtype) != (torch.bfloat16, torch.int8,
                                                          torch.float32):
        raise ValueError("segmax_int8 takes bf16 queries, int8 values and f32 scales")
    if not q.device == doc_values.device == doc_scales.device:
        raise ValueError("q, doc_values and doc_scales must share a device")
    if doc_values.device.type == "cpu":
        return segmax_int8_reference(q, doc_values, doc_scales, n_valid)
    if not 1 <= B <= _MAX_KERNEL_B:
        raise ValueError(f"the kernel takes 1..{_MAX_KERNEL_B} query rows, got {B}")
    if H % 16:
        raise ValueError(f"the kernel needs 16-byte doc rows; H={H} with int8")
    ((_, _, plan),) = query_blocks("segmax_int8", B, H, torch.int8)
    q = q.contiguous()
    _require_cuda("segmax_int8", q, doc_values, doc_scales)
    out = torch.empty((npad // _SEG, B), dtype=torch.float32, device=q.device)
    qf = _query_frag_workspace(plan, q.device)
    _launch("segmax", "segmax_launch", q.device, _STORAGE[torch.int8], B, H, npad,
            int(n_valid), plan["stages"], _blocks(plan, _sms(q.device), npad // _SEG),
            q.data_ptr(), doc_values.data_ptr(), doc_scales.data_ptr(), out.data_ptr(),
            None, _ptr(qf))
    segmax_int8.launches += 1
    return out


segmax_int8.launches = 0


def segmax_int8_reference(q, doc_values, doc_scales, n_valid: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`segmax_int8`: int8 values and bf16
    queries upcast to f32 (exactly), f32 product, times the row scale."""
    scores = torch.matmul(doc_values.float(), q.float().T) * doc_scales[:, None]
    return _mask_rows_segmax(scores, n_valid, False)[0]


def segmax_s8(
    q_i8: torch.Tensor, doc_values: torch.Tensor, seg: int = _SEG, with_cache: bool = False
) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """Phase 1 of int8 serving: ([Npad/seg, B] f32 maxima of the exact
    integer scores ``doc_values . q_i8^T`` per ``seg``-row segment,
    [Npad, B] f32 scores or None). No padding mask.

    ``q_i8`` [B, H] and ``doc_values`` [Npad, H] int8. CUDA tensors launch
    the kernel (1..32 query rows, H a multiple of 16 up to
    :func:`s8_max_h` (6144 at 32 rows), Npad a multiple of 128, seg
    32/64/128); CPU tensors run :func:`segmax_s8_reference`. Both give
    the same bits at every width."""
    B, H = q_i8.shape
    npad = doc_values.shape[0]
    if doc_values.shape[1] != H or npad % seg:
        raise ValueError(f"doc_values must be [Npad % {seg} == 0, {H}], got "
                         f"{tuple(doc_values.shape)}")
    if q_i8.dtype != torch.int8 or doc_values.dtype != torch.int8:
        raise ValueError("segmax_s8 takes int8 queries and int8 doc values")
    if q_i8.device != doc_values.device:
        raise ValueError("q_i8 and doc_values must share a device")
    if doc_values.device.type == "cpu":
        return segmax_s8_reference(q_i8, doc_values, seg, with_cache)
    if not 1 <= B <= _MAX_KERNEL_B:
        raise ValueError(f"the kernel takes 1..{_MAX_KERNEL_B} query rows, got {B}")
    if H < 16 or H % 16:
        raise ValueError(f"the kernel takes H a multiple of 16, got {H}")
    if seg not in _S8_SEGS or npad % _SEG:
        raise ValueError(f"the kernel takes seg in {_S8_SEGS} and Npad % {_SEG} == 0")
    plan = s8_plan(B, H)
    if plan is None:
        raise ValueError(f"segmax_s8: no layout of the kernel fits a block's shared memory at "
                         f"B={B} H={H}: it takes H up to {s8_max_h(B)} at B={B}")
    q_i8 = q_i8.contiguous()
    _require_cuda("segmax_s8", q_i8, doc_values)
    out = torch.empty((npad // seg, B), dtype=torch.float32, device=q_i8.device)
    cache = torch.empty((npad, B), dtype=torch.float32, device=q_i8.device) if with_cache else None
    _launch("segmax_s8", "segmax_s8_launch", q_i8.device, B, H, npad, seg, plan["stages"],
            _blocks(plan, _sms(q_i8.device), npad // _SEG), q_i8.data_ptr(),
            doc_values.data_ptr(), out.data_ptr(), _ptr(cache))
    segmax_s8.launches += 1
    return out, cache


segmax_s8.launches = 0


def segmax_s8_reference(q_i8, doc_values, seg: int = _SEG, with_cache: bool = False):
    """Plain PyTorch version of :func:`segmax_s8`: the exact integer
    scores converted to f32 (:func:`_int_matmul`), segment max, no mask.
    The kernel takes the max on the integers and converts after; rounding
    is monotone, so both give the same bits."""
    scores = _int_matmul(doc_values, q_i8.T)  # [Npad, B]
    return scores.reshape(-1, seg, scores.shape[1]).amax(dim=1), (scores if with_cache else None)


# ---------------------------------------------------------------------------
# phase 2 (plain torch)
# ---------------------------------------------------------------------------


def _select_segments(segmax_bs: torch.Tensor, k_seg: int, sort_candidates: bool):
    """Winning segments per query row: [B, S] maxima -> [B, k_seg] ids.

    Without ``sort_candidates`` the ids keep the rank order of their
    maxima (ties to the lower segment id, as ``lax.top_k`` orders them);
    with it they are in ascending id order. The final stable selection
    breaks exact score ties by candidate position, so the two layouts can
    resolve a bitwise tie at the k boundary differently, exactly as they
    do in the JAX package."""
    _, seg_idx = _stable_topk(segmax_bs, k_seg)
    if sort_candidates:
        seg_idx = torch.sort(seg_idx, dim=-1).values
    return seg_idx


def _gather_cached_scores(sc_full: torch.Tensor, seg_idx: torch.Tensor, seg: int):
    """Phase 2, gather form: the winning segments' scores from the phase-1
    cache ([Npad, B] f32). Returns [B, k_seg, seg] f32."""
    B = sc_full.shape[1]
    sc3 = sc_full.reshape(-1, seg, B)  # [S, seg, B]
    cols = torch.arange(B, device=sc_full.device)[:, None, None]
    rows = torch.arange(seg, device=sc_full.device)[None, None, :]
    return sc3[seg_idx[:, :, None], rows, cols]


def _winning_rows(docs_padded: torch.Tensor, seg_idx: torch.Tensor, seg: int):
    """[B, k_seg * seg, H] rows of the winning segments."""
    H = docs_padded.shape[1]
    return docs_padded.reshape(-1, seg, H)[seg_idx].reshape(seg_idx.shape[0], -1, H)


def _rescore(q: torch.Tensor, docs_padded: torch.Tensor, seg_idx: torch.Tensor):
    """Phase 2, re-score form: the winning segments' rows times the query,
    with phase 1's arithmetic. torch.matmul on bf16 would round the scores
    to bf16 (JAX asks for f32 results), so the storage-dtype operands are
    upcast to f32 (exactly) and multiplied in f32 with TF32 off."""
    blocks = _winning_rows(docs_padded, seg_idx, _SEG).float()  # [B, k_seg*SEG, H]
    scores = torch.bmm(blocks, q.float()[:, :, None])[..., 0]
    return scores.reshape(q.shape[0], seg_idx.shape[1], _SEG)


def _candidate_union_topk(scores, seg_idx, seg, n_valid, k):
    """Final top-k over the candidate union: mask padding ids, stable
    top-k over candidates in ascending id order, map positions back to doc
    ids (padding with -1 / NEG_INF when k exceeds the candidates)."""
    B = scores.shape[0]
    gids = seg_idx[..., None] * seg + torch.arange(seg, device=scores.device)[None, None, :]
    scores = torch.where(gids < n_valid, scores, torch.full_like(scores, NEG_INF)).reshape(B, -1)
    gids = gids.reshape(B, -1)
    k_eff = min(k, scores.shape[1])
    vals, pos = _stable_topk(scores, k_eff)
    ids = torch.gather(gids, 1, pos).to(torch.int32)
    if k_eff < k:
        vals = torch.nn.functional.pad(vals, (0, k - k_eff), value=NEG_INF)
        ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=-1)
    return vals, torch.where(vals <= NEG_INF, torch.full_like(ids, -1), ids)


def _segmax_phase2(segmax_sb, q, docs_padded, n_valid, k, *, scales=None, sc_full=None,
                   sort_candidates=False):
    """Pick the k winning segments per row, gather or re-score them (times
    the per-row dequant ``scales`` of the int8 corpus), final top-k."""
    with annotate("ttr.search.phase2"):
        S = segmax_sb.shape[0]
        k_seg = min(k, S)
        seg_idx = _select_segments(segmax_sb.T, k_seg, sort_candidates)  # [B, k_seg]
        if sc_full is not None:
            scores = _gather_cached_scores(sc_full, seg_idx, _SEG)
        else:
            scores = _rescore(q, docs_padded, seg_idx)
        if scales is not None:
            scores = scores * scales.reshape(S, _SEG)[seg_idx]
        return _candidate_union_topk(scores, seg_idx, _SEG, n_valid, k)


def s8_phase2(segmax_sb, cache, q_i8, q_scale, doc_values, seg_scales, k, n_valid, seg,
              sort_candidates=False):
    """Phases 1.5 and 2 of :func:`fused_topk_segmax_s8`, given phase 1's
    outputs (from the kernel or its plain version).

    Phase 1.5 dequantizes the [S, B] integer maxima with the segment
    scales and sets to NEG_INF only the segments wholly in padding; the
    one partially padded segment stays (its zero rows can only inflate its
    maximum, pushing each real segment down one rank at most), so k + 1
    segments cover the top k. Phase 2 gathers their cached scores or
    re-scores them under the same quantized metric, dequantizes in the JAX
    package's order (``scores * seg_scale * q_scale``) and masks by
    ``n_valid``."""
    with annotate("ttr.search.phase2"):
        S = segmax_sb.shape[0]
        s_valid = (n_valid + seg - 1) // seg
        maxima = segmax_sb * seg_scales[:, None]  # [S, B]
        rows = torch.arange(S, device=maxima.device)[:, None]
        maxima = torch.where(rows < s_valid, maxima, torch.full_like(maxima, NEG_INF))
        k_seg = min(k + 1, S)
        seg_idx = _select_segments(maxima.T, k_seg, sort_candidates)  # [B, k_seg]
        if cache is not None:
            scores_f = _gather_cached_scores(cache, seg_idx, seg)
        else:
            blocks = _winning_rows(doc_values, seg_idx, seg)  # [B, k_seg*seg, H] int8
            scores_f = _int_matmul(blocks, q_i8[:, :, None])[..., 0]
            scores_f = scores_f.reshape(q_i8.shape[0], k_seg, seg)
        scores = scores_f * seg_scales[seg_idx][..., None] * q_scale[:, :, None]
        return _candidate_union_topk(scores, seg_idx, seg, n_valid, k)


# ---------------------------------------------------------------------------
# the segment-max searches
# ---------------------------------------------------------------------------


def fused_topk_segmax(
    queries: torch.Tensor,  # [B, H]
    docs: torch.Tensor,  # [N, H], scored in its storage dtype
    k: int = 50,
    tile_n: int = 8192,
    n_valid=None,  # true corpus size when docs already carries padding rows
    phase2: str = "rescore",  # "rescore" | "gather" (score-cache phase 1)
    sort_candidates: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k: ([B, k] f32 scores, [B, k] int32 doc ids), sorted
    descending, ids -1 where fewer than k real docs exist.

    Rows are zero-padded to a multiple of ``tile_n`` (the serving index
    pads once at construction, so this is a no-op there). Batches beyond
    the kernel's 32 query rows run one scan per block of queries; beyond
    32 rows phase 2 always re-scores, as in the JAX package."""
    B, H = queries.shape
    _check_search_args(B, H, docs, k, tile_n, phase2=phase2)
    if B > _MAX_KERNEL_B:
        return _block_queries(fused_topk_segmax, queries, docs, k=k, tile_n=tile_n,
                              n_valid=n_valid, phase2="rescore",
                              sort_candidates=sort_candidates)
    n_valid = docs.shape[0] if n_valid is None else int(n_valid)
    (docs,) = _pad_docs(docs, tile_n)
    q = queries.to(docs.dtype)
    seg, sc_full = segmax(q, docs, n_valid, with_cache=phase2 == "gather")
    return _segmax_phase2(seg, q, docs, n_valid, k, sc_full=sc_full,
                          sort_candidates=sort_candidates)


def fused_topk_segmax_int8(
    queries: torch.Tensor,  # [B, H] float
    doc_values: torch.Tensor,  # [N, H] int8 (quantize_rows)
    doc_scales: torch.Tensor,  # [N] f32
    k: int = 50,
    tile_n: int = 8192,
    n_valid=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the per-row int8 corpus under the metric
    ``(q_bf16 . v) * scale``: :func:`segmax_int8` + the re-scoring phase
    2. Same results contract as :func:`fused_topk_segmax`."""
    B, H = queries.shape
    _check_search_args(B, H, doc_values, k, tile_n)
    if B > _MAX_KERNEL_B:
        return _block_queries(fused_topk_segmax_int8, queries, doc_values, doc_scales, k=k,
                              tile_n=tile_n, n_valid=n_valid)
    n_valid = doc_values.shape[0] if n_valid is None else int(n_valid)
    doc_values, doc_scales = _pad_docs(doc_values, tile_n, (doc_scales, 0.0))
    q = queries.to(torch.bfloat16)
    seg = segmax_int8(q, doc_values, doc_scales, n_valid)
    return _segmax_phase2(seg, q, doc_values, n_valid, k, scales=doc_scales)


def fused_topk_segmax_s8(
    queries: torch.Tensor,  # [B, H] float
    doc_values: torch.Tensor,  # [N, H] int8, per-SEGMENT quantized
    seg_scales: torch.Tensor,  # [N / seg] f32 (quantize_segments)
    k: int = 50,
    tile_n: int = 8192,
    n_valid=None,  # true corpus size when docs carry zero-padding rows
    seg: int = _SEG,  # covering-segment width of the quantized index
    phase2: str = "rescore",  # "rescore" | "gather" (score-cache phase 1)
    sort_candidates: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the per-segment int8 index under the doubly
    quantized metric ``(q_i8 . d_i8) * scale_seg * scale_q``: the queries
    are quantized per row (:func:`quantize_query_rows`), :func:`segmax_s8`
    scans the corpus, and :func:`s8_phase2` selects and re-scores.
    ``phase2="gather"`` reads phase 1's [Npad, B] score cache instead of
    re-scoring; both give the same bits. Values and ids equal the JAX
    package's ``fused_topk_segmax_s8`` and :func:`topk_segmented_s8`."""
    B, H = queries.shape
    N = doc_values.shape[0]
    _check_search_args(B, H, doc_values, k, tile_n, seg=seg, phase2=phase2)
    if N % seg or N // seg != seg_scales.shape[0]:
        raise ValueError(f"per-segment index malformed: N={N}, scales={seg_scales.shape[0]}")
    if B > _MAX_KERNEL_B:
        return _block_queries(fused_topk_segmax_s8, queries, doc_values, seg_scales, k=k,
                              tile_n=tile_n, n_valid=n_valid, seg=seg, phase2="rescore",
                              sort_candidates=sort_candidates)
    n_valid = N if n_valid is None else int(n_valid)
    # tile padding adds whole all-zero segments, scale 1 (masked in phase 1.5)
    doc_values, seg_scales = _pad_docs(doc_values, tile_n, (seg_scales, 1.0))
    q_i8, q_scale = quantize_query_rows(queries)
    maxima, cache = segmax_s8(q_i8, doc_values, seg, with_cache=phase2 == "gather")
    return s8_phase2(maxima, cache, q_i8, q_scale, doc_values, seg_scales, k, n_valid, seg,
                     sort_candidates)


# ---------------------------------------------------------------------------
# the two-phase path over a full [B, N] product
# ---------------------------------------------------------------------------


def _mask_invalid(scores: torch.Tensor, n_valid) -> torch.Tensor:
    """NEG_INF out score columns >= n_valid (zero-padded corpus rows)."""
    if n_valid is None:
        return scores
    cols = torch.arange(scores.shape[1], device=scores.device)[None, :]
    return torch.where(cols < n_valid, scores, torch.full_like(scores, NEG_INF))


def _segmented_topk_from_scores(scores: torch.Tensor, k: int, segment: int):
    """Segment-max covering top-k over a dense [B, N] score matrix: the
    segment holding the true i-th value has segment-max >= v_i, and fewer
    than i other segments can have a larger max, so the top-k segments
    (by max) always cover the true top-k elements."""
    B = scores.shape[0]
    n_pad = (-scores.shape[1]) % segment
    if n_pad:
        scores = torch.nn.functional.pad(scores, (0, n_pad), value=NEG_INF)
    S = scores.shape[1] // segment
    seg_scores = scores.reshape(B, S, segment)
    k_seg = min(k, S)
    _, seg_idx = _stable_topk(seg_scores.amax(dim=-1), k_seg)  # [B, k_seg]
    cand = torch.gather(seg_scores, 1, seg_idx[..., None].expand(-1, -1, segment))
    cand_ids = seg_idx[..., None] * segment + torch.arange(segment, device=scores.device)
    vals, loc = _stable_topk(cand.reshape(B, -1), k)
    ids = torch.gather(cand_ids.reshape(B, -1), 1, loc).to(torch.int32)
    # padding never wins (scores NEG_INF), but guard ids anyway
    return vals, torch.where(vals <= NEG_INF, torch.full_like(ids, -1), ids)


def topk_segmented(queries, docs, k: int = 50, segment: int = 128, n_valid=None):
    """Exact top-k via the segment-max covering argument over one [B, N]
    product (queries cast to the storage dtype, f32 sums)."""
    if k > docs.shape[0]:
        raise ValueError(f"k={k} larger than corpus N={docs.shape[0]}")
    scores = torch.matmul(queries.to(docs.dtype).float(), docs.float().T)  # [B, N]
    return _segmented_topk_from_scores(_mask_invalid(scores, n_valid), k, segment)


def topk_segmented_s8(queries, doc_values, seg_scales, k: int = 50, n_valid=None,
                      seg: int = _SEG):
    """Two-phase path over the per-segment int8 index: the SAME doubly
    quantized metric as :func:`fused_topk_segmax_s8`, so the two agree in
    every bit. Materializes the [B, N] scores."""
    N = doc_values.shape[0]
    if k > N:
        raise ValueError(f"k={k} larger than corpus N={N}")
    if N % seg or N // seg != seg_scales.shape[0]:
        raise ValueError(f"per-segment index malformed: N={N}")
    q_i8, q_scale = quantize_query_rows(queries)
    scores = _int_matmul(q_i8, doc_values.T)  # [B, N]
    scores = scores * seg_scales.repeat_interleave(seg)[None, :] * q_scale
    return _segmented_topk_from_scores(_mask_invalid(scores, n_valid), k, seg)


def topk_segmented_int8(queries, doc_values, doc_scales, k: int = 50, segment: int = 128,
                        n_valid=None):
    """Two-phase path over the per-row int8 corpus: bf16 queries times the
    int8 values in f32, times the row scale."""
    if k > doc_values.shape[0]:
        raise ValueError(f"k={k} larger than corpus N={doc_values.shape[0]}")
    scores = torch.matmul(queries.to(torch.bfloat16).float(), doc_values.float().T)
    scores = scores * doc_scales[None, :]
    return _segmented_topk_from_scores(_mask_invalid(scores, n_valid), k, segment)


# ---------------------------------------------------------------------------
# the running top-k (fused_topk, fused_topk_int8)
# ---------------------------------------------------------------------------


def _topk_stream_call(wrapper, q, docs, scales, k: int, n_valid: int):
    """Launch ``csrc/topk_stream.cu`` (chunk kernel + merge kernel) once,
    counting the launch on ``wrapper``."""
    B, H = q.shape
    npad = docs.shape[0]
    if not 1 <= B <= _MAX_KERNEL_B:
        raise ValueError(f"the kernel takes 1..{_MAX_KERNEL_B} query rows, got {B}")
    if not 1 <= k <= _TOPK_MAX_K:
        raise ValueError(f"the kernel holds k in 1..{_TOPK_MAX_K}, got {k}")
    if (H * docs.element_size()) % 16:
        raise ValueError(f"the kernel needs 16-byte doc rows; H={H} with {docs.dtype}")
    if npad % _SEG or not _SEG <= npad < 2 ** 31:
        raise ValueError(f"the kernel needs Npad a multiple of {_SEG} below 2^31, got {npad}")
    ((_, _, plan),) = query_blocks(wrapper.__name__, B, H, docs.dtype, k)
    q = q.contiguous()
    _require_cuda(wrapper.__name__, q, docs, *([] if scales is None else [scales]))
    grid = topk_stream_grid(plan, B, npad // _SEG, _sms(docs.device))
    thr = torch.zeros((B,), dtype=torch.int64, device=docs.device)  # the shared thresholds
    cand = torch.empty((grid["grid"], B, k), dtype=torch.int64, device=docs.device)
    vals = torch.empty((B, k), dtype=torch.float32, device=docs.device)
    ids = torch.empty((B, k), dtype=torch.int32, device=docs.device)
    qf = _query_frag_workspace(plan, docs.device)
    _launch("topk_stream", "topk_stream_launch", docs.device, _STORAGE[docs.dtype], B, H, k,
            npad, int(n_valid), grid["per_chunk"], plan["stages"], grid["stride"],
            grid["pilot_per_chunk"], q.data_ptr(), docs.data_ptr(), _ptr(scales),
            thr.data_ptr(), cand.data_ptr(), vals.data_ptr(), ids.data_ptr(), _ptr(qf))
    wrapper.launches += 1
    return vals, ids


def topk_stream(q: torch.Tensor, docs: torch.Tensor, k: int, n_valid: int):
    """Running top-k: ([B, k] f32 values, [B, k] int32 ids) of ``q . d``
    over rows < ``n_valid``, descending, ties to the lower id, NEG_INF /
    -1 beyond the valid rows. ``q`` and ``docs`` share the storage dtype
    (bf16 or f32); Npad is a multiple of 128. CUDA tensors launch the
    kernel (1..32 query rows in one launch, :func:`query_blocks`; k <=
    128), CPU tensors run :func:`topk_stream_reference`."""
    if q.dtype != docs.dtype or q.device != docs.device or q.shape[1] != docs.shape[1]:
        raise ValueError("q and docs must share dtype, device and width")
    if docs.device.type == "cpu":
        return topk_stream_reference(q, docs, k, n_valid)
    if docs.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"storage dtype must be bfloat16 or float32, got {docs.dtype}")
    return _topk_stream_call(topk_stream, q, docs, None, k, n_valid)


topk_stream.launches = 0


def topk_stream_int8(q: torch.Tensor, doc_values: torch.Tensor, doc_scales: torch.Tensor,
                     k: int, n_valid: int):
    """:func:`topk_stream` over the per-row int8 corpus: ``q`` [B, H] bf16,
    ``doc_values`` [Npad, H] int8, ``doc_scales`` [Npad] f32; each score
    is ``(q . v) * scale``."""
    if (q.dtype, doc_values.dtype, doc_scales.dtype) != (torch.bfloat16, torch.int8,
                                                          torch.float32):
        raise ValueError("topk_stream_int8 takes bf16 queries, int8 values and f32 scales")
    if not q.device == doc_values.device == doc_scales.device:
        raise ValueError("q, doc_values and doc_scales must share a device")
    if q.shape[1] != doc_values.shape[1] or doc_scales.shape != (doc_values.shape[0],):
        raise ValueError("doc_values must be [Npad, H] with [Npad] scales")
    if doc_values.device.type == "cpu":
        return topk_stream_reference(q, doc_values, k, n_valid, doc_scales)
    return _topk_stream_call(topk_stream_int8, q, doc_values, doc_scales, k, n_valid)


topk_stream_int8.launches = 0


def topk_stream_reference(q, docs, k: int, n_valid: int, scales=None):
    """Plain PyTorch version of :func:`topk_stream` (and, with ``scales``,
    of :func:`topk_stream_int8`): the full [B, Npad] f32 product, masked,
    stable-sorted."""
    scores = torch.matmul(q.float(), docs.float().T)  # [B, Npad]
    if scales is not None:
        scores = scores * scales[None, :]
    vals, ids = _stable_topk(_mask_invalid(scores, n_valid), k)
    ids = ids.to(torch.int32)
    return vals, torch.where(vals <= NEG_INF, torch.full_like(ids, -1), ids)


def fused_topk(queries, docs, k: int = 50, tile_n: int = 8192, n_valid=None):
    """Streaming exact top-k: ([B, k] f32 values, [B, k] int32 ids), sorted
    descending, ties to the lower id; the queries are cast to the storage
    dtype. Rows are zero-padded to a multiple of ``tile_n`` (a multiple of
    128) and masked by ``n_valid``."""
    B, H = queries.shape
    _check_search_args(B, H, docs, k, tile_n)
    if B > _MAX_KERNEL_B:
        return _block_queries(fused_topk, queries, docs, k=k, tile_n=tile_n, n_valid=n_valid)
    n_valid = docs.shape[0] if n_valid is None else int(n_valid)
    (docs,) = _pad_docs(docs, tile_n)
    return topk_stream(queries.to(docs.dtype), docs, k, n_valid)


def fused_topk_int8(queries, doc_values, doc_scales, k: int = 50, tile_n: int = 8192,
                    n_valid=None):
    """:func:`fused_topk` over the per-row int8 corpus: bf16 queries times
    the int8 values summed in f32, times the row scale."""
    B, H = queries.shape
    _check_search_args(B, H, doc_values, k, tile_n)
    if B > _MAX_KERNEL_B:
        return _block_queries(fused_topk_int8, queries, doc_values, doc_scales, k=k,
                              tile_n=tile_n, n_valid=n_valid)
    n_valid = doc_values.shape[0] if n_valid is None else int(n_valid)
    doc_values, doc_scales = _pad_docs(doc_values, tile_n, (doc_scales, 0.0))
    return topk_stream_int8(queries.to(torch.bfloat16), doc_values, doc_scales, k, n_valid)


# ---------------------------------------------------------------------------
# bytes and operations of one kernel call (each input read once, each
# output written once), for the bounds chip_smoke.py reports
# ---------------------------------------------------------------------------


def segmax_bound(B: int, H: int, npad: int, storage_bytes: int):
    """Phase 1 without the score cache. Returns (bytes, flops)."""
    nbytes = npad * H * storage_bytes + B * H * storage_bytes + (npad // _SEG) * B * 4
    return nbytes, 2 * B * H * npad


def segmax_int8_bound(B: int, H: int, npad: int):
    """:func:`segmax_int8`: int8 rows, f32 scales, bf16 queries. Returns
    (bytes, bf16 flops)."""
    return npad * (H + 4) + B * H * 2 + (npad // _SEG) * B * 4, 2 * B * H * npad


def segmax_s8_bound(B: int, H: int, npad: int, seg: int, with_cache: bool = False):
    """:func:`segmax_s8`. Returns (bytes, int8 operations)."""
    nbytes = npad * H + B * H + (npad // seg) * B * 4 + (npad * B * 4 if with_cache else 0)
    return nbytes, 2 * B * H * npad


def topk_stream_bound(B: int, H: int, npad: int, k: int, storage_bytes: int,
                      scaled: bool = False):
    """:func:`topk_stream` (``scaled``: :func:`topk_stream_int8`, bf16
    queries and f32 row scales). Returns (bytes, flops)."""
    q_bytes = 2 if scaled else storage_bytes
    nbytes = npad * H * storage_bytes + (npad * 4 if scaled else 0) + B * H * q_bytes + B * k * 8
    return nbytes, 2 * B * H * npad
