"""Exact top-k retrieval: segment-max scan (CUDA kernel) + torch phase 2.

:func:`fused_topk_segmax` is the port of the JAX package's function of the
same name (``ops/topk.py``). Phase 1 scores every doc row against the
queries in the storage dtype with f32 sums, masks rows >= ``n_valid``
with ``NEG_INF`` and keeps only the maximum of each 128-row segment
([S, B] f32), plus optionally every masked score ([Npad, B] f32,
``phase2="gather"``). On a CUDA tensor phase 1 is ``csrc/segmax.cu``; on a
CPU tensor it is :func:`segmax_reference`. Phase 2 is plain torch: the k
segments with the largest maxima per query cover the true top-k (the
segment holding the i-th best score has a maximum >= it, and fewer than i
other segments can beat that), so re-scoring (or gathering) those
k * 128 candidates and taking their top-k is exact.

Ties: ``lax.top_k`` breaks ties toward the lower index and ``torch.topk``
on CUDA promises no order. Every selection here is a stable descending
sort, so each breaks ties by position as ``lax.top_k`` does. The final one
runs over the candidates in the layout ``sort_candidates`` picks (see
:func:`_select_segments`), the same as the JAX package's, so even a
bitwise tie at the k boundary resolves as there.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from twotowermlretrieval_tpu_torch.ops import _build

NEG_INF = float(-3.0e38)  # fits f32; safer than -inf for max/compare chains
_SEG = 128  # covering-segment width; int8 index files of the JAX package use it too
# The kernel holds at most this many query rows (in registers and shared
# memory); larger batches run one corpus pass per block of queries.
_MAX_KERNEL_B = 32

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong


def _lib():
    lib = _build.load("segmax")
    if not getattr(lib, "_ttr_bound", False):
        lib.segmax_launch.restype = _INT
        lib.segmax_launch.argtypes = [
            _INT, _INT, _INT, _INT, _LL, _LL,  # device, is_bf16, B, H, npad, n_valid
            _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,  # q, docs, segmax, cache, stream
        ]
        lib.segmax_error_string.restype = ctypes.c_char_p
        lib.segmax_error_string.argtypes = [_INT]
        lib._ttr_bound = True
    return lib


def _stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis; ties go to the lower position."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_oracle(queries: torch.Tensor, docs: torch.Tensor, k: int):
    """Exact top-k by a full f32 product and a stable sort."""
    scores = torch.matmul(queries.float(), docs.float().T)
    return _stable_topk(scores, k)


def segmax(
    q: torch.Tensor, docs: torch.Tensor, n_valid: int, with_cache: bool = False
) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """Phase 1: ([S, B] segment maxima, [Npad, B] scores or None).

    ``q`` [B, H] and ``docs`` [Npad, H] share the storage dtype; Npad is a
    multiple of 128. CUDA tensors launch the kernel (at most 32 query rows),
    CPU tensors run :func:`segmax_reference`."""
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
    if docs.device.type != "cuda":
        raise ValueError(f"segmax runs on cpu or cuda tensors, not {docs.device}")
    if docs.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"storage dtype must be bfloat16 or float32, got {docs.dtype}")
    if not 1 <= B <= _MAX_KERNEL_B:
        raise ValueError(f"the kernel takes 1..{_MAX_KERNEL_B} query rows, got {B}")
    if H % (8 if docs.dtype == torch.bfloat16 else 4):
        raise ValueError(f"the kernel needs 16-byte doc rows; H={H} with {docs.dtype}")
    if not docs.is_contiguous() or docs.data_ptr() % 16:
        raise ValueError("docs must be contiguous and 16-byte aligned")
    q = q.contiguous()
    out = torch.empty((npad // _SEG, B), dtype=torch.float32, device=docs.device)
    cache = (
        torch.empty((npad, B), dtype=torch.float32, device=docs.device) if with_cache else None
    )
    lib = _lib()
    with torch.cuda.device(docs.device):
        stream = torch.cuda.current_stream(docs.device).cuda_stream
        err = lib.segmax_launch(
            torch.cuda.current_device(),  # the tensors' device (inside the with)
            int(docs.dtype == torch.bfloat16), B, H, npad, int(n_valid),
            q.data_ptr(), docs.data_ptr(), out.data_ptr(),
            cache.data_ptr() if cache is not None else None, stream,
        )
    if err:
        raise RuntimeError(f"segmax kernel launch failed: {lib.segmax_error_string(err).decode()}")
    segmax.launches += 1
    return out, cache


segmax.launches = 0  # kernel launches, counted where the kernel is launched


def segmax_reference(
    q: torch.Tensor, docs: torch.Tensor, n_valid: int, with_cache: bool = False
):
    """Plain PyTorch phase 1: full [Npad, B] f32 scores, mask, segment max."""
    scores = torch.matmul(docs.float(), q.float().T)  # [Npad, B]
    rows = torch.arange(docs.shape[0], device=docs.device)[:, None]
    scores = torch.where(rows < n_valid, scores, torch.full_like(scores, NEG_INF))
    seg = scores.reshape(-1, _SEG, scores.shape[1]).amax(dim=1)
    return seg, (scores if with_cache else None)


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


def _rescore(q: torch.Tensor, docs_padded: torch.Tensor, seg_idx: torch.Tensor):
    """Phase 2, re-score form: the winning segments' rows times the query,
    with phase 1's arithmetic. torch.matmul on bf16 would round the scores
    to bf16 (JAX asks for f32 results), so the storage-dtype operands are
    upcast to f32 (exactly) and multiplied in f32 with TF32 off."""
    B, H = q.shape
    d3 = docs_padded.reshape(-1, _SEG, H)
    blocks = d3[seg_idx].reshape(B, -1, H).float()  # [B, k_seg*SEG, H]
    scores = torch.bmm(blocks, q.float()[:, :, None])[..., 0]
    return scores.reshape(B, seg_idx.shape[1], _SEG)


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


def _segmax_phase2(segmax_sb, q, docs_padded, n_valid, k, *, sc_full=None,
                   sort_candidates=False):
    """Pick the k winning segments per row, gather or re-score them, final
    top-k."""
    S = segmax_sb.shape[0]
    k_seg = min(k, S)
    seg_idx = _select_segments(segmax_sb.T, k_seg, sort_candidates)  # [B, k_seg]
    if sc_full is not None:
        scores = _gather_cached_scores(sc_full, seg_idx, _SEG)
    else:
        scores = _rescore(q, docs_padded, seg_idx)
    return _candidate_union_topk(scores, seg_idx, _SEG, n_valid, k)


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
    N = docs.shape[0]
    if docs.shape[1] != H:
        raise ValueError(f"dim mismatch: queries H={H}, docs H={docs.shape[1]}")
    if k > N:
        raise ValueError(f"k={k} larger than corpus N={N}")
    if tile_n % _SEG:
        raise ValueError(f"tile_n={tile_n} must be a multiple of {_SEG}")
    if phase2 not in ("rescore", "gather"):
        raise ValueError(f"phase2 must be 'rescore' or 'gather': {phase2!r}")
    if B > _MAX_KERNEL_B:
        parts = [
            fused_topk_segmax(queries[i : i + _MAX_KERNEL_B], docs, k=k, tile_n=tile_n,
                              n_valid=n_valid, phase2="rescore",
                              sort_candidates=sort_candidates)
            for i in range(0, B, _MAX_KERNEL_B)
        ]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    n_pad = (-N) % tile_n
    if n_pad:
        docs = torch.cat([docs, docs.new_zeros((n_pad, H))])
    n_valid = N if n_valid is None else int(n_valid)
    q = queries.to(docs.dtype)
    seg, sc_full = segmax(q, docs, n_valid, with_cache=phase2 == "gather")
    return _segmax_phase2(seg, q, docs, n_valid, k, sc_full=sc_full,
                          sort_candidates=sort_candidates)


def segmax_bound(B: int, H: int, npad: int, storage_bytes: int):
    """Bytes and operations of one phase-1 call without the score cache
    (each input read once, each output written once). Returns (bytes,
    flops)."""
    nbytes = npad * H * storage_bytes + B * H * storage_bytes + (npad // _SEG) * B * 4
    return nbytes, 2 * B * H * npad
