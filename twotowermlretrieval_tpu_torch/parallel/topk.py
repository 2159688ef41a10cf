"""Exact top-k over a corpus split row-wise across the devices of a mesh.

The port of the JAX package's ``parallel/topk.py`` (BASELINE config 4, a
sharded corpus with the fused scan and a top-50). Shard ``s`` holds rows
``[s * shard_rows, (s + 1) * shard_rows)`` on ``mesh.shard_devices[s]``.
A search copies the queries to every shard, runs the shard's own exact
top-k there with global ids, copies the [B, k] lists back to the lead
device in shard order and takes one stable top-k over the [B, D * k]
candidates: JAX's ``all_gather`` and ``lax.top_k``, with its tie order
(the lower position, so the lower shard, wins).

One process drives every shard, and nothing on the way syncs with the
host, so the shards of a mesh of cards run at once. A CUDA shard takes
the fused route (``fused_topk_segmax``, ``fused_topk_int8`` or
``fused_topk_segmax_s8``: its scan kernel, one launch a shard), a CPU
shard the two-phase route (``topk_segmented[_int8|_s8]``); ``use_kernel``
overrides that choice, as the JAX package's ``use_pallas``.

Each shard masks its zero padding inside its own scan (``n_valid``): a
padding row scoring 0 could otherwise push a real, negative-scoring doc
out of the shard's k. A shard can hold fewer than k rows, or only padding
(a small corpus over many shards): it returns ``min(k, shard_rows)``
candidates, NEG_INF with id -1 past its valid rows, and D shards always
return at least k candidates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from twotowermlretrieval_tpu_torch.ops.topk import (
    _ROW_TILE,
    _stable_topk,
    col_pad,
    fused_topk_int8,
    fused_topk_segmax,
    fused_topk_segmax_s8,
    quantize_rows,
    quantize_segments,
    topk_segmented,
    topk_segmented_int8,
    topk_segmented_s8,
)
from twotowermlretrieval_tpu_torch.parallel.mesh import DeviceMesh

# the JAX package's smallest s8 kernel tile: every shard of an s8 corpus is
# a multiple of it (and so of the 128-row segment)
_MIN_TILE_N = 1024

Shards = Tuple[torch.Tensor, ...]


def _kernel_route(use_kernel: Optional[bool], device: torch.device) -> bool:
    return use_kernel if use_kernel is not None else device.type == "cuda"


def _merge_across_shards(local_fn, queries, k: int, n_valid: int, shard_rows: int,
                         mesh: DeviceMesh):
    """Run ``local_fn(s, queries_on_shard, local_valid, k_local) -> (vals,
    ids)`` on every shard and merge the candidates on the lead device."""
    parts = []
    for s, dev in enumerate(mesh.shard_devices):
        # rows valid in this shard (the tail shards hold the zero padding)
        local_valid = min(max(n_valid - s * shard_rows, 0), shard_rows)
        vals, ids = local_fn(s, queries.to(dev), local_valid, min(k, shard_rows))
        parts.append((vals, torch.where(ids >= 0, ids + s * shard_rows, ids)))  # global ids
    return merge_lists(parts, k, mesh.lead)


def merge_lists(parts, k: int, lead: torch.device):
    """One stable top-k over per-shard ([B, k_s] values, [B, k_s] ids)
    lists, copied to ``lead`` and joined in shard order."""
    all_vals = torch.cat([v.to(lead) for v, _ in parts], dim=1)  # [B, sum k_s]
    all_ids = torch.cat([i.to(lead) for _, i in parts], dim=1)
    vals, pos = _stable_topk(all_vals, k)
    return vals, torch.gather(all_ids, 1, pos)


def _pad_columns(q: torch.Tensor, width: int) -> torch.Tensor:
    """Zero columns up to the shards' width (a card's shards are padded to
    the scans' 16-byte rows; zeros add nothing to a score)."""
    return torch.nn.functional.pad(q, (0, width - q.shape[1])) if q.shape[1] < width else q


def distributed_topk(
    queries: torch.Tensor,  # [B, H] on the lead device
    docs: Shards,  # one [N / D, H] tensor a shard, on its shard device
    k: int,
    mesh: DeviceMesh,
    n_valid: Optional[int] = None,
    use_kernel: Optional[bool] = None,
    phase2: str = "rescore",
    sort_candidates: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the sharded corpus: ([B, k] f32 values, [B, k]
    int32 global ids) on the lead device. ``n_valid`` is the true corpus
    size when the shards carry zero padding (:func:`shard_corpus`).
    ``phase2`` / ``sort_candidates`` select each shard's phase 2 on the
    fused route (``fused_topk_segmax``)."""
    shard_rows = docs[0].shape[0]
    n_valid = shard_rows * len(docs) if n_valid is None else int(n_valid)
    q = _pad_columns(queries, docs[0].shape[1]).to(docs[0].dtype)

    def local(s, qs, local_valid, k_local):
        if _kernel_route(use_kernel, docs[s].device):
            return fused_topk_segmax(qs, docs[s], k=k_local, n_valid=local_valid, phase2=phase2,
                                     sort_candidates=sort_candidates)
        return topk_segmented(qs, docs[s], k=k_local, n_valid=local_valid)

    return _merge_across_shards(local, q, k, n_valid, shard_rows, mesh)


def distributed_topk_int8(
    queries: torch.Tensor,  # [B, H] float on the lead device
    doc_values: Shards,  # [N / D, H] int8 a shard (quantize_rows)
    doc_scales: Shards,  # [N / D] f32 a shard
    k: int,
    mesh: DeviceMesh,
    n_valid: Optional[int] = None,
    use_kernel: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-row int8 corpus (:func:`shard_corpus_int8`): each shard
    scans its quantized rows (the running top-k, ``fused_topk_int8``, on a
    card), then the same merge."""
    shard_rows = doc_values[0].shape[0]
    n_valid = shard_rows * len(doc_values) if n_valid is None else int(n_valid)
    q = _pad_columns(queries, doc_values[0].shape[1])

    def local(s, qs, local_valid, k_local):
        if _kernel_route(use_kernel, doc_values[s].device):
            return fused_topk_int8(qs, doc_values[s], doc_scales[s], k=k_local,
                                   n_valid=local_valid)
        return topk_segmented_int8(qs, doc_values[s], doc_scales[s], k=k_local,
                                   n_valid=local_valid)

    return _merge_across_shards(local, q, k, n_valid, shard_rows, mesh)


def distributed_topk_s8(
    queries: torch.Tensor,  # [B, H] float on the lead device
    doc_values: Shards,  # [N / D, H] int8 a shard, per-SEGMENT quantized
    seg_scales: Shards,  # [N / D / 128] f32 a shard
    k: int,
    mesh: DeviceMesh,
    n_valid: Optional[int] = None,
    use_kernel: Optional[bool] = None,
    phase2: str = "rescore",
    sort_candidates: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-segment int8 corpus (:func:`shard_corpus_s8`, the serving
    int8 index): each shard runs ``fused_topk_segmax_s8`` (the s8 scan
    kernel on a card) or ``topk_segmented_s8``, then the same merge. Every
    score is the single-device index's, bit for bit."""
    shard_rows = doc_values[0].shape[0]
    n_valid = shard_rows * len(doc_values) if n_valid is None else int(n_valid)
    q = _pad_columns(queries, doc_values[0].shape[1])

    def local(s, qs, local_valid, k_local):
        if _kernel_route(use_kernel, doc_values[s].device):
            return fused_topk_segmax_s8(qs, doc_values[s], seg_scales[s], k=k_local,
                                        n_valid=local_valid, phase2=phase2,
                                        sort_candidates=sort_candidates)
        return topk_segmented_s8(qs, doc_values[s], seg_scales[s], k=k_local,
                                 n_valid=local_valid)

    return _merge_across_shards(local, q, k, n_valid, shard_rows, mesh)


# ---------------------------------------------------------------------------
# placing a corpus on the mesh
# ---------------------------------------------------------------------------


def _shard_pad(N: int, num_shards: int) -> int:
    """Rows to append so each shard is a multiple of the scans' 8192-row
    tile (large corpora: the scan would otherwise pad its shard on every
    call) or of 8 rows (small ones)."""
    row_tile = _ROW_TILE if N >= num_shards * _ROW_TILE else 8
    return (-N) % (num_shards * row_tile)


def _pad(x: np.ndarray, rows: int, cols: int = 0) -> np.ndarray:
    if not rows and not cols:
        return x
    return np.pad(x, ((0, rows), (0, cols)) if x.ndim == 2 else ((0, rows),))


def _split(x: np.ndarray, mesh: DeviceMesh, dtype=None) -> Shards:
    """Row blocks of ``x``, one a shard, each on its shard device (cast to
    ``dtype`` there)."""
    shards = (torch.from_numpy(np.ascontiguousarray(part)).to(dev)
              for part, dev in zip(np.split(x, mesh.data), mesh.shard_devices))
    return tuple(t if dtype is None else t.to(dtype) for t in shards)


def shard_corpus(doc_embeddings: np.ndarray, mesh: DeviceMesh,
                 dtype: Optional[torch.dtype] = None) -> Tuple[Shards, int]:
    """Split [N, H] rows over 'data', zero-padded to whole shards (and, on
    a card, to 16-byte rows), each shard stored as ``dtype`` (default: the
    rows' own) on its device. Returns (shards, true N): pass N as
    ``n_valid`` so the padding is masked."""
    x = np.asarray(doc_embeddings)
    N, H = x.shape
    x = _pad(x, _shard_pad(N, mesh.data), col_pad(H, mesh.lead))
    return _split(x, mesh, dtype), N


def shard_corpus_int8(doc_embeddings: np.ndarray,
                      mesh: DeviceMesh) -> Tuple[Shards, Shards, int]:
    """Quantize [N, H] f32 rows per row (``quantize_rows``) and split the
    values and scales over 'data' (zero-padded as :func:`shard_corpus`).
    Returns (values shards, scales shards, true N)."""
    values, scales = quantize_rows(np.asarray(doc_embeddings, np.float32))
    N, H = values.shape
    pad = _shard_pad(N, mesh.data)
    values = _pad(values, pad, col_pad(H, mesh.lead))
    return _split(values, mesh), _split(_pad(scales, pad), mesh), N


def shard_corpus_s8(doc_embeddings: np.ndarray,
                    mesh: DeviceMesh) -> Tuple[Shards, Shards, int]:
    """Quantize [N, H] f32 rows per 128-row segment (``quantize_segments``,
    over the padded whole, so every segment and scale is the single-device
    index's) and split values and segment scales over 'data'. Each shard
    is a multiple of the 8192-row tile for large corpora, else of
    ``_MIN_TILE_N`` rows, so segments never straddle shards. Returns
    (values shards, segment-scales shards, true N)."""
    x = np.asarray(doc_embeddings, np.float32)
    N, H = x.shape
    row_tile = _ROW_TILE if N >= mesh.data * _ROW_TILE else _MIN_TILE_N
    x = _pad(x, (-N) % (mesh.data * row_tile), col_pad(H, mesh.lead))
    values, seg_scales = quantize_segments(x)
    return _split(values, mesh), _split(seg_scales, mesh), N
