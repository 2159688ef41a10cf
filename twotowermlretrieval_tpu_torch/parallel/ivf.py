"""IVF search over an index whose blocks split across the devices of a mesh.

The port of the JAX package's ``parallel/ivf.py``, for an index whose
packed [C, cap, H] blocks outgrow one device:

- **centroids on the lead device**: [C, H] is small. The probe runs once
  there and its list goes to every shard, so the search probes what
  :func:`ops.ivf.ivf_search` probes with the same ``nprobe``.
- **blocks split** over 'data': shard ``s`` owns blocks ``[s * Bl, (s + 1)
  * Bl)``. It gathers the probed blocks through clamped ids masked by
  ownership (a probe entry it does not own scores NEG_INF), scores them as
  the single-device search does (``ops/ivf.py`` ``score_blocks``) and takes
  its top-k; the lists merge on the lead device as the exact scan's do
  (``parallel/topk.py``), padded to k with -1 ids.

Queries run in the single-device search's blocks, so one shard's gather
stays within ``ops/ivf.py``'s ``_SEARCH_BYTES``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from twotowermlretrieval_tpu_torch.ops.ivf import (
    IVFIndex,
    in_query_blocks,
    probe_blocks,
    score_blocks,
    topk_padded,
)
from twotowermlretrieval_tpu_torch.ops.topk import NEG_INF
from twotowermlretrieval_tpu_torch.parallel.mesh import DeviceMesh
from twotowermlretrieval_tpu_torch.parallel.topk import Shards, merge_lists


class ShardedIVF(NamedTuple):
    centroids: torch.Tensor  # [C_pad, H] f32 on the lead device
    docs: Shards  # [C_pad / D, cap, H] a shard, on its shard device
    ids: Shards  # [C_pad / D, cap] int32 a shard, -1 padding
    scales: Optional[Shards]  # [C_pad / D, cap] f32 a shard (int8 storage only)
    n_blocks: int  # the true (unpadded) block count
    cap: int


def shard_ivf(index: IVFIndex, mesh: DeviceMesh) -> ShardedIVF:
    """Place an IVFIndex on the mesh: centroids on the lead device, blocks
    padded to a multiple of the 'data' axis and split over it. Padding
    blocks get NEG_INF centroids (never probed), zero docs and -1 ids."""
    centroids, docs, ids = index.centroids.cpu(), index.docs.cpu(), index.ids.cpu()
    scales = None if index.scales is None else index.scales.cpu()
    C, cap = ids.shape
    pad = (-C) % mesh.data
    if pad:
        centroids = torch.cat([centroids, centroids.new_full((pad, centroids.shape[1]), NEG_INF)])
        docs = torch.cat([docs, docs.new_zeros((pad,) + tuple(docs.shape[1:]))])
        ids = torch.cat([ids, ids.new_full((pad, cap), -1)])
        if scales is not None:
            scales = torch.cat([scales, scales.new_zeros((pad, cap))])

    def split(t):
        return tuple(part.contiguous().to(dev)
                     for part, dev in zip(torch.chunk(t, mesh.data), mesh.shard_devices))

    return ShardedIVF(centroids.to(mesh.lead), split(docs), split(ids),
                      None if scales is None else split(scales), C, cap)


def _search_block(q: torch.Tensor, index: ShardedIVF, k: int, nprobe: int, mesh: DeviceMesh):
    probe = probe_blocks(q, index.centroids, nprobe, index.n_blocks)  # [B, nprobe] global
    per_shard = index.docs[0].shape[0]
    lists = []
    for s, dev in enumerate(mesh.shard_devices):
        local = probe.to(dev) - s * per_shard
        own = (local >= 0) & (local < per_shard)
        scores, ids = score_blocks(q.to(dev), index.docs[s], index.ids[s],
                                   None if index.scales is None else index.scales[s],
                                   local.clamp(0, per_shard - 1), own)
        lists.append(topk_padded(scores, ids, k))
    return merge_lists(lists, k, mesh.lead)


def distributed_ivf_search(queries: torch.Tensor, index: ShardedIVF, k: int = 50,
                           nprobe: int = 32,
                           mesh: Optional[DeviceMesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k over the block-sharded IVF index, with the
    semantics of ``ops.ivf.ivf_search`` at the same ``nprobe``: ([B, k] f32
    scores, [B, k] int32 original doc ids) on the lead device, ids -1 where
    fewer than k real docs were probed."""
    if mesh is None:
        raise ValueError("distributed_ivf_search needs the mesh")
    nprobe = min(nprobe, index.n_blocks)
    q = queries.to(mesh.lead).float()
    return in_query_blocks(lambda rows: _search_block(rows, index, k, nprobe, mesh), q, nprobe,
                           index.cap, index.docs[0])
