"""IVF (inverted-file) approximate retrieval index: the port of the JAX
package's ``ops/ivf.py`` in plain PyTorch on the caller's device.

The exact scan (``ops/topk.py``) reads the whole corpus once a search; IVF
reads only the blocks near the query. The design is the JAX package's:

- **k-means on the device**: spherical Lloyd iterations, an assignment by
  one [chunk, H] x [H, C] f32 product and argmax a chunk of rows, the
  update an ``index_add_`` of the rows into their clusters' sums.
- **Static shapes**: the corpus is reordered into dense [n_blocks, cap, H]
  blocks (``cap`` a multiple of 128) with an id map [n_blocks, cap] (-1 for
  padding slots); "the index" is three tensors.
- **Skew-proof blocks**: ``cap`` sits near the MEAN cluster size and an
  oversized cluster splits into several blocks that share its centroid
  (they tie in the probe scores, so a popular cluster takes several of the
  ``nprobe`` slots); an empty cluster takes no block.
- **Search**: centroid product -> the top-``nprobe`` blocks -> gather them
  -> score [B, nprobe * cap] in f32 -> top-k. Queries run in blocks sized
  to a fixed byte budget of the gather (every row depends on its query
  alone, so the results equal one call's).

Differences from the JAX package: the k-means init draws its ``num_clusters``
distinct rows from a ``torch.Generator`` seeded with ``seed`` (JAX's
``jax.random.choice`` stream cannot be matched), so an index built here has
other centroids than one built there from the same seed; and the Lloyd
sums run in another order (``index_add_`` against ``segment_sum``), so
centroids agree to about 1e-6 given the same start. The ``.npz`` file
(:func:`save_ivf` / :func:`load_ivf`) is the JAX package's, key for key and
dtype for dtype (bf16 as a uint16 view), so a file written by either
package loads in the other and searches alike.

Ties: every selection is a stable descending sort (``_stable_topk``), so
ties go to the lower position as ``lax.top_k`` sends them, both for the
probe (blocks that share a centroid) and for the final k.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from twotowermlretrieval_tpu_torch.ops.topk import _stable_topk, topk_oracle
from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device

IVF_INDEX_FILE = "ivf_index.npz"

_NEG = float(-3.0e38)  # score of a padding slot (fits f32)
_KMEANS_CHUNK = 131072  # bounds the [chunk, C] score tile of a Lloyd step
# ivf_search's queries run in blocks whose gathered blocks (in the storage
# dtype and as f32) take at most this many bytes, and at least one query
_SEARCH_BYTES = 1 << 30
_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


class IVFIndex(NamedTuple):
    centroids: torch.Tensor  # [n_blocks, H] f32, unit-norm (a block's cluster centroid)
    docs: torch.Tensor  # [n_blocks, cap, H] storage dtype (f32 / bf16 / int8)
    ids: torch.Tensor  # [n_blocks, cap] int32, -1 for padding slots
    cap: int
    scales: Optional[torch.Tensor] = None  # [n_blocks, cap] f32, int8 storage only

    def to(self, device) -> "IVFIndex":
        return IVFIndex(*(t.to(device) if isinstance(t, torch.Tensor) else t for t in self))


def _pad_to_chunks(docs: torch.Tensor) -> torch.Tensor:
    """Reshape [N, H] into [num_chunks, chunk, H] for the Lloyd scan, with
    the JAX package's chunk rule: at most ``_KMEANS_CHUNK`` rows, and at
    least four chunks (a multiple of 128 rows) where that leaves 128 rows a
    chunk. Zero rows pad the last chunk."""
    N, H = docs.shape
    chunk = min(_KMEANS_CHUNK, max(128, (-(-N // 4) + 127) // 128 * 128))
    pad = (-N) % chunk
    if pad:
        docs = torch.cat([docs, docs.new_zeros((pad, H))])
    return docs.reshape(-1, chunk, H)


def _assign_chunk(chunk: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Each row's nearest centroid by inner product (ties to the lower
    cluster, as ``jnp.argmax``)."""
    return torch.argmax(torch.matmul(chunk.float(), centroids.T), dim=1)


def _lloyd_step(chunked_docs: torch.Tensor, centroids: torch.Tensor, num_segments: int):
    """One spherical Lloyd iteration, a chunk of rows at a time, so the
    [chunk, C] score tile (not [N, C]) is the peak memory. Zero padding rows
    add zero vectors to whichever cluster they land in; an empty cluster
    keeps its previous centroid."""
    sums = torch.zeros((num_segments, chunked_docs.shape[-1]), dtype=torch.float32,
                       device=chunked_docs.device)
    for chunk in chunked_docs:
        sums.index_add_(0, _assign_chunk(chunk, centroids), chunk.float())
    norms = torch.linalg.norm(sums, dim=1, keepdim=True)
    return torch.where(norms > 1e-6, sums / torch.clamp(norms, min=1e-6), centroids)


def _kmeans(chunked: torch.Tensor, n_real: int, num_clusters: int, iters: int,
            seed: int) -> torch.Tensor:
    """Spherical k-means over pre-chunked [nc, chunk, H] rows; returns
    unit-norm centroids [C, H] f32. The init takes ``num_clusters``
    distinct rows of the ``n_real`` leading ones (never the chunk's zero
    padding), drawn from a CPU generator seeded with ``seed``."""
    flat = chunked.reshape(-1, chunked.shape[-1])
    init_idx = torch.randperm(n_real, generator=torch.Generator().manual_seed(seed))
    centroids = flat[init_idx[:num_clusters].to(flat.device)].float()
    for _ in range(iters):
        centroids = _lloyd_step(chunked, centroids, num_clusters)
    return centroids


def build_ivf(
    doc_embeddings: np.ndarray,  # [N, H] f32 (host), about unit-norm
    num_clusters: int = 0,  # 0: sqrt(N) rounded to a multiple of 8
    iters: int = 10,
    storage_dtype: str = "bfloat16",
    seed: int = 0,
    kmeans_sample: int = 0,  # > 0: the Lloyd iterations run on at most this many rows
    device="cuda",
) -> IVFIndex:
    """Cluster the corpus on ``device`` and reorder it into dense [n_blocks,
    cap, H] blocks. ``storage_dtype`` 'int8' quantizes each packed slot per
    row (scale = max|row| / 127, kept in ``scales``). ``kmeans_sample``
    runs the Lloyd iterations on a uniform sample of rows (numpy's
    generator seeded with ``seed``, the JAX package's draw); the final
    assignment scans every row."""
    if storage_dtype not in _STORAGE:
        raise ValueError(f"storage_dtype must be one of {sorted(_STORAGE)}, got {storage_dtype!r}")
    dev = resolve_device(device)
    x = np.asarray(doc_embeddings, np.float32)
    N, H = x.shape
    if not num_clusters:
        num_clusters = max(8, int(round(np.sqrt(N) / 8)) * 8)
    num_clusters = min(num_clusters, N)

    xt = torch.from_numpy(x).to(dev)
    if kmeans_sample and N > kmeans_sample:
        sample_idx = np.random.default_rng(seed).choice(N, kmeans_sample, replace=False)
        train_rows, n_train = xt[torch.from_numpy(sample_idx).to(dev)], kmeans_sample
    else:
        train_rows, n_train = xt, N
    centroids = _kmeans(_pad_to_chunks(train_rows), n_train, num_clusters, iters, seed)
    assign = torch.cat([_assign_chunk(c, centroids) for c in _pad_to_chunks(xt)])[:N]
    assign = assign.cpu().numpy()

    counts = np.bincount(assign, minlength=num_clusters)
    # capacity near the MEAN cluster size; oversized clusters split into
    # blocks sharing their centroid, empty clusters take none
    mean = max(int(counts[counts > 0].mean()) if (counts > 0).any() else 128, 1)
    cap = max(128, int(-(-mean // 128) * 128))
    blocks_per_cluster = -(-counts // cap)
    n_blocks = int(blocks_per_cluster.sum())
    block_of_cluster_start = np.concatenate([[0], np.cumsum(blocks_per_cluster)[:-1]])

    # sort by cluster; a row's block = its cluster's first block + (rank in
    # the cluster) // cap, its slot = rank % cap
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    starts = np.searchsorted(sorted_assign, np.arange(num_clusters))
    rank = np.arange(N) - starts[sorted_assign]
    block = block_of_cluster_start[sorted_assign] + rank // cap
    slot = rank % cap
    flat_slot = torch.from_numpy(block * cap + slot).to(dev)
    packed = torch.zeros((n_blocks * cap, H), dtype=torch.float32, device=dev)
    packed[flat_slot] = xt[torch.from_numpy(order).to(dev)]
    packed = packed.reshape(n_blocks, cap, H)
    ids = np.full((n_blocks, cap), -1, np.int32)
    ids[block, slot] = order.astype(np.int32)
    ids = torch.from_numpy(ids).to(dev)
    block_centroids = centroids[torch.from_numpy(
        np.repeat(np.arange(num_clusters), blocks_per_cluster)).to(dev)]

    if storage_dtype == "int8":
        scales = packed.abs().amax(dim=-1) / 127.0  # [n_blocks, cap]
        safe = torch.where(scales > 0, scales, torch.ones_like(scales))
        values = torch.round(packed / safe[..., None]).to(torch.int8)
        return IVFIndex(block_centroids, values, ids, cap, scales)
    return IVFIndex(block_centroids, packed.to(_STORAGE[storage_dtype]), ids, cap)


def save_ivf(path, index: IVFIndex) -> None:
    """Persist the index as one ``.npz`` in the JAX package's format:
    centroids, docs (bf16 as a uint16 view: npz has no bf16), docs_dtype,
    ids, cap and, for int8, scales."""
    docs = index.docs.cpu()
    docs_dtype = {v: k for k, v in _STORAGE.items()}[docs.dtype]
    docs = docs.view(torch.int16).numpy().view(np.uint16) if docs_dtype == "bfloat16" \
        else docs.numpy()
    arrays = dict(
        centroids=index.centroids.cpu().numpy(),
        docs=docs,
        docs_dtype=np.asarray(docs_dtype),
        ids=index.ids.cpu().numpy(),
        cap=np.asarray(index.cap, np.int32),
    )
    if index.scales is not None:
        arrays["scales"] = index.scales.cpu().numpy()
    np.savez(path, **arrays)


def load_ivf(path, device="cpu") -> IVFIndex:
    """Inverse of :func:`save_ivf` (either package's file), onto ``device``."""
    with np.load(path) as z:
        docs = z["docs"]
        if str(z["docs_dtype"]) == "bfloat16":
            docs = torch.from_numpy(docs.view(np.int16)).view(torch.bfloat16)
        else:
            docs = torch.from_numpy(docs)
        index = IVFIndex(
            centroids=torch.from_numpy(z["centroids"]),
            docs=docs,
            ids=torch.from_numpy(z["ids"]),
            cap=int(z["cap"]),
            scales=torch.from_numpy(z["scales"]) if "scales" in z.files else None,
        )
    return index.to(device)


def probe_blocks(q: torch.Tensor, centroids: torch.Tensor, nprobe: int,
                 n_blocks: Optional[int] = None) -> torch.Tensor:
    """[B, nprobe] ids of the blocks whose centroids score highest (ties to
    the lower block); blocks >= ``n_blocks`` (a sharded index's padding)
    never."""
    c_scores = torch.matmul(q, centroids.T)  # [B, C] f32
    if n_blocks is not None and n_blocks < c_scores.shape[1]:
        cols = torch.arange(c_scores.shape[1], device=c_scores.device)
        c_scores = torch.where(cols < n_blocks, c_scores, torch.full_like(c_scores, _NEG))
    return _stable_topk(c_scores, nprobe)[1]


def score_blocks(q: torch.Tensor, docs: torch.Tensor, ids: torch.Tensor,
                 scales: Optional[torch.Tensor], probe: torch.Tensor,
                 own: Optional[torch.Tensor] = None):
    """Scores of the probed blocks' slots: ([B, nprobe * cap] f32, their
    [B, nprobe * cap] doc ids), padding slots (and, with ``own``, slots of
    probe entries False there) -1 and NEG_INF."""
    B, H = q.shape
    blocks = docs[probe]  # [B, nprobe, cap, H] (gather)
    block_ids = ids[probe]  # [B, nprobe, cap]
    if own is not None:
        block_ids = torch.where(own[..., None], block_ids, torch.full_like(block_ids, -1))
    flat_ids = block_ids.reshape(B, -1)
    rows = blocks.reshape(B, -1, H).float()
    if scales is not None:
        # int8 rows: f32 products (exact upcasts), then the slot's scale
        scores = torch.bmm(rows, q[:, :, None])[..., 0] * scales[probe].reshape(B, -1)
    else:
        # the storage dtype's products summed in f32: bf16 -> f32 is exact,
        # and a torch bf16 product would round every score to bf16
        scores = torch.bmm(rows, q.to(docs.dtype).float()[:, :, None])[..., 0]
    return torch.where(flat_ids >= 0, scores, torch.full_like(scores, _NEG)), flat_ids


def topk_padded(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k of [B, n] candidates padded to [B, k] when n < k; ids -1 (and
    scores -3e38) wherever a score is padding."""
    k_eff = min(k, scores.shape[1])
    vals, pos = _stable_topk(scores, k_eff)
    out_ids = torch.gather(ids, 1, pos)
    if k_eff < k:  # fewer candidates than k: pad to the promised shape
        vals = torch.nn.functional.pad(vals, (0, k - k_eff), value=_NEG)
        out_ids = torch.nn.functional.pad(out_ids, (0, k - k_eff), value=-1)
    return vals, torch.where(vals <= _NEG, torch.full_like(out_ids, -1), out_ids)


def _search_block(q: torch.Tensor, index: IVFIndex, k: int, nprobe: int):
    probe = probe_blocks(q, index.centroids, nprobe)
    return topk_padded(*score_blocks(q, index.docs, index.ids, index.scales, probe), k)


def in_query_blocks(search_block, q: torch.Tensor, nprobe: int, cap: int, docs: torch.Tensor):
    """``search_block(rows of q) -> ([b, k], [b, k])`` over blocks of query
    rows whose gathered blocks (in ``docs``' dtype and as f32) stay within
    ``_SEARCH_BYTES``, one query at least; the blocks' results joined."""
    per_query = nprobe * cap * docs.shape[-1] * (docs.element_size() + 4)
    rows = max(1, _SEARCH_BYTES // per_query)
    parts = [search_block(q[i : i + rows]) for i in range(0, q.shape[0], rows)]
    if len(parts) == 1:
        return parts[0]
    return torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts])


def ivf_search(queries: torch.Tensor, index: IVFIndex, k: int = 50,
               nprobe: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k on the index's device: ([B, k] f32 scores, [B, k]
    int32 ORIGINAL doc ids), sorted descending; ids -1 (scores -3e38) where
    fewer than k real docs were probed. Queries run in blocks whose gather
    stays within ``_SEARCH_BYTES``."""
    nprobe = min(nprobe, index.centroids.shape[0])
    q = queries.to(index.centroids.device).float()
    return in_query_blocks(lambda rows: _search_block(rows, index, k, nprobe), q, nprobe,
                           index.cap, index.docs)


def pick_nprobe(
    index: IVFIndex,
    doc_embeddings: np.ndarray,  # [N, H] f32, row i = original doc id i
    k: int = 50,
    target_recall: float = 0.99,
    num_queries: int = 256,
    queries: Optional[np.ndarray] = None,  # real query embeddings, if any
    seed: int = 0,
) -> Tuple[int, float]:
    """The smallest nprobe on the ladder 1, 2, 4, ... C whose recall@k
    against EXACT search (:func:`topk_oracle`, on the index's device) meets
    ``target_recall``: (nprobe, measured recall), or (C, recall) where even
    a full probe misses it (f32 and bf16 blocks recall 1.0 there by
    construction, up to ties; int8 blocks can fall short by their
    quantization). The probe queries default to ``num_queries`` corpus rows
    sampled with numpy's generator seeded with ``seed`` (the JAX package's
    draw); pass ``queries`` for a real sample."""
    d = np.asarray(doc_embeddings, np.float32)
    if queries is None:
        rng = np.random.default_rng(seed)
        sample = rng.choice(d.shape[0], size=min(num_queries, d.shape[0]), replace=False)
        queries = d[sample]
    dev = index.centroids.device
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(dev)
    k = min(k, d.shape[0])
    _, exact_ids = topk_oracle(q, torch.from_numpy(d).to(dev), k)
    exact_sets = [set(row) for row in exact_ids.cpu().tolist()]

    C = int(index.centroids.shape[0])
    nprobe = 1
    while True:
        _, ids = ivf_search(q, index, k=k, nprobe=nprobe)
        ids = ids.cpu().tolist()
        recall = float(np.mean([len(exact_sets[b].intersection(ids[b])) / k
                                for b in range(len(ids))]))
        if recall >= target_recall or nprobe >= C:
            return min(nprobe, C), recall
        nprobe = min(nprobe * 2, C)
