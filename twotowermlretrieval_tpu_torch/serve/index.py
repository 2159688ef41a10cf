"""Device-side exact retrieval index over raw document embeddings.

The port of the JAX package's ``serve/index.py``. The corpus embedding
matrix lives in device memory, zero-padded
once to a multiple of the 8192-row tile: bf16 by default, or f32, or int8
quantized with one scale per 128-row segment (``quantize_segments``, half
the bytes of bf16). Every search is exact over the stored corpus, with the
padding masked by ``n_valid``:

- the fused path (``use_kernel`` None on a CUDA index, or True): the
  segment-max scan kernel (``fused_topk_segmax``, or ``fused_topk_segmax_s8``
  for int8, whose queries are quantized per row) + torch phase 2;
- the two-phase path (``use_kernel`` False, or None on a CPU index): one
  [B, N] product and the covering top-k in torch (``topk_segmented[_s8]``),
  as the JAX package's XLA path. For int8 both paths give the same bits.

Scores are inner products (cosine for normalized towers). ``autotune()``
times the phase-2 variants (and, on a CPU index, the two-phase path) on the
live corpus and keeps the fastest; ``save_retrieval_tuning`` persists the
decision with the artifacts, in the JAX package's file format.

``index_type="ivf"`` keeps the approximate IVF index instead (``ops/ivf.py``:
a prebuilt ``ivf_index``, or one clustered here with ``num_clusters``,
blocks in the storage dtype): searches probe ``nprobe`` blocks in plain
torch, bypassing the segment-max kernels and autotune.

With a ``mesh`` (``parallel/mesh.py`` ``DeviceMesh``) the corpus splits
row-wise over its 'data' axis, each shard on its own device
(``parallel/topk.py`` ``shard_corpus`` for bf16 and f32, ``shard_corpus_s8``
for int8, ``parallel/ivf.py`` ``shard_ivf`` for IVF), and every search
runs each shard's scan on its device and merges the lists on the lead
device, where the queries live (BASELINE config 4). ``autotune()`` is a
no-op there; a persisted decision still sets each shard's phase 2.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from twotowermlretrieval_tpu_torch.ops.ivf import IVFIndex, build_ivf, ivf_search
from twotowermlretrieval_tpu_torch.ops.topk import (
    _ROW_TILE,
    col_pad,
    fused_topk_segmax,
    fused_topk_segmax_s8,
    quantize_segments,
    topk_segmented,
    topk_segmented_s8,
)
from twotowermlretrieval_tpu_torch.parallel.ivf import distributed_ivf_search, shard_ivf
from twotowermlretrieval_tpu_torch.parallel.topk import (
    distributed_topk,
    distributed_topk_s8,
    shard_corpus,
    shard_corpus_s8,
)
from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device, torch_dtype
from twotowermlretrieval_tpu_torch.utils.profiling import annotate

_SUBLANE = 8  # query batches are padded to a multiple of this

RETRIEVAL_TUNING_FILE = "retrieval_tuning.json"


def load_retrieval_tuning(artifacts_path) -> Optional[dict]:
    p = Path(artifacts_path) / RETRIEVAL_TUNING_FILE
    if not p.exists():
        return None
    try:
        return json.loads(p.read_text())
    except (OSError, ValueError):
        return None  # unreadable records never block serving


def save_retrieval_tuning(artifacts_path, record: dict) -> None:
    """Merge ``record`` into the artifact directory's tuning file (atomic
    publish: a reader never sees a half-written file)."""
    p = Path(artifacts_path) / RETRIEVAL_TUNING_FILE
    merged = load_retrieval_tuning(artifacts_path) or {}
    merged.update(record)
    tmp = p.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(merged, indent=2))
    os.replace(tmp, p)


def _pad_rows(x: np.ndarray) -> np.ndarray:
    pad = (-x.shape[0]) % _ROW_TILE
    if not pad:
        return x
    return np.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))


def variant_name(phase2: str, sort_candidates: bool) -> str:
    return f"{phase2}{'+sorted' if sort_candidates else ''}"


class RetrievalIndex:
    def __init__(
        self,
        doc_embeddings: np.ndarray,  # [N, H] f32 (host)
        storage_dtype: str = "bfloat16",  # 'float32' | 'bfloat16' | 'int8'
        device="cuda",
        mesh=None,  # a parallel.mesh.DeviceMesh: the corpus splits over its 'data' axis
        index_type: str = "exact",  # 'exact' | 'ivf' (approximate, past the exact scan's corpora)
        use_kernel: Optional[bool] = None,  # None: the fused path where the index is on a card
        nprobe: int = 16,  # ivf only: blocks probed a query
        num_clusters: int = 0,  # ivf only: 0 = sqrt(N) heuristic
        ivf_index: Optional[IVFIndex] = None,  # a prebuilt index (the artifacts' ivf_index.npz)
    ):
        if ivf_index is not None:
            index_type = "ivf"
        if index_type not in ("exact", "ivf"):
            raise ValueError(f"index_type must be 'exact' or 'ivf', got {index_type!r}")
        self.mesh = mesh
        # with a mesh, queries (and the engine's towers) live on its lead device
        self.device = resolve_device(device if mesh is None else mesh.lead)
        self.num_docs = int(doc_embeddings.shape[0])
        self.dim = int(doc_embeddings.shape[1])
        self.storage_dtype = storage_dtype
        # phase-2 strategy of the fused path (ops.topk): re-score the
        # winning segments or gather their phase-1-cached scores, with the
        # candidates optionally in ascending address order; autotune()
        # measures and flips these, and use_kernel
        self.phase2 = "rescore"
        self.sort_candidates = False
        self.use_kernel = use_kernel
        self.quantized = storage_dtype == "int8"
        self._n_valid = self.num_docs
        self.ivf = None  # an IVFIndex, or a ShardedIVF with a mesh
        if index_type == "ivf":
            if ivf_index is None:
                ivf_index = build_ivf(np.asarray(doc_embeddings, np.float32),
                                      num_clusters=num_clusters, storage_dtype=storage_dtype,
                                      device=self.device)
            self.ivf = ivf_index.to(self.device) if mesh is None else shard_ivf(ivf_index, mesh)
            self.nprobe = nprobe
            self.quantized = ivf_index.scales is not None
            return
        self._scales = None
        if mesh is not None:
            # shards padded to whole tiles (and, on cards, 16-byte rows) once
            x = np.asarray(doc_embeddings, np.float32)
            if self.quantized:
                self._docs, self._scales, self._n_valid = shard_corpus_s8(x, mesh)
            else:
                self._docs, self._n_valid = shard_corpus(x, mesh, torch_dtype(storage_dtype))
            return
        padded = _pad_rows(np.asarray(doc_embeddings, np.float32))
        self._col_pad = col_pad(self.dim, self.device)
        if self._col_pad:
            padded = np.pad(padded, ((0, 0), (0, self._col_pad)))
        if self.quantized:
            values, seg_scales = quantize_segments(padded)
            self._docs = torch.from_numpy(values).to(self.device)
            self._scales = torch.from_numpy(seg_scales).to(self.device)
        else:
            self._docs = torch.from_numpy(padded).to(self.device).to(torch_dtype(storage_dtype))

    @property
    def index_type(self) -> str:
        return "exact" if self.ivf is None else "ivf"

    def kernel_on(self) -> bool:
        """Whether searches take the fused path (its CUDA kernel on a card,
        on every shard of a mesh of cards); never for an IVF index."""
        if self.index_type == "ivf":
            return False
        return self.use_kernel if self.use_kernel is not None else self.device.type == "cuda"

    def search(self, query_embeddings: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """[B, H] queries -> ([B, k] scores, [B, k] doc ids), sorted
        descending (exact, or the IVF index's probe)."""
        q = np.atleast_2d(np.asarray(query_embeddings, np.float32))
        B = q.shape[0]
        pad = (-B) % _SUBLANE
        if pad:
            q = np.concatenate([q, np.zeros((pad, self.dim), np.float32)], axis=0)
        with torch.inference_mode():
            vals, ids = self.traced_search(torch.from_numpy(q).to(self.device), k)
            return vals.cpu().numpy()[:B], ids.cpu().numpy()[:B]

    def traced_search(self, q: torch.Tensor, k: int):
        """Device search: ``q`` [Bp, H] f32 on the index's device -> ([Bp, k]
        f32, [Bp, k] int32) device tensors. The engine calls it right after
        the query encode, so encode and search run as one chain with one
        host fetch. The int8 path quantizes the f32 queries itself. With a
        mesh ``q`` is on its lead device, and so are the results."""
        k = min(k, self.num_docs)
        with annotate("ttr.search.scan"):
            if self.ivf is not None and self.mesh is not None:
                return distributed_ivf_search(q, self.ivf, k=k, nprobe=self.nprobe,
                                              mesh=self.mesh)
            if self.ivf is not None:
                return ivf_search(q, self.ivf, k=k, nprobe=self.nprobe)
            if self.mesh is not None:
                search = distributed_topk_s8 if self.quantized else distributed_topk
                args = (self._docs, self._scales) if self.quantized else (self._docs,)
                return search(q, *args, k=k, mesh=self.mesh, n_valid=self._n_valid,
                              use_kernel=self.kernel_on(), phase2=self.phase2,
                              sort_candidates=self.sort_candidates)
            variant = self.phase2 if self.kernel_on() else "two_phase"
            return self._search_variant(q, k, variant, self.sort_candidates)

    def _search_variant(self, q: torch.Tensor, k: int, phase2: str, sort_candidates: bool):
        kw = dict(k=k, n_valid=self._n_valid)
        if self._col_pad:
            q = torch.nn.functional.pad(q, (0, self._col_pad))
        if self.quantized:
            if phase2 == "two_phase":
                return topk_segmented_s8(q, self._docs, self._scales, **kw)
            return fused_topk_segmax_s8(q, self._docs, self._scales, phase2=phase2,
                                        sort_candidates=sort_candidates, **kw)
        q = q.to(self._docs.dtype)
        if phase2 == "two_phase":
            return topk_segmented(q, self._docs, **kw)
        return fused_topk_segmax(q, self._docs, phase2=phase2, sort_candidates=sort_candidates,
                                 **kw)

    def tuning_signature(self) -> dict:
        """What a persisted tuning decision is valid for."""
        return {
            "num_docs": self.num_docs,
            "dim": self.dim,
            "storage_dtype": self.storage_dtype,
            "index_type": self.index_type,
            "backend": self.device.type,
        }

    def decision(self) -> dict:
        # "use_pallas" is the JAX package's key for the same switch
        return {
            "phase2": self.phase2,
            "sort_candidates": self.sort_candidates,
            "use_pallas": self.use_kernel,
        }

    def apply_decision(self, decision: dict) -> None:
        """Apply a persisted autotune decision (the caller has validated its
        signature)."""
        phase2 = str(decision.get("phase2", self.phase2))
        if phase2 in ("rescore", "gather"):  # anything else keeps the default
            self.phase2 = phase2
        self.sort_candidates = bool(decision.get("sort_candidates", self.sort_candidates))
        use = decision.get("use_pallas")
        # a CUDA index always searches through its kernel: a record that
        # turns the fused path off applies to a CPU index only
        if use is not None and (use or self.device.type != "cuda"):
            self.use_kernel = bool(use)

    _AUTOTUNE_VARIANTS = (
        ("rescore", False), ("rescore", True),
        ("gather", False), ("gather", True),
        ("two_phase", False),  # one [B, N] product, the JAX package's XLA path
    )

    def autotune(self, B: int = 16, k: int = 50, iters: int = 20, timer=None) -> dict:
        """Time the search variants on the live corpus and keep the fastest:
        the fused path's phase-2 strategies (sets ``phase2`` /
        ``sort_candidates``) and, on a CPU index only, the two-phase path
        (sets ``use_kernel = False`` when it wins). A CUDA index times the
        four fused variants alone, so a timing never takes its searches off
        the kernel. A no-op returning {} where the fused path is off, and
        on a mesh (as in the JAX package). ``B``
        defaults to the engine's smallest encode batch (16 rows). Returns
        {(phase2, sort_candidates): seconds per call}.

        ``timer``: optional ``f(phase2, sort_candidates, B, k, iters) ->
        seconds`` override (tests inject canned values)."""
        if self.mesh is not None or not self.kernel_on():
            return {}
        k = min(k, self.num_docs)
        timer = timer or self._time_variant
        variants = self._AUTOTUNE_VARIANTS[:4] if self.device.type == "cuda" else \
            self._AUTOTUNE_VARIANTS
        results = {v: timer(*v, B, k, iters) for v in variants}
        best = min(results, key=results.get)
        if best[0] == "two_phase":
            self.use_kernel = False
            self.phase2, self.sort_candidates = "rescore", False
        else:
            self.phase2, self.sort_candidates = best
        return results

    def _time_variant(self, phase2, srt, B, k, iters) -> float:
        """Seconds per search call for one variant: one warm-up call, then
        ``iters`` calls back to back between two CUDA events (the host clock
        for a CPU index), on unit-norm random queries."""
        rng = np.random.default_rng(0)
        q = rng.standard_normal((B, self.dim)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        qt = torch.from_numpy(q).to(self.device)

        def run():
            for _ in range(iters):
                self._search_variant(qt, k, phase2, srt)

        with torch.inference_mode():
            self._search_variant(qt, k, phase2, srt)
            if self.device.type != "cuda":
                t0 = time.perf_counter()
                run()
                return (time.perf_counter() - t0) / iters
            with torch.cuda.device(self.device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3 / iters
