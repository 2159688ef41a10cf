"""Device-side exact retrieval index over raw document embeddings.

The port of the JAX package's ``serve/index.py`` for one device and the
exact index: the corpus embedding matrix lives in device memory (bf16 by
default, or f32), zero-padded once to a multiple of the 8192-row tile, and
every search is :func:`ops.topk.fused_topk_segmax` (the segment-max CUDA
kernel + torch phase 2) with the padding masked by ``n_valid``. Scores are
inner products (cosine for normalized towers).

Not ported yet (ROADMAP): int8 storage, the IVF index, a device mesh, and
``autotune()``. A persisted autotune decision (``retrieval_tuning.json``)
is still honoured when its signature matches this index.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from twotowermlretrieval_tpu_torch.ops.topk import fused_topk_segmax
from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device, torch_dtype

_SUBLANE = 8  # query batches are padded to a multiple of this
_ROW_TILE = 8192  # corpus rows are padded once to this tile

RETRIEVAL_TUNING_FILE = "retrieval_tuning.json"


def load_retrieval_tuning(artifacts_path) -> Optional[dict]:
    p = Path(artifacts_path) / RETRIEVAL_TUNING_FILE
    if not p.exists():
        return None
    try:
        return json.loads(p.read_text())
    except (OSError, ValueError):
        return None  # unreadable records never block serving


def _pad_rows(x: np.ndarray) -> np.ndarray:
    pad = (-x.shape[0]) % _ROW_TILE
    if not pad:
        return x
    return np.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))


class RetrievalIndex:
    def __init__(
        self,
        doc_embeddings: np.ndarray,  # [N, H] f32 (host)
        storage_dtype: str = "bfloat16",  # 'float32' | 'bfloat16'
        device="cuda",
        mesh=None,
        index_type: str = "exact",
    ):
        if storage_dtype == "int8":
            raise NotImplementedError("int8 corpus storage is not ported yet (ROADMAP Queue 2)")
        if index_type != "exact":
            raise NotImplementedError("the IVF index is not ported yet (ROADMAP Queue 1, IVF)")
        if mesh is not None:
            raise NotImplementedError(
                "multi-device serving is not ported yet (ROADMAP Queue 1, multi-device)"
            )
        self.device = resolve_device(device)
        self.num_docs = int(doc_embeddings.shape[0])
        self.dim = int(doc_embeddings.shape[1])
        self.storage_dtype = storage_dtype
        # phase-2 strategy (ops.topk): re-score the winning segments or
        # gather their phase-1-cached scores
        self.phase2 = "rescore"
        self.sort_candidates = False
        self._n_valid = self.num_docs
        padded = _pad_rows(np.asarray(doc_embeddings, np.float32))
        self._docs = torch.from_numpy(padded).to(self.device).to(torch_dtype(storage_dtype))

    def search(self, query_embeddings: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """[B, H] queries -> ([B, k] scores, [B, k] doc ids), exact, sorted
        descending."""
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
        host fetch."""
        k = min(k, self.num_docs)
        return fused_topk_segmax(
            q.to(self._docs.dtype), self._docs, k=k, n_valid=self._n_valid,
            phase2=self.phase2, sort_candidates=self.sort_candidates,
        )

    def tuning_signature(self) -> dict:
        """What a persisted tuning decision is valid for."""
        return {
            "num_docs": self.num_docs,
            "dim": self.dim,
            "storage_dtype": self.storage_dtype,
            "index_type": "exact",
            "backend": self.device.type,
        }

    def decision(self) -> dict:
        return {"phase2": self.phase2, "sort_candidates": self.sort_candidates}

    def apply_decision(self, decision: dict) -> None:
        """Apply a persisted autotune decision (the caller has validated its
        signature)."""
        phase2 = str(decision.get("phase2", self.phase2))
        if phase2 in ("rescore", "gather"):  # anything else keeps the default
            self.phase2 = phase2
        self.sort_candidates = bool(decision.get("sort_candidates", self.sort_candidates))
