"""Self-contained in-memory hybrid retriever (library path).

The port of the JAX package's ``serve/simple_hybrid.py``: fit on an
in-memory document list (TF-IDF with ``max_features`` terms + dense
embeddings), then ``search`` blends ``alpha * dense + (1 - alpha) *
tfidf`` and returns (document, score) pairs, best first. The documents go
through the doc tower (``doc_tower=True``, the serving export's path) or,
with ``doc_tower=False``, through the query tower.

The dense side is an exact search over the whole corpus (k = the number of
documents) in a :class:`RetrievalIndex`, f32 by default so that the scores
are the brute-force cosine's: on a card the ``segmax`` kernel's f32 route
and phase 2 over every segment. ``use_kernel`` and ``device`` are the
index's (the JAX package's ``use_pallas`` and ``interpret``).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from twotowermlretrieval_tpu_torch.ops.tfidf import (
    TfidfVectorizer,
    cosine_similarity,
    hybrid_blend,
)
from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex
from twotowermlretrieval_tpu_torch.serve.inferencer import QueryInferencer


class SimpleHybridRetriever:
    def __init__(
        self,
        artifacts_path: str | Path,
        alpha: float = 0.5,
        doc_tower: bool = True,
        max_features: int = 10000,
        use_kernel: Optional[bool] = None,
        storage_dtype: str = "float32",
        device="cuda",
    ):
        self.dense_retriever = QueryInferencer(artifacts_path, device=device)
        self.alpha = alpha
        self.doc_tower = doc_tower
        self.tfidf = TfidfVectorizer(max_features=max_features)
        self.documents: List[str] = []
        self.tfidf_matrix = None
        self.index: Optional[RetrievalIndex] = None
        self._use_kernel = use_kernel
        self._storage_dtype = storage_dtype
        self._device = device

    def fit(self, documents: List[str]) -> None:
        """Fit TF-IDF and embed the corpus into the index."""
        self.documents = list(documents)
        self.tfidf_matrix = self.tfidf.fit_transform(self.documents)
        if self.doc_tower:
            embs = self.dense_retriever.get_document_embeddings(self.documents)
        else:
            embs = self.dense_retriever.get_query_embeddings(self.documents)
        self.index = RetrievalIndex(
            embs, storage_dtype=self._storage_dtype, device=self._device,
            use_kernel=self._use_kernel,
        )

    def search(self, query: str, top_k: int = 10) -> List[Tuple[str, float]]:
        """(document, blended score) pairs, best first."""
        if self.index is None:
            raise RuntimeError("call fit() before search()")
        query_tfidf = self.tfidf.transform([query])
        tfidf_scores = cosine_similarity(query_tfidf, self.tfidf_matrix)[0]

        query_emb = self.dense_retriever.get_query_embedding(query)
        # the dense score of every document: an exact search at k = N
        k = len(self.documents)
        dense_ranked, ids = self.index.search(query_emb[None, :], k=k)
        dense_scores = np.zeros(k, np.float64)
        dense_scores[ids[0]] = dense_ranked[0]

        combined = hybrid_blend(dense_scores, tfidf_scores, self.alpha)
        order = np.argsort(combined)[::-1][:top_k]
        return [(self.documents[i], float(combined[i])) for i in order]
