"""Native TF-IDF vectorizer + sparse cosine scoring.

A copy of the JAX package's module (numpy + scipy only); its output must
stay bit-identical to that module's.

The reference leans on ``sklearn.TfidfVectorizer(stop_words='english',
max_features=20000)`` for its keyword channel (ref: backend/main.py:140-149)
and scores with ``sklearn.metrics.pairwise.cosine_similarity``
(ref: frontend/main.py:121-124, 170-171). This module is a self-contained
equivalent (numpy + scipy CSR) with matching semantics:

- token pattern ``(?u)\\b\\w\\w+\\b`` (two+ word chars), lowercased;
- English stop-word removal (the same Glasgow IR list);
- ``max_features`` selected by corpus-wide term frequency, ties broken
  alphabetically;
- smooth idf: ``idf = ln((1+n)/(1+df)) + 1``; tf = raw count;
- L2-normalized rows — so cosine similarity is a plain sparse dot product.

It exists (rather than importing sklearn) because the serving path must be
dependency-light and because the scoring side feeds the fused hybrid kernel.
Pickles of {'vectorizer', 'matrix'} keep the reference's artifact contract
(``tfidf_artifacts.pkl``, ref: backend/main.py:144-149).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import scipy.sparse as sp

from twotowermlretrieval_tpu_torch.ops._stopwords import ENGLISH_STOP_WORDS

_TOKEN_RE = re.compile(r"(?u)\b\w\w+\b")


def _analyze(text: str) -> List[str]:
    return [t for t in _TOKEN_RE.findall(str(text).lower()) if t not in ENGLISH_STOP_WORDS]


class TfidfVectorizer:
    """Drop-in for the subset of sklearn's API the reference uses:
    ``fit_transform``, ``transform``, plus ``vocabulary_`` / ``idf_``."""

    def __init__(self, max_features: Optional[int] = 20000):
        self.max_features = max_features
        self.vocabulary_: Dict[str, int] = {}
        self.idf_: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def fit_transform(self, documents: Sequence[str]) -> sp.csr_matrix:
        n_docs = len(documents)
        analyzed = [_analyze(d) for d in documents]

        # corpus-wide term frequency for max_features selection. Tie-breaking
        # replicates sklearn's `_limit_features` exactly: terms are laid out
        # alphabetically, then `argsort(-tf)` (unstable introsort) picks the
        # top columns — so pickled artifacts are interchangeable.
        term_freq: Dict[str, int] = {}
        for toks in analyzed:
            for t in toks:
                term_freq[t] = term_freq.get(t, 0) + 1
        terms = sorted(term_freq.keys())
        if self.max_features is not None and len(terms) > self.max_features:
            tfs = np.asarray([term_freq[t] for t in terms], dtype=np.int64)
            keep = np.sort(np.argsort(-tfs)[: self.max_features])
            terms = [terms[i] for i in keep]
        self.vocabulary_ = {t: i for i, t in enumerate(terms)}

        counts = self._count_matrix(analyzed)
        df = np.asarray((counts > 0).sum(axis=0)).ravel()
        self.idf_ = np.log((1.0 + n_docs) / (1.0 + df)) + 1.0
        return self._tfidf(counts)

    def transform(self, documents: Sequence[str]) -> sp.csr_matrix:
        if self.idf_ is None:
            raise RuntimeError("transform called before fit_transform")
        counts = self._count_matrix([_analyze(d) for d in documents])
        return self._tfidf(counts)

    # ------------------------------------------------------------------
    def _count_matrix(self, analyzed: Sequence[List[str]]) -> sp.csr_matrix:
        vocab = self.vocabulary_
        indptr = [0]
        indices: List[int] = []
        data: List[int] = []
        for toks in analyzed:
            row: Dict[int, int] = {}
            for t in toks:
                j = vocab.get(t)
                if j is not None:
                    row[j] = row.get(j, 0) + 1
            indices.extend(row.keys())
            data.extend(row.values())
            indptr.append(len(indices))
        return sp.csr_matrix(
            (np.asarray(data, np.float64), np.asarray(indices, np.int64), np.asarray(indptr, np.int64)),
            shape=(len(analyzed), len(vocab)),
        )

    def _tfidf(self, counts: sp.csr_matrix) -> sp.csr_matrix:
        tfidf = counts.multiply(self.idf_[None, :]).tocsr()
        # L2 row normalization (zero rows stay zero)
        norms = np.sqrt(np.asarray(tfidf.multiply(tfidf).sum(axis=1)).ravel())
        norms[norms == 0.0] = 1.0
        inv = sp.diags(1.0 / norms)
        return (inv @ tfidf).tocsr()


def cosine_similarity(a: sp.csr_matrix, b: sp.csr_matrix) -> np.ndarray:
    """Cosine similarity between two row-normalized sparse matrices.

    Both inputs coming from :class:`TfidfVectorizer` are already
    L2-normalized, so this is a sparse matmul — the same shortcut sklearn
    takes internally (ref usage: frontend/main.py:124, 171).
    """
    return np.asarray((a @ b.T).todense(), dtype=np.float64)


def hybrid_blend(dense_scores: np.ndarray, tfidf_scores: np.ndarray, alpha: float) -> np.ndarray:
    """``alpha * dense + (1 - alpha) * tfidf`` (ref: frontend/main.py:187)."""
    return alpha * np.asarray(dense_scores) + (1.0 - alpha) * np.asarray(tfidf_scores)
