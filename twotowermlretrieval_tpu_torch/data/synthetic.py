"""Synthetic MS MARCO-shaped data for tests and offline benchmarking.

The reference acquires MS MARCO v2.1 from the HuggingFace hub and GloVe from
a hub dataset (ref: notebooks/download_dataset.ipynb cell 1,
notebooks/embeddings_processing.ipynb cell 1). This build must run in
network-isolated environments, so we provide a generator that produces:

- parquet splits with the exact flattened schema the reference reads
  (``query``, ``passages.passage_text`` list[str], ``passages.is_selected``
  list[int] — ref: misc/inspect_data.ipynb cell 5);
- a GloVe-like ``embeddings.npy`` + ``word_to_idx.pkl`` pair
  (ref: notebooks/embeddings_processing.ipynb).

Text is topical: words are partitioned into topics, a query and its positive
passages draw from one topic, so a working retriever can demonstrably beat a
random-init baseline (the property the end-to-end tests assert).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


def _make_vocab(num_topics: int, words_per_topic: int) -> List[List[str]]:
    return [
        [f"t{topic}w{w}" for w in range(words_per_topic)]
        for topic in range(num_topics)
    ]


def generate_corpus(
    out_dir: str | Path,
    num_queries: int = 200,
    num_topics: int = 20,
    words_per_topic: int = 30,
    passages_per_query: int = 4,
    embed_dim: int = 32,
    seed: int = 0,
    query_len_range: Tuple[int, int] = (3, 8),
    passage_len_range: Tuple[int, int] = (8, 20),
) -> Dict[str, Path]:
    """Write synthetic train/validation/test parquet + embedding artifacts.

    ``query_len_range``/``passage_len_range`` shape the length histogram;
    the defaults are the small test corpus, while the e2e demo passes
    MS MARCO-like values (queries ~6 words, passages ~40-90 — ref:
    misc/inspect_data.ipynb schema stats).

    Returns a dict of the created paths (keys: train, validation, test,
    embeddings, word_to_idx).
    """
    import pandas as pd

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    topics = _make_vocab(num_topics, words_per_topic)

    def make_split(n: int, split_seed: int) -> pd.DataFrame:
        r = np.random.default_rng(split_seed)
        rows = []
        for qid in range(n):
            topic = int(r.integers(num_topics))
            tw = topics[topic]
            q_words = [tw[int(r.integers(words_per_topic))] for _ in range(r.integers(*query_len_range))]
            passages, selected = [], []
            for p in range(passages_per_query):
                p_words = [tw[int(r.integers(words_per_topic))] for _ in range(r.integers(*passage_len_range))]
                # sprinkle off-topic noise words
                noise_topic = int(r.integers(num_topics))
                p_words += [topics[noise_topic][int(r.integers(words_per_topic))] for _ in range(2)]
                passages.append(" ".join(p_words))
                selected.append(1 if p == 0 else 0)
            rows.append(
                {
                    "query": " ".join(q_words),
                    "query_id": qid,
                    "passages.passage_text": passages,
                    "passages.is_selected": selected,
                    "query_type": "description",
                }
            )
        return pd.DataFrame(rows)

    paths: Dict[str, Path] = {}
    for split, n, s in (
        ("train", num_queries, seed + 1),
        ("validation", max(num_queries // 4, 8), seed + 2),
        ("test", max(num_queries // 4, 8), seed + 3),
    ):
        path = out_dir / f"ms_marco_{split}.parquet"
        make_split(n, s).to_parquet(path)
        paths[split] = path

    # GloVe-like table: one row per word; words from the same topic share a
    # direction so frozen-embedding training has signal.
    word_to_idx: Dict[str, int] = {}
    vectors: List[np.ndarray] = []
    punct = [".", ",", "!", "?", ";"]
    topic_dirs = rng.normal(size=(num_topics, embed_dim)).astype(np.float32)
    for topic, words in enumerate(topics):
        for w in words:
            word_to_idx[w] = len(word_to_idx)
            vec = topic_dirs[topic] + 0.3 * rng.normal(size=embed_dim).astype(np.float32)
            vectors.append(vec.astype(np.float32))
    for p in punct:
        word_to_idx[p] = len(word_to_idx)
        vectors.append(rng.normal(size=embed_dim).astype(np.float32) * 0.1)
    embeddings = np.stack(vectors)

    from twotowermlretrieval_tpu_torch.data.glove import save_embedding_artifacts

    save_embedding_artifacts(out_dir, embeddings, word_to_idx)
    paths["embeddings"] = out_dir / "embeddings.npy"
    paths["word_to_idx"] = out_dir / "word_to_idx.pkl"
    return paths


def generate_filler_documents(
    n: int,
    num_topics: int,
    words_per_topic: int,
    len_range: Tuple[int, int] = (40, 90),
    seed: int = 1234,
) -> List[str]:
    """``n`` topical filler documents, vectorized draws (the e2e demo's
    1M-doc serving corpus — corpus scale beyond what the triplet splits
    contribute, same topic vocabulary so TF-IDF and the doc tower see
    in-distribution text)."""
    r = np.random.default_rng(seed)
    lens = r.integers(len_range[0], len_range[1], size=n)
    doc_topics = r.integers(num_topics, size=n)
    word_idx = r.integers(words_per_topic, size=int(lens.sum()))
    vocab = _make_vocab(num_topics, words_per_topic)
    docs: List[str] = []
    pos = 0
    for i in range(n):
        L = int(lens[i])
        tw = vocab[int(doc_topics[i])]
        docs.append(" ".join(map(tw.__getitem__, word_idx[pos:pos + L])))
        pos += L
    return docs


def synthetic_config(out_dir: str | Path, **overrides):
    """A Config wired to a generated corpus, small enough for CPU tests."""
    from twotowermlretrieval_tpu_torch.config import Config

    out_dir = Path(out_dir)
    base = dict(
        train_dataset_path=str(out_dir / "ms_marco_train.parquet"),
        val_dataset_path=str(out_dir / "ms_marco_validation.parquet"),
        test_dataset_path=str(out_dir / "ms_marco_test.parquet"),
        embeddings_path=str(out_dir / "embeddings.npy"),
        word_to_idx_path=str(out_dir / "word_to_idx.pkl"),
        subsample_ratio=None,
        hidden_dim=32,
        num_layers=1,
        bidirectional=False,
        dropout=0.0,
        batch_size=16,
        epochs=1,
        lr=1e-3,
        max_query_len=16,
        max_doc_len=32,
        compute_dtype="float32",
    )
    base.update(overrides)
    return Config(**base)
