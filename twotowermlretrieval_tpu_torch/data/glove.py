"""Pretrained (GloVe) embedding-table utilities.

The reference prepares the table in notebooks: it parses a GloVe ``.txt``
into ``embeddings.npy`` [V, D] + ``word_to_idx.pkl``
(ref: notebooks/embeddings_processing.ipynb cell 1) and at train time appends
a small random ``<UNK>`` row when the tokenizer vocab is one larger than the
table (ref: backend/main.py:176-182). We provide both as library functions.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Tuple

import numpy as np


def parse_glove_txt(path: str | Path) -> Tuple[np.ndarray, Dict[str, int]]:
    """Parse a GloVe text file: one ``word v1 v2 ...`` per line.

    Mirrors notebooks/embeddings_processing.ipynb cell 1 of the reference.
    Returns (embeddings [V, D] float32, word_to_idx).
    """
    vectors = []
    word_to_idx: Dict[str, int] = {}
    skipped = 0
    # Infer the vector dimension as the CONSENSUS over the first lines, not
    # just line 1 (ADVICE r2): a word2vec-style "count dim" header or a
    # first token containing spaces would otherwise silently poison the
    # whole parse (every later line misparsed or dropped as malformed).
    probe = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) >= 2:
                probe.append(len(parts) - 1)
            if len(probe) >= 16:
                break
    if not probe:
        raise ValueError(f"no parseable lines in GloVe file {path}")
    dim = max(set(probe), key=probe.count)
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < dim + 1:
                if len(parts) >= 2:
                    skipped += 1  # header / short line: not a dim-wide vector
                continue
            # the vector is the trailing `dim` fields; everything before is
            # the token — real GloVe files (840B) contain tokens WITH
            # spaces ('. . .', 'at name@domain.com …'), which a naive
            # parts[0]/parts[1:] split would feed into float parsing
            word = " ".join(parts[:-dim])
            if not word or word in word_to_idx:
                continue
            try:
                vec = np.asarray(parts[-dim:], dtype=np.float32)
            except ValueError:
                skipped += 1  # malformed line: wrong field count / bad float
                continue
            word_to_idx[word] = len(word_to_idx)
            vectors.append(vec)
    if skipped:
        print(f"parse_glove_txt: skipped {skipped} malformed lines")
    return np.stack(vectors), word_to_idx


def load_embedding_table(
    embeddings_path: str | Path,
    vocab_size: int,
    seed: int = 0,
) -> np.ndarray:
    """Load ``embeddings.npy`` and reconcile with the tokenizer vocab size.

    Reproduces the reference's UNK patch (ref: backend/main.py:176-182): if
    the vocab (which includes a late-appended ``<UNK>``) is larger than the
    table, extra rows are filled with small random vectors (scale 0.1). We
    use a seeded RNG instead of the reference's unseeded ``np.random.rand``
    so runs are reproducible.
    """
    table = np.load(embeddings_path).astype(np.float32)
    if vocab_size > len(table):
        rng = np.random.default_rng(seed)
        extra = rng.random((vocab_size - len(table), table.shape[1]), dtype=np.float32) * 0.1
        table = np.vstack([table, extra])
    elif vocab_size < len(table):
        raise ValueError(
            f"vocab_size {vocab_size} smaller than embedding table rows {len(table)}"
        )
    return table


def save_embedding_artifacts(
    out_dir: str | Path,
    embeddings: np.ndarray,
    word_to_idx: Dict[str, int],
) -> None:
    """Write the reference's two-file table format (embeddings.npy +
    word_to_idx.pkl)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / "embeddings.npy", embeddings.astype(np.float32))
    with open(out_dir / "word_to_idx.pkl", "wb") as f:
        pickle.dump(word_to_idx, f)
