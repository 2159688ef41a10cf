"""Word-level tokenizer over a pretrained (GloVe) vocabulary.

A copy of the Python path of the JAX package's tokenizer, kept here so the
port imports nothing from that package. Semantics: lowercase, regex
``\\w+|[.,!?;]``, dict lookup with OOV -> ``<UNK>`` (appended at the end of
the vocab if missing). Batches carry an explicit length channel; the pad id
only fills dead slots and is never used to infer lengths.

``encode_batch`` takes the C++ batch tokenizer (``native/``) first, as the
JAX package's does: rows with non-ASCII text, and machines where the
library cannot build, take the Python path, whose results the native path
reproduces exactly.
"""

from __future__ import annotations

import pickle
import re
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"\w+|[.,!?;]")

UNK_TOKEN = "<UNK>"
PAD_ID = 0  # fills dead slots only; masks carry the truth


def tokenize_text(text: str) -> List[str]:
    """Lowercase + regex split."""
    return _TOKEN_RE.findall(str(text).lower())


class Tokenizer:
    """Vocabulary-backed word tokenizer."""

    def __init__(self, word_to_idx: Dict[str, int]):
        self.word2idx = dict(word_to_idx)
        self.unk_token = UNK_TOKEN
        if self.unk_token not in self.word2idx:
            self.word2idx[self.unk_token] = len(self.word2idx)
        self.unk_token_id = self.word2idx[self.unk_token]
        self.idx2word = {idx: word for word, idx in self.word2idx.items()}

    # --- constructors ---------------------------------------------------
    @classmethod
    def from_pickle(cls, word_to_idx_path: str | Path) -> "Tokenizer":
        """Load a pickled word->index map (the artifact's word_to_idx.pkl)."""
        with open(word_to_idx_path, "rb") as f:
            return cls(pickle.load(f))

    @classmethod
    def from_corpus(cls, texts: Iterable[str], max_vocab: int | None = None) -> "Tokenizer":
        """Build a frequency-ordered vocab from raw text."""
        counts: Counter = Counter()
        for t in texts:
            counts.update(tokenize_text(t))
        words = [w for w, _ in counts.most_common(max_vocab)]
        return cls({w: i for i, w in enumerate(words)})

    def save(self, path: str | Path) -> None:
        """Persist the word->index map as a pickle (artifact contract)."""
        with open(path, "wb") as f:
            pickle.dump(self.word2idx, f)

    # --- lookup API ---------------------------------------------------------
    def encode(self, sentence: str) -> List[int]:
        """Token ids with OOV -> UNK."""
        return [self.word2idx.get(w, self.unk_token_id) for w in tokenize_text(sentence)]

    def decode(self, token_ids: Sequence[int]) -> str:
        return " ".join(self.idx2word.get(int(i), self.unk_token) for i in token_ids)

    def vocab_size(self) -> int:
        return len(self.word2idx)

    def get_word_index(self, word: str) -> int:
        return self.word2idx.get(word, -1)

    def get_index_word(self, index: int) -> str:
        return self.idx2word.get(int(index), self.unk_token)

    def contains_word(self, word: str) -> bool:
        return word in self.word2idx

    # --- batch API ------------------------------------------------------------
    def _get_native_vocab(self):
        """The C++ vocabulary, built once; None where the library is
        unavailable (``native.native_error()`` says why)."""
        if not hasattr(self, "_native_vocab"):
            from twotowermlretrieval_tpu_torch.native import native_available
            from twotowermlretrieval_tpu_torch.native.batch_tokenizer import NativeVocab

            self._native_vocab = (NativeVocab(self.word2idx, self.unk_token_id)
                                  if native_available() else None)
        return self._native_vocab

    def encode_batch(
        self, texts: Sequence[str], max_len: int, pad_id: int = PAD_ID, native: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Encode to a fixed-shape ``[B, max_len]`` int32 array + lengths.

        Sequences longer than ``max_len`` are truncated. Returns
        ``tokens`` int32 [B, max_len] and ``lengths`` int32 [B] (0 for
        texts without tokens; the towers encode those to exact zeros).
        ``native``: the C++ tokenizer first (rows it flags as non-ASCII
        are re-encoded here); False takes the Python path for every row.
        """
        vocab = self._get_native_vocab() if native else None
        if vocab is not None:
            tokens, lengths, ok = vocab.encode_batch(texts, max_len, pad_id)
            for row in np.nonzero(ok == 0)[0]:  # non-ASCII rows: exact unicode semantics
                ids = self.encode(texts[row])[:max_len]
                tokens[row, :] = pad_id
                tokens[row, : len(ids)] = ids
                lengths[row] = len(ids)
            return tokens, lengths
        batch = np.full((len(texts), max_len), pad_id, dtype=np.int32)
        lengths = np.zeros((len(texts),), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = self.encode(text)[:max_len]
            lengths[row] = len(ids)
            if ids:
                batch[row, : len(ids)] = ids
        return batch, lengths


# Alias matching the reference class name (ref: backend/tokenizer.py:6) so
# reference users find the familiar entry point.
class PretrainedTokenizer(Tokenizer):
    def __init__(self, word_to_idx_path: str | Path):
        with open(word_to_idx_path, "rb") as f:
            super().__init__(pickle.load(f))


def lengths_to_mask(lengths: np.ndarray, max_len: int) -> np.ndarray:
    """Boolean [B, max_len] validity mask from lengths (host-side helper)."""
    return np.arange(max_len)[None, :] < np.asarray(lengths)[:, None]
