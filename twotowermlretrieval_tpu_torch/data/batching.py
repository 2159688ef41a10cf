"""Fixed-shape batching of corpus text for encoding (the part of the JAX
package's ``data/batching.py`` that serving and export need)."""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np

from twotowermlretrieval_tpu_torch.tokenizer import Tokenizer


def tokenize_corpus(
    documents: Sequence[str], tokenizer: Tokenizer, max_len: int, batch_size: int = 256
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (tokens [B, L], lengths [B], mask [B]) batches of a fixed
    size; the final batch is repeat-padded with its first text and the
    mask marks the real rows."""
    n = len(documents)
    for start in range(0, n, batch_size):
        chunk = list(documents[start : start + batch_size])
        real = len(chunk)
        while len(chunk) < batch_size:
            chunk.append(chunk[0])
        tokens, lengths = tokenizer.encode_batch(chunk, max_len)
        mask = (np.arange(batch_size) < real).astype(np.float32)
        yield tokens, lengths, mask
