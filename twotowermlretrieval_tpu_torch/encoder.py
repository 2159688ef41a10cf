"""Batched host text -> embeddings encoder.

The port of the JAX package's ``encoder.py``: tokenize to fixed shapes,
run a tower on the device, return numpy embeddings. Batches come from a
fixed bucket set ({16, 128, corpus_batch_size} rows), the size the
recurrent kernel and the serving path were measured at; outputs are
fetched to the host in ~64 MB chunks and padding rows are dropped there.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from twotowermlretrieval_tpu_torch.data.batching import tokenize_corpus
from twotowermlretrieval_tpu_torch.models.two_tower import (
    TwoTowerSpec,
    encode_document,
    encode_query,
    to_device,
)
from twotowermlretrieval_tpu_torch.tokenizer import Tokenizer
from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device


def run_batched_encode(texts, tokenizer, max_len, bs, hidden_dim, dispatch):
    """Tokenize -> dispatch -> chunked fetch. ``dispatch(tokens, lengths)``
    returns a device [bs, H] tensor; results are gathered on the device
    and copied to the host once per ~64 MB, never per batch."""
    batches_per_chunk = max(1, (64 << 20) // (4 * hidden_dim * bs))
    host_chunks, dev_outs, masks = [], [], []

    def flush():
        if dev_outs:
            host_chunks.append(torch.cat(dev_outs).cpu().numpy())
            dev_outs.clear()

    for tokens, lengths, mask in tokenize_corpus(texts, tokenizer, max_len, bs):
        dev_outs.append(dispatch(tokens, lengths))
        masks.append(mask.astype(bool))
        if len(dev_outs) >= batches_per_chunk:
            flush()
    flush()
    if not host_chunks:
        return np.zeros((0, hidden_dim), np.float32)
    return np.concatenate(host_chunks, axis=0)[np.concatenate(masks)]


class TextEncoder:
    def __init__(
        self,
        params,
        spec: TwoTowerSpec,
        tokenizer: Tokenizer,
        batch_size: int = 256,
        max_query_len: int = 32,
        max_doc_len: int = 128,
        device="cuda",
    ):
        self.device = resolve_device(device)
        # weights go to the device once, not per batch
        self.params = to_device(params, self.device)
        self.spec = spec
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_query_len = max_query_len
        self.max_doc_len = max_doc_len
        self.corpus_batch_size = max(batch_size, 1024)

    def tensors(self, tokens: np.ndarray, lengths: np.ndarray):
        """Host token batch -> (tokens, lengths) int64 tensors on the device."""
        return (
            torch.from_numpy(tokens).to(self.device, torch.int64, non_blocking=True),
            torch.from_numpy(lengths).to(self.device, torch.int64, non_blocking=True),
        )

    def _run(self, texts: Sequence[str], fn, max_len: int) -> np.ndarray:
        if len(texts) <= 16:
            bs = 16
        elif len(texts) <= 128:
            bs = 128
        else:
            bs = self.corpus_batch_size
        with torch.inference_mode():
            return run_batched_encode(
                texts, self.tokenizer, max_len, bs, self.spec.hidden_dim,
                lambda tokens, lengths: fn(self.params, *self.tensors(tokens, lengths), self.spec),
            )

    def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        """[N, H] query-tower embeddings (zero vectors for token-less texts)."""
        return self._run(texts, encode_query, self.max_query_len)

    def encode_documents(self, texts: Sequence[str]) -> np.ndarray:
        """[N, H] doc-tower embeddings."""
        return self._run(texts, encode_document, self.max_doc_len)

    def encode_query(self, text: str) -> np.ndarray:
        return self.encode_queries([text])[0]
