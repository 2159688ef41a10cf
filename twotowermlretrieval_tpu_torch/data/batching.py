"""Fixed-shape batching of triplets for training, and of corpus text for
encoding.

A copy of the JAX package's ``data/batching.py`` (host numpy, no JAX in
it), with the same determinism contract: each split is tokenized once
into fixed-width int32 arrays; every batch is ``[B, width]``, the final
partial batch of a bucket repeat-padded with its first row and marked by
``example_mask``; with ``length_buckets`` triplets go to the smallest
width that holds ``max(pos_len, neg_len)``, batches form within buckets,
and the bucket order is shuffled with the same seed.

The JAX package's prefetch helpers (device puts of packed buffers) have no
counterpart: the training loop copies each packed group to the device
itself (``train/loop.py``).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from twotowermlretrieval_tpu_torch.tokenizer import Tokenizer

Triplet = Tuple[str, str, str]


class Batch(NamedTuple):
    """One static-shape training batch (numpy on the host, tensors on the
    device)."""

    q_tokens: np.ndarray  # int32 [B, Lq]
    q_len: np.ndarray  # int32 [B]
    pos_tokens: np.ndarray  # int32 [B, Ld]
    pos_len: np.ndarray  # int32 [B]
    neg_tokens: np.ndarray  # int32 [B, Ld]
    neg_len: np.ndarray  # int32 [B]
    example_mask: np.ndarray  # float32 [B] — 0 for repeated padding rows


class TripletBatcher:
    """Pre-tokenized, shuffled, fixed-shape batch source (see the module
    docstring)."""

    def __init__(
        self,
        triplets: Sequence[Triplet],
        tokenizer: Tokenizer,
        batch_size: int,
        max_query_len: int = 32,
        max_doc_len: int = 128,
        drop_remainder: bool = False,
        length_buckets: Optional[Sequence[int]] = None,
    ):
        self.batch_size = int(batch_size)
        self.drop_remainder = drop_remainder
        self.num_examples = len(triplets)

        queries = [t[0] for t in triplets]
        positives = [t[1] for t in triplets]
        negatives = [t[2] for t in triplets]
        self.q_tokens, self.q_len = tokenizer.encode_batch(queries, max_query_len)
        self.pos_tokens, self.pos_len = tokenizer.encode_batch(positives, max_doc_len)
        self.neg_tokens, self.neg_len = tokenizer.encode_batch(negatives, max_doc_len)

        if length_buckets:
            # user edges strictly inside (0, max_doc_len); the terminal
            # bucket is always max_doc_len, so oversized or duplicate edges
            # can neither drop the full-width bucket nor truncate docs
            edges = sorted({int(e) for e in length_buckets if 0 < int(e) < max_doc_len})
            self.bucket_edges = edges + [max_doc_len]
        else:
            self.bucket_edges = [max_doc_len]
        eff_len = np.maximum(self.pos_len, self.neg_len)
        # smallest edge >= effective doc length
        self._bucket_of = np.searchsorted(np.asarray(self.bucket_edges), eff_len, side="left")
        self._bucket_of = np.minimum(self._bucket_of, len(self.bucket_edges) - 1)

    def _num_batches_in(self, count: int) -> int:
        if self.drop_remainder:
            return count // self.batch_size
        return -(-count // self.batch_size)

    def __len__(self) -> int:
        if len(self.bucket_edges) == 1:
            return self._num_batches_in(self.num_examples)
        return sum(
            self._num_batches_in(int((self._bucket_of == b).sum()))
            for b in range(len(self.bucket_edges))
        )

    def batches(self, seed: Optional[int] = None) -> Iterator[Batch]:
        """Yield batches; ``seed`` given -> shuffled (train), None -> in
        order (eval)."""
        rng = np.random.default_rng(seed) if seed is not None else None

        plans = []  # (bucket, index array, mask) per batch
        for b in range(len(self.bucket_edges)):
            members = np.nonzero(self._bucket_of == b)[0]
            if rng is not None:
                rng.shuffle(members)
            B = self.batch_size
            num_full = len(members) // B
            for i in range(num_full):
                plans.append((b, members[i * B : (i + 1) * B], np.ones(B, np.float32)))
            rem = len(members) - num_full * B
            if rem and not self.drop_remainder:
                idx = members[num_full * B :]
                # pad to full width with repeats of the first remainder row;
                # example_mask zeroes their loss/metric contribution
                pad = np.full(B - rem, idx[0], dtype=idx.dtype)
                mask = np.concatenate([np.ones(rem, np.float32), np.zeros(B - rem, np.float32)])
                plans.append((b, np.concatenate([idx, pad]), mask))

        if rng is not None:
            rng.shuffle(plans)
        for bucket, idx, mask in plans:
            yield self._gather(idx, mask, self.bucket_edges[bucket])

    def _gather(self, idx: np.ndarray, mask: np.ndarray, doc_width: int) -> Batch:
        return Batch(
            q_tokens=self.q_tokens[idx],
            q_len=self.q_len[idx],
            pos_tokens=self.pos_tokens[idx, :doc_width],
            pos_len=self.pos_len[idx],
            neg_tokens=self.neg_tokens[idx, :doc_width],
            neg_len=self.neg_len[idx],
            example_mask=mask,
        )


def pack_batch(batch: Batch) -> np.ndarray:
    """Flatten a host Batch into one int32 array [B, Lq + 2*Ld + 4]:
    q_tokens | pos_tokens | neg_tokens | q_len | pos_len | neg_len |
    example_mask (0/1), so a step ships one buffer to the device."""
    cols = [
        batch.q_tokens,
        batch.pos_tokens,
        batch.neg_tokens,
        batch.q_len[:, None],
        batch.pos_len[:, None],
        batch.neg_len[:, None],
        batch.example_mask.astype(np.int32)[:, None],
    ]
    return np.concatenate([np.asarray(c, np.int32) for c in cols], axis=1)


def unpack_batch(packed, max_query_len: int) -> Batch:
    """Inverse of :func:`pack_batch`, on a numpy array or a tensor (views,
    no copies); the mask comes back as float32."""
    W = packed.shape[1]
    Lq = max_query_len
    Ld = (W - Lq - 4) // 2
    tail = packed[:, Lq + 2 * Ld :]
    mask = tail[:, 3]
    mask = mask.astype(np.float32) if isinstance(mask, np.ndarray) else mask.float()
    return Batch(
        q_tokens=packed[:, :Lq],
        q_len=tail[:, 0],
        pos_tokens=packed[:, Lq : Lq + Ld],
        pos_len=tail[:, 1],
        neg_tokens=packed[:, Lq + Ld : Lq + 2 * Ld],
        neg_len=tail[:, 2],
        example_mask=mask,
    )


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
