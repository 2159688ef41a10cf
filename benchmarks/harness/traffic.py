"""The general traffic generator: reads a mix's parameters from
``traffic/<mix>.json`` and makes its rows from the seed.

A ``triplets`` mix is training data: (query, positive, negative) token
rows whose lengths follow clipped normals and whose ids are drawn by rank
from a Zipf law over the table's rows (id 0 is the padding id, so ranks
start at ``first_id``). The lengths come from a stream of their own that
the run's seed does not move (``length_seed``), so every seed trains on
the same set of shapes in the same order; the ids, and which rows form a
batch, come from the seed. Batches form as ``data/batching.py``'s ``TripletBatcher`` forms
them: each row goes to the smallest bucket width that holds
``max(pos_len, neg_len)``, batches form within a bucket, only full
batches are kept, and the batches' order is shuffled each epoch.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from benchmarks.harness.seeds import sub_seed


def clipped_normal_lengths(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    x = rng.normal(spec["mean"], spec["sd"], n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int32)


def zipf_ids(gen: torch.Generator, n_ranks: int, exponent: float, shape, device) -> torch.Tensor:
    """Ranks 0..n_ranks-1 drawn with P(rank r) proportional to
    (r + 1)^-exponent, by inverting the cumulative law."""
    w = torch.arange(1, n_ranks + 1, device=device, dtype=torch.float64) ** -float(exponent)
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    return torch.searchsorted(cdf, u.reshape(-1)).clamp_max(n_ranks - 1).reshape(shape)


class TripletPool:
    """A pool of ``pool_batches * batch_size`` triplet rows (host int32
    arrays in ``TripletBatcher``'s layout) and its batch stream."""

    def __init__(self, mix: dict, model: dict, seed: int, device):
        B = int(model["BATCH_SIZE"])
        Lq, Ld = int(model["MAX_QUERY_LEN"]), int(model["MAX_DOC_LEN"])
        n = int(mix["pool_batches"]) * B
        self.batch_size, self.seed = B, seed
        self.length_seed = int(mix["length_seed"])
        lrng = np.random.default_rng(self.length_seed)
        self.q_len = clipped_normal_lengths(lrng, mix["query_len"], n)
        self.pos_len = clipped_normal_lengths(lrng, mix["passage_len"], n)
        self.neg_len = clipped_normal_lengths(lrng, mix["passage_len"], n)
        first = int(mix["first_id"])
        ranks = int(model["VOCAB_SIZE"]) - first
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "ids"))
        toks = []
        for width, lens in ((Lq, self.q_len), (Ld, self.pos_len), (Ld, self.neg_len)):
            ids = zipf_ids(gen, ranks, mix["zipf_exponent"], (n, width), device) + first
            live = torch.arange(width, device=device)[None, :] < torch.as_tensor(
                lens, device=device)[:, None]
            toks.append(torch.where(live, ids, 0).to(torch.int32).cpu().numpy())
        self.q_tokens, self.pos_tokens, self.neg_tokens = toks
        edges = sorted({int(e) for e in model.get("LENGTH_BUCKETS") or [] if 0 < int(e) < Ld})
        self.edges = edges + [Ld]
        eff = np.maximum(self.pos_len, self.neg_len)
        self.bucket_of = np.minimum(np.searchsorted(np.asarray(self.edges), eff, side="left"),
                                    len(self.edges) - 1)
        # the full batches of each bucket, in row order; shuffled per epoch
        self.full = {b: int((self.bucket_of == b).sum()) // B for b in range(len(self.edges))}

    def widths(self) -> List[int]:
        """The doc widths that full batches of the pool take."""
        return [self.edges[b] for b, n in self.full.items() if n]

    def epoch_plans(self, epoch: int) -> List[Tuple[int, np.ndarray]]:
        """The epoch's batches as (bucket, rows). Which rows form a batch
        follows the seed; the order of the buckets' batches follows the
        length stream alone, so every seed runs the same widths in the
        same order."""
        rows = np.random.default_rng(sub_seed(self.seed, f"epoch{epoch}"))
        plans = []
        for b in range(len(self.edges)):
            members = np.nonzero(self.bucket_of == b)[0]
            rows.shuffle(members)
            for i in range(self.full[b]):
                plans.append((b, members[i * self.batch_size : (i + 1) * self.batch_size]))
        order = np.random.default_rng([self.length_seed, epoch]).permutation(len(plans))
        return [plans[i] for i in order]

    def batch(self, bucket: int, idx: np.ndarray):
        """``TripletBatcher._gather``: the program's ``Batch`` of these rows."""
        from twotowermlretrieval_tpu_torch.data.batching import Batch

        w = self.edges[bucket]
        return Batch(q_tokens=self.q_tokens[idx], q_len=self.q_len[idx],
                     pos_tokens=self.pos_tokens[idx, :w], pos_len=self.pos_len[idx],
                     neg_tokens=self.neg_tokens[idx, :w], neg_len=self.neg_len[idx],
                     example_mask=np.ones(len(idx), np.float32))

    def batches(self) -> Iterator:
        """The endless batch stream: epoch after epoch over the pool."""
        epoch = 0
        while True:
            for bucket, idx in self.epoch_plans(epoch):
                yield self.batch(bucket, idx)
            epoch += 1



def vocabulary(V: int) -> dict:
    """The serving vocabulary of a V-row table: ``<pad>`` at 0, the word
    ``w<i>`` at row i up to V-2; the tokenizer appends ``<UNK>`` at V-1."""
    return {"<pad>": 0, **{f"w{i}": i for i in range(1, V - 1)}}


class QueryPool:
    """A pool of ``pool_batches`` micro-batches of ``batch`` text queries:
    word counts from a clipped normal (a stream the seed does not move),
    words drawn by Zipf rank over the vocabulary's words from the seed."""

    def __init__(self, mix: dict, model: dict, seed: int, device):
        B, n_batches = int(mix["batch"]), int(mix["pool_batches"])
        n = B * n_batches
        lens = clipped_normal_lengths(np.random.default_rng(int(mix["length_seed"])),
                                      mix["query_len"], n)
        first = int(mix["first_id"])
        ranks = int(model["VOCAB_SIZE"]) - 1 - first
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "queries"))
        width = int(mix["query_len"]["max"])
        ids = (zipf_ids(gen, ranks, mix["zipf_exponent"], (n, width), device) + first).cpu()
        ids = ids.numpy()
        texts = [" ".join(f"w{i}" for i in ids[r, : lens[r]]) for r in range(n)]
        self.batches = [texts[b * B : (b + 1) * B] for b in range(n_batches)]
        self.batch = B

    def stream(self) -> Iterator[List[str]]:
        while True:
            yield from self.batches
