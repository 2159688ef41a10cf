"""The driver of search cells: the engine's dense chain, one micro-batch at
a time from one client, back to back.

Each micro-batch runs the calls ``SearchEngine._dense_batch`` makes for a
full bucket: ``Tokenizer.encode_batch`` over the texts, the encoder's
tensors, ``_fused_encode_search`` (the query tower, then the index's
search) and one fetch of the packed result to the host. The index is a
``RetrievalIndex`` over the corpus rows the benchmark makes from the seed
(``harness/corpus.py``), exact, in the cell's storage dtype, on the fused
path (no autotune). A batch's latency runs from the start of its
tokenization to its results on the host.

Set-up makes the weights, the vocabulary, the rows and the index, and runs
``warm_batches`` batches. The window runs batches until ``seconds`` have
passed; a traced run then traces ``trace_batches`` more. After the window
the memory peak is read, the index freed, and the reference searches a
sample of the window's batches drawn from the seed (``sample_batches``).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmarks.harness import corpus
from benchmarks.harness.seeds import sub_seed
from benchmarks.harness.trace import span
from benchmarks.harness.traffic import QueryPool, vocabulary
from benchmarks.harness.weights import make_params


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of the values do not exceed."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


class SearchRun:
    def __init__(self, model: dict, mix: dict, cell: dict, seed: int, device,
                 storage_dtype: str = None):
        from twotowermlretrieval_tpu_torch.config import Config
        from twotowermlretrieval_tpu_torch.encoder import TextEncoder
        from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec
        from twotowermlretrieval_tpu_torch.serve.index import RetrievalIndex
        from twotowermlretrieval_tpu_torch.tokenizer import Tokenizer

        self.model, self.mix, self.cell, self.seed = model, mix, cell, seed
        self.dev = torch.device(device)
        self.config = Config.from_dict(model)
        self.spec = TwoTowerSpec.from_config(self.config)
        self.tokenizer = Tokenizer(vocabulary(int(model["VOCAB_SIZE"])))
        self.encoder = TextEncoder(make_params(model, seed, self.dev), self.spec, self.tokenizer,
                                   batch_size=self.config.batch_size,
                                   max_query_len=self.config.max_query_len,
                                   max_doc_len=self.config.max_doc_len, device=self.dev)
        self.n_rows, self.dim = int(cell["index_rows"]), int(model["HIDDEN_DIM"])
        rows = corpus.host_rows(self.n_rows, self.dim, seed, self.dev)
        self.index = RetrievalIndex(rows, storage_dtype=storage_dtype or cell["storage_dtype"],
                                    device=self.dev)
        del rows
        self.pool = QueryPool(mix, model, seed, self.dev)
        self.k = min(int(cell["k"]), self.index.num_docs)

    def batch(self, queries: List[str]):
        from twotowermlretrieval_tpu_torch.serve.engine import _fused_encode_search

        with span("bench.tokenize"):
            tokens, lengths = self.tokenizer.encode_batch(queries, self.encoder.max_query_len)
        with span("bench.encode_search"), torch.inference_mode():
            buf = _fused_encode_search(self.encoder.params,
                                       *self.encoder.tensors(tokens, lengths), spec=self.spec,
                                       k=self.k, index=self.index)
        with span("bench.fetch"):
            buf = buf.cpu().numpy()
        return buf[:, : self.k].copy(), buf[:, self.k :].view(np.int32).copy()

    def setup(self):
        self.stream = self.pool.stream()
        for _ in range(int(self.cell.get("warm_batches", 4))):
            self.batch(next(self.stream))

    def window(self, seconds: float) -> dict:
        lat, results = [], []
        queries = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            texts = next(self.stream)
            tb = time.perf_counter()
            scores, ids = self.batch(texts)
            lat.append(time.perf_counter() - tb)
            results.append((texts, scores, ids))
            queries += len(texts)
        wall = time.perf_counter() - t0
        self.results = results
        return {"wall_s": wall, "latencies_s": lat, "queries": queries, "batches": len(lat),
                "batch": self.pool.batch}

    def traced(self, batches: int, trace_path: str) -> int:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.dev.type == "cuda"
                                         else [])
        with profile(activities=acts) as prof:
            for _ in range(batches):
                with span("bench.batch"):
                    self.batch(next(self.stream))
        prof.export_chrome_trace(trace_path)
        return batches

    def free(self):
        self.index = self.encoder = self.stream = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, sample_batches: int = 8) -> Dict[str, float]:
        """The sampled batches' top-k against the reference's exact top-k.

        ``score_gap``: the largest gap between a returned score and the
        reference's score of the same id. ``rank_gap``: over the queries,
        the largest amount by which a returned id's reference score lies
        below the reference's k-th best (0 when every returned id is among
        the reference's top k, up to ties). An id out of range or returned
        twice reads infinite."""
        from benchmarks.reference.search import encode_queries, exact_top_k

        rng = np.random.default_rng(sub_seed(self.seed, "sample"))
        n = len(self.results)
        pick = sorted(rng.choice(n, size=min(sample_batches, n), replace=False))
        texts = [t for i in pick for t in self.results[i][0]]
        scores = np.concatenate([self.results[i][1] for i in pick])
        ids = np.concatenate([self.results[i][2] for i in pick]).astype(np.int64)
        q = encode_queries(make_params(self.model, self.seed, self.dev), texts,
                           {**vocabulary(int(self.model["VOCAB_SIZE"])),
                            "<UNK>": int(self.model["VOCAB_SIZE"]) - 1},
                           self.model, self.dev)
        best, _, of_ret = exact_top_k(
            q, lambda i: corpus.block(i, self.n_rows, self.dim, self.seed, self.dev),
            corpus.n_blocks(self.n_rows), self.k, torch.as_tensor(ids))
        of_ret = of_ret.cpu().double().numpy()
        kth = best[:, -1].cpu().double().numpy()
        dup = np.array([len(set(r)) < len(r) for r in ids])
        bad = (ids < 0) | (ids >= self.n_rows) | dup[:, None]
        score_gap = np.where(bad, np.inf, np.abs(scores - of_ret)).max()
        rank_gap = np.where(bad, np.inf, np.maximum(kth[:, None] - of_ret, 0.0)).max()
        return {"score_gap": float(score_gap), "rank_gap": float(rank_gap)}


def run_cell(cell: dict, model: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, tmpdir: str) -> dict:
    import os

    run = SearchRun(model, mix, cell, seed, device)
    run.setup()
    setup_s = time.perf_counter() - t_start
    win = run.window(seconds)
    out = {
        "e2e": {"search_qps": win["queries"] / win["wall_s"], "setup_s": setup_s},
        "window": win,
        "model": model,
    }
    if trace:
        path = os.path.join(tmpdir, f"bench_trace_{os.getpid()}.json")
        out["traced_batches"] = run.traced(int(cell.get("trace_batches", 100)), path)
        out["trace_path"] = path
    out["attempted"] = win["queries"]
    out["failed"] = sum(int(((ids < 0) | (ids >= run.n_rows)).any(axis=1).sum())
                        for _, _, ids in run.results)
    dev = torch.device(device)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                                else 0)
    run.free()
    out["numbers"] = run.check(int(cell.get("sample_batches", 8)))
    return out
