"""Hybrid search engine: dense top-k -> TF-IDF blend -> ranked results.

The port of the JAX package's ``serve/engine.py``, with the same two
/search branches:

- ``alpha == 0.0`` -> pure corpus-wide keyword search: TF-IDF cosine
  against the full matrix, top-10, scores <= 1e-5 dropped;
- otherwise -> hybrid: query-tower embedding, exact dense top-``fanout``
  (50) from the device index, TF-IDF cosine of those docs from the
  precomputed matrix, ``final = alpha * dense + (1 - alpha) * tfidf``,
  sort, top-10.

A micro-batch of queries is encoded and searched as one chain of device
work (query tower with the recurrent kernel, then the index's segment-max
scan, bf16 or int8, and phase 2) ending in one host fetch of a packed
[rows, 2k] f32 buffer. With ``autotune_retrieval`` the engine times the
index's search variants at boot and persists the winner with the
artifacts; a later boot applies a persisted decision whose signature
matches, without timing.

``index_type="ivf"`` serves the approximate IVF index (``ops/ivf.py``):
the prebuilt ``ivf_index.npz`` of the artifacts when there is one, else
one clustered at boot; its probe width is an explicit ``nprobe``, else the
one ``ttr-torch-build-index --target-recall`` persisted for this corpus,
else 16. With a ``mesh`` (``parallel/mesh.py`` ``DeviceMesh``) the index
splits over its 'data' axis and the query tower and TF-IDF run on its lead
device. ``profile_dir`` writes a ``torch.profiler`` trace of the first
``profile_requests`` live searches (cache hits do no device work and do
not count); ``close()`` finalizes an unfilled window.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from twotowermlretrieval_tpu_torch.models.two_tower import encode_query
from twotowermlretrieval_tpu_torch.ops.tfidf import cosine_similarity, hybrid_blend
from twotowermlretrieval_tpu_torch.serve.index import (
    RetrievalIndex,
    load_retrieval_tuning,
    save_retrieval_tuning,
    variant_name,
)
from twotowermlretrieval_tpu_torch.serve.inferencer import QueryInferencer
from twotowermlretrieval_tpu_torch.train.artifacts import load_artifacts
from twotowermlretrieval_tpu_torch.utils.profiling import TraceWindow, annotate


def _fused_encode_search(params, tokens, lengths, spec, k, index: RetrievalIndex):
    """Encode + search for one padded micro-batch -> [rows, 2k] f32 device
    buffer = [scores | int32 ids reinterpreted as f32]."""
    emb = encode_query(params, tokens, lengths, spec)
    vals, ids = index.traced_search(emb, k)
    return torch.cat([vals[:, :k].float(), ids[:, :k].to(torch.int32).view(torch.float32)], dim=1)


class _MicroBatcher:
    """Coalesce concurrent calls into one device batch (leader pattern).

    The first caller to arrive becomes the leader: it waits ``window_ms``
    collecting followers, snapshots the queue, runs ``fn`` once over the
    whole batch and distributes results. A caller arriving after the
    snapshot finds an empty queue and becomes the next leader, so no
    request is ever dropped.
    """

    def __init__(self, fn, window_ms: float = 2.0, max_wait_s: float = 30.0):
        self._fn = fn
        self._window = window_ms / 1000.0
        self._max_wait = max_wait_s
        self._lock = threading.Lock()
        self._items: list = []

    def submit(self, request):
        event = threading.Event()
        slot: Dict = {}
        with self._lock:
            self._items.append((request, event, slot))
            is_leader = len(self._items) == 1
        if is_leader:
            time.sleep(self._window)
            with self._lock:
                batch, self._items = self._items, []
            try:
                results = self._fn([b[0] for b in batch])
                for (_, ev, sl), r in zip(batch, results):
                    sl["result"] = r
                    ev.set()
            except BaseException as e:  # noqa: BLE001 — followers must never hang
                for _, ev, sl in batch:
                    sl["error"] = e
                    ev.set()
                if not isinstance(e, Exception):
                    raise  # re-raise KeyboardInterrupt/SystemExit in the leader
        if not event.wait(self._max_wait):
            raise TimeoutError("micro-batch leader did not complete in time")
        if "error" in slot:
            raise slot["error"]
        return slot["result"]


class SearchEngine:
    def __init__(
        self,
        artifacts_path: str | Path,
        device="cuda",
        mesh=None,  # a DeviceMesh: the corpus splits over its devices (device: its lead)
        storage_dtype: str = "bfloat16",
        batch_window_ms: float = 0.0,  # >0 enables request micro-batching
        index_type: str = "exact",  # 'exact' | 'ivf'
        nprobe: Optional[int] = None,  # None: the persisted tuning's, else 16
        warmup: Optional[bool] = None,  # run every micro-batch bucket once up front
        cache_size: int = 0,  # >0 enables the LRU response cache
        use_kernel: Optional[bool] = None,  # None: the fused path where the index is on a card
        autotune_retrieval: bool = False,  # time the search variants at boot, persist the winner
        profile_dir: Optional[str] = None,  # trace the first profile_requests live searches
        profile_requests: int = 20,
    ):
        loaded = load_artifacts(artifacts_path, require_index=True)
        self.config = loaded.config
        self.documents = loaded.documents
        self.tfidf_vectorizer = loaded.tfidf_vectorizer
        self.tfidf_matrix = loaded.tfidf_matrix
        if mesh is not None:
            device = mesh.lead
        self.inferencer = QueryInferencer(artifacts_path, device=device)
        tuning = load_retrieval_tuning(artifacts_path)
        if nprobe is None:
            # the value ttr-torch-build-index measured for this corpus's shape
            sig = (tuning or {}).get("nprobe_signature", {})
            shape_ok = (sig.get("num_docs") == int(loaded.doc_embeddings.shape[0])
                        and sig.get("dim") == int(loaded.doc_embeddings.shape[1]))
            persisted = (tuning or {}).get("nprobe")
            nprobe = persisted if (persisted and shape_ok) else 16
        self.index = RetrievalIndex(
            loaded.doc_embeddings, storage_dtype=storage_dtype, device=device, mesh=mesh,
            index_type=index_type, use_kernel=use_kernel, nprobe=nprobe,
            # a prebuilt index exported with the artifacts skips k-means at boot
            ivf_index=loaded.ivf_index if index_type == "ivf" else None,
        )
        if autotune_retrieval:
            self._autotune(artifacts_path)
        elif tuning and tuning.get("decision") and use_kernel is None:
            # a previous --autotune-retrieval boot persisted its winner; it
            # applies only if it was measured for this corpus and backend
            if tuning.get("decision_signature") == self.index.tuning_signature():
                self.index.apply_decision(tuning["decision"])
                print(f"retrieval tuning: applied the persisted decision "
                      f"({self._chosen()}), no timing at startup")
            else:
                print("retrieval tuning: the persisted record is stale (corpus or "
                      "backend signature differs); serving with the defaults, re-run "
                      "with --autotune-retrieval to refresh it")
        self._batcher = (
            _MicroBatcher(self._dense_batch, window_ms=batch_window_ms)
            if batch_window_ms > 0
            else None
        )
        # Opt-in LRU cache of ranked results keyed on the full request;
        # engine state is read-only after init, so entries never go stale.
        self._cache: "Optional[OrderedDict]" = OrderedDict() if cache_size > 0 else None
        self._cache_size = cache_size
        self._cache_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        # one device chain at a time: concurrent HTTP threads share the
        # kernels' stream and the index
        self._device_lock = threading.Lock()
        self._searches = 0
        self._cache_hits = 0
        # the trace starts at the first live search, after the warm-up
        self._profile = (TraceWindow(profile_dir, int(profile_requests), what="live searches")
                         if profile_dir else None)
        warmup = warmup if warmup is not None else batch_window_ms > 0
        if warmup:
            for bucket in self._BATCH_BUCKETS:
                self._dense_batch([{"query": "warmup", "fanout": 50}] * bucket)

    def _chosen(self) -> str:
        """The search variant the index serves with."""
        if self.index.index_type == "ivf":
            return f"ivf, nprobe={self.index.nprobe}"
        if not self.index.kernel_on():
            return "two-phase"
        return f"phase2={variant_name(self.index.phase2, self.index.sort_candidates)}"

    def _autotune(self, artifacts_path) -> None:
        """Time the search variants on the live corpus, keep the fastest
        and persist it with the artifacts: the next boot without
        ``--autotune-retrieval`` applies it and times nothing."""
        timings = self.index.autotune()
        if not timings:
            print("retrieval autotune: no-op, the fused path is off for this index "
                  "(mesh serving, an IVF index, use_kernel=False, or a CPU index); "
                  "serving with the defaults")
            return
        named = {variant_name(p, s): t * 1e3 for (p, s), t in timings.items()}
        save_retrieval_tuning(artifacts_path, {
            "decision_signature": self.index.tuning_signature(),
            "decision": self.index.decision(),
            "timings_ms": named,
        })
        print("retrieval autotune: "
              + ", ".join(f"{name} {ms:.3f} ms" for name, ms in sorted(named.items()))
              + f" -> serving with {self._chosen()}")

    def close(self):
        """End-of-life hook of the serving CLI: finalize an unfilled
        profiler window (the trace is only written at stop)."""
        if self._profile is not None:
            self._profile.close()

    def counters(self) -> Dict[str, int]:
        """Engine-level counters for the /metrics surface."""
        with self._stats_lock:
            return {"searches_total": self._searches, "cache_hits_total": self._cache_hits}

    # Micro-batch sizes are bucketed; encode rows are at least 16 (the
    # recurrent kernel's block of batch rows), so {1, 8, 16} share a shape.
    _BATCH_BUCKETS = (1, 8, 16, 32)

    def _dense_batch(self, requests: Sequence[Dict]):
        """One batched encode + index search for many concurrent requests,
        each a dict {'query', 'fanout'}. The batch is padded up to a bucket
        (repeating the first query; those rows' results are dropped);
        bursts wider than the largest bucket are split."""
        cap = self._BATCH_BUCKETS[-1]
        if len(requests) > cap:
            results = []
            for i in range(0, len(requests), cap):
                results.extend(self._dense_batch(requests[i : i + cap]))
            return results
        fanout = max(r["fanout"] for r in requests)
        queries = [r["query"] for r in requests]
        bucket = next(b for b in self._BATCH_BUCKETS if b >= len(queries))
        rows = max(bucket, 16)
        padded = queries + [queries[0]] * (rows - len(queries))
        encoder = self.inferencer.encoder
        tokenizer = self.inferencer.tokenizer
        with annotate("ttr.search.tokenize"):
            tokens, lengths = tokenizer.encode_batch(padded, encoder.max_query_len)
        kk = min(fanout, self.index.num_docs)
        with self._device_lock, torch.inference_mode():
            buf = _fused_encode_search(
                encoder.params, *encoder.tensors(tokens, lengths),
                spec=self.inferencer.spec, k=kk, index=self.index,
            )
            with annotate("ttr.search.fetch"):
                buf = buf.cpu().numpy()
        scores, ids = buf[:, :kk], buf[:, kk:].view(np.int32)
        return [
            (scores[i, : r["fanout"]], ids[i, : r["fanout"]])
            for i, r in enumerate(requests)
        ]

    def _dense_search(self, query: str, fanout: int):
        if self._batcher is not None:
            return self._batcher.submit({"query": query, "fanout": fanout})
        return self._dense_batch([{"query": query, "fanout": fanout}])[0]

    # ------------------------------------------------------------------
    def search(self, query: str, alpha: float = 0.5, top_k: int = 10, fanout: int = 50) -> Dict:
        """One query -> {query, alpha, took_ms, results: [{rank, id, doc,
        score, dense_score, tfidf_score}]}."""
        start = time.time()
        key = (query, alpha, top_k, fanout)
        results = None
        if self._cache is not None:
            with self._cache_lock:
                if key in self._cache:
                    self._cache.move_to_end(key)
                    results = self._cache[key]
        with self._stats_lock:
            self._searches += 1
            self._cache_hits += results is not None
        if results is None:
            # only live searches count against the profiler window
            with self._profile.event() if self._profile is not None \
                    else contextlib.nullcontext():
                if alpha == 0.0:
                    results = self._keyword_search(query, top_k)
                else:
                    results = self._hybrid_search(query, alpha, top_k, fanout)
            if self._cache is not None:
                with self._cache_lock:
                    self._cache[key] = results
                    while len(self._cache) > self._cache_size:
                        self._cache.popitem(last=False)
        elapsed_ms = (time.time() - start) * 1000
        return {
            "query": query,
            "alpha": alpha,
            "took_ms": elapsed_ms,
            "results": [
                {"rank": i + 1, "id": f"result-{i + 1}", **res}
                for i, res in enumerate(results)
            ],
        }

    # ------------------------------------------------------------------
    def _keyword_search(self, query: str, top_k: int) -> List[Dict]:
        """Pure TF-IDF branch (no device work)."""
        query_tfidf = self.tfidf_vectorizer.transform([query])
        all_sims = cosine_similarity(query_tfidf, self.tfidf_matrix).ravel()
        if len(all_sims) > top_k:
            top = np.argpartition(all_sims, -top_k)[-top_k:]
            order = top[np.argsort(all_sims[top])[::-1]]
        else:
            order = np.argsort(all_sims)[::-1]
        results = []
        for idx in order:
            score = float(all_sims[idx])
            if score > 1e-5:  # only actual keyword matches
                results.append(
                    {"doc": self.documents[idx], "score": score,
                     "dense_score": 0.0, "tfidf_score": score}
                )
        return results

    def _hybrid_search(self, query: str, alpha: float, top_k: int, fanout: int) -> List[Dict]:
        """Dense top-fanout + TF-IDF re-rank."""
        dense_scores, doc_ids = self._dense_search(query, fanout)
        valid = doc_ids >= 0  # -1 pads a corpus smaller than fanout
        dense_scores, doc_ids = dense_scores[valid], doc_ids[valid]
        if doc_ids.size == 0:
            return []
        with annotate("ttr.search.blend"):
            query_tfidf = self.tfidf_vectorizer.transform([query])
            if query_tfidf.nnz > 0:
                doc_rows = self.tfidf_matrix[doc_ids]
                tfidf_scores = np.nan_to_num(cosine_similarity(query_tfidf, doc_rows)[0])
            else:
                tfidf_scores = np.zeros(len(doc_ids))
            final = hybrid_blend(dense_scores, tfidf_scores, alpha)
            order = np.argsort(final)[::-1][:top_k]
        return [
            {
                "doc": self.documents[doc_ids[i]],
                "score": float(final[i]),
                "dense_score": float(dense_scores[i]),
                "tfidf_score": float(tfidf_scores[i]),
            }
            for i in order
        ]
