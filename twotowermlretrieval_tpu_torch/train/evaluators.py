"""Evaluation protocols: the port of the JAX package's three evaluators.

- :class:`BatchEvaluator`: every validation query scored against every
  validation positive, the positive of query i at column i; MRR,
  Recall@{1,5,10} and the average validation triplet loss.
- :class:`CorpusEvaluator`: multi-positive protocol over at most
  ``max_candidates`` documents and ``max_queries`` sampled queries;
  Recall@k = found / available positives, Hit@k = any found, queries
  whose positives were sampled out of the pool skipped.
- :class:`TestEvaluator`: qualitative top-k printout with ground-truth
  markers.

Ranks and top-k run as tensor code on the evaluation device; top-k uses a
stable descending sort, so ties go to the lower index as ``lax.top_k``
orders them. Sampling uses the same seeded ``random.Random`` streams as
the JAX package, so both pick the same queries and candidates.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from twotowermlretrieval_tpu_torch.data.batching import pack_batch
from twotowermlretrieval_tpu_torch.encoder import TextEncoder
from twotowermlretrieval_tpu_torch.ops.topk import _stable_topk
from twotowermlretrieval_tpu_torch.parallel.mesh import put_global

Triplet = Tuple[str, str, str]


def _block_ranks(q_block: torch.Tensor, d_embs: torch.Tensor, offset: int) -> torch.Tensor:
    """Ranks (1-based) of each block query's positive, which sits at column
    ``offset + r``; exact ties rank as a stable descending sort would
    (equal scores at earlier columns first)."""
    sim = torch.matmul(q_block.float(), d_embs.float().T)
    rows = torch.arange(q_block.shape[0], device=sim.device)
    pos_col = offset + rows
    diag = sim[rows, pos_col]
    cols = torch.arange(sim.shape[1], device=sim.device)[None, :]
    greater = torch.sum(sim > diag[:, None], dim=1)
    ties_before = torch.sum((sim == diag[:, None]) & (cols < pos_col[:, None]), dim=1)
    return 1 + greater + ties_before


def ranks_of_diagonal(sim: np.ndarray) -> np.ndarray:
    """Rank (1-based) of sim[i, i] within row i, stable-sort tie handling."""
    diag = np.diag(sim)
    cols = np.arange(sim.shape[1])[None, :]
    pos_col = np.arange(sim.shape[0])[:, None]
    greater = (sim > diag[:, None]).sum(axis=1)
    ties_before = ((sim == diag[:, None]) & (cols < pos_col)).sum(axis=1)
    return 1 + greater + ties_before


class BatchEvaluator:
    """In-batch retrieval eval."""

    # row-block width of the rank computation: [block, N] similarities at
    # a time, not the full [N, N]
    rank_block_rows = 4096

    def __init__(self, top_k: Sequence[int] = (1, 5, 10)):
        self.top_k = tuple(top_k)

    def evaluate(self, eval_step, state, batcher, device, mesh=None
                 ) -> Tuple[Dict[str, float], float]:
        """eval_step: fn (state, packed [B, W] buffer on the device) ->
        (q_emb, pos_emb, {'val_loss'}) over the whole batch; batcher:
        TripletBatcher over the validation split. Each batch goes to
        ``device`` as one packed buffer (with a mesh, this rank's rows of
        it: the data-parallel eval step gathers the embeddings). Results
        stay on the device and are fetched once. Returns (metrics,
        avg_val_loss)."""
        dev_q, dev_p, masks = [], [], []
        dev_loss = None
        for batch in batcher.batches(seed=None):
            masks.append(batch.example_mask.astype(bool))
            q, p, m = eval_step(state, put_global(pack_batch(batch), mesh, device))
            dev_q.append(q)
            dev_p.append(p)
            dev_loss = m["val_loss"] if dev_loss is None else dev_loss + m["val_loss"]
        if not dev_q:
            return {}, 0.0
        real = torch.from_numpy(np.concatenate(masks)).to(device)
        q_embs = torch.cat(dev_q)[real]
        d_embs = torch.cat(dev_p)[real]
        ranks = torch.cat([
            _block_ranks(q_embs[i : i + self.rank_block_rows], d_embs, i)
            for i in range(0, q_embs.shape[0], self.rank_block_rows)
        ]).cpu().numpy()
        metrics = {f"Recall@{k}": float((ranks <= k).mean()) for k in self.top_k}
        metrics["MRR"] = float((1.0 / ranks).mean())
        return metrics, float(dev_loss) / len(dev_q)


def _topk(q_embs: np.ndarray, doc_embs: np.ndarray, k: int, device):
    sim = torch.matmul(torch.from_numpy(q_embs).to(device), torch.from_numpy(doc_embs).to(device).T)
    vals, idx = _stable_topk(sim, k)
    return vals.cpu().numpy(), idx.cpu().numpy()


class CorpusEvaluator:
    """Multi-positive corpus eval."""

    def __init__(self, top_k: Sequence[int] = (1, 5, 10), max_candidates: int = 1000,
                 max_queries: int = 50, seed: int = 0):
        self.top_k = tuple(top_k)
        self.max_candidates = max_candidates
        self.max_queries = max_queries
        self.seed = seed

    def evaluate(self, encoder: TextEncoder, val_data: Sequence[Triplet]) -> Dict[str, float]:
        if not val_data:
            return {}
        rng = random.Random(self.seed)

        # positives per query; pool = all unique docs, insertion-ordered
        query_to_positives: Dict[str, set] = {}
        all_docs: Dict[str, None] = {}
        for query, pos_doc, neg_doc in val_data:
            query_to_positives.setdefault(query, set()).add(pos_doc)
            all_docs.setdefault(pos_doc)
            all_docs.setdefault(neg_doc)
        unique_queries = list(query_to_positives.keys())
        unique_docs = list(all_docs.keys())
        if len(unique_docs) > self.max_candidates:
            unique_docs = rng.sample(unique_docs, self.max_candidates)

        doc_embs = encoder.encode_documents(unique_docs)
        doc_set = set(unique_docs)
        sample_queries = rng.sample(unique_queries, min(self.max_queries, len(unique_queries)))
        q_embs = encoder.encode_queries(sample_queries)
        k_max = min(max(self.top_k), len(unique_docs))
        _, top_idx = _topk(q_embs, doc_embs, k_max, encoder.device)

        metrics: Dict[str, List[float]] = {f"Recall@{k}": [] for k in self.top_k}
        metrics.update({f"Hit@{k}": [] for k in self.top_k})
        for qi, query in enumerate(sample_queries):
            known_positives = query_to_positives[query]
            available = [d for d in known_positives if d in doc_set]
            if not available:
                continue
            retrieved = [unique_docs[j] for j in top_idx[qi]]
            for k in self.top_k:
                found = sum(1 for d in retrieved[:k] if d in known_positives)
                metrics[f"Recall@{k}"].append(found / len(available))
                metrics[f"Hit@{k}"].append(1.0 if found > 0 else 0.0)
        return {name: float(np.mean(vals)) if vals else 0.0 for name, vals in metrics.items()}


class TestEvaluator:
    """Qualitative eval with ground-truth markers."""

    __test__ = False  # not a pytest class

    def __init__(self, num_examples: int = 10, top_k: int = 5, seed: int = 0):
        self.num_examples = num_examples
        self.top_k = top_k
        self.seed = seed

    def evaluate(self, encoder: TextEncoder, test_data: Sequence[Triplet],
                 print_fn=print) -> List[Dict]:
        if not test_data:
            return []
        rng = random.Random(self.seed)
        all_queries = list(dict.fromkeys(t[0] for t in test_data))
        all_docs: Dict[str, None] = {}
        ground_truth: Dict[str, set] = {}
        for query, pos_doc, neg_doc in test_data:
            ground_truth.setdefault(query, set()).add(pos_doc)
            all_docs.setdefault(pos_doc)
            all_docs.setdefault(neg_doc)
        unique_docs = list(all_docs.keys())

        doc_embs = encoder.encode_documents(unique_docs)
        sample_queries = rng.sample(all_queries, min(self.num_examples, len(all_queries)))
        q_embs = encoder.encode_queries(sample_queries)
        k = min(self.top_k, len(unique_docs))
        top_scores, top_idx = _topk(q_embs, doc_embs, k, encoder.device)

        results = []
        for qi, query in enumerate(sample_queries):
            positives = ground_truth.get(query, set())
            retrieved = []
            found = 0
            print_fn(f"\nQuery: {query}")
            for rank in range(k):
                doc = unique_docs[top_idx[qi, rank]]
                is_positive = doc in positives
                found += int(is_positive)
                marker = "+" if is_positive else "-"
                print_fn(f"  {rank + 1}. [{marker}] {doc[:100]} (score {top_scores[qi, rank]:.4f})")
                retrieved.append({"doc": doc, "score": float(top_scores[qi, rank]),
                                  "positive": is_positive})
            print_fn(f"  found {found}/{len(positives)} ground-truth positives in top {k}")
            results.append({"query": query, "retrieved": retrieved, "found": found,
                            "total_positives": len(positives)})
        return results
