"""Dataset / embedding-table inspection and length-bucket suggestion.

First-class equivalent of the reference's inspection notebook
(ref: misc/inspect_data.ipynb — parquet schema and row counts in cells
4-9, vocab/embedding shape and the pad/unk patch in cell 12), plus the
piece this build actually needs it for: SURVEY §7 says bucket edges
should come from the measured MS MARCO length histogram, because
bucketed static padding trades recompilation for padded-FLOP waste.
``--suggest-buckets K`` computes the K doc-width edges that minimize
total padded tokens — an exact interval-partition DP over the clipped
length histogram, not a quantile eyeball.

Usage:
    ttr-inspect-data --config config.json
    ttr-inspect-data --data-dir data --suggest-buckets 3
    ttr-inspect-data --config config.json --json  # machine-readable

The report covers, per split: row counts, invalid rows (the loader's
validity filter, ref: data_loader.py:31-35), passages-per-query stats,
``is_selected`` coverage (ranking-mode feasibility, ref:
data_loader.py:72-99), and token-length percentiles for queries and
passages. For the embedding table: shape/dtype, vocab-size agreement
with word_to_idx (the condition behind the reference's <UNK> patch,
ref: backend/main.py:176-182), and row-norm stats.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_PCTS = (50, 90, 99, 100)


def _percentiles(values: Sequence[int]) -> Dict[str, int]:
    if not len(values):
        return {f"p{p}": 0 for p in _PCTS}
    arr = np.asarray(values)
    return {f"p{p}": int(np.percentile(arr, p)) for p in _PCTS}


def inspect_split(path: str, tokenizer=None, max_rows: Optional[int] = None) -> Dict:
    """Schema and content statistics for one parquet split.

    Token lengths use the real tokenizer when available (OOV rate comes
    free), else the same regex without a vocab (ref: tokenizer.py:41 —
    ``\\w+|[.,!?;]``), so the numbers match what training will see.
    """
    import pandas as pd

    from twotowermlretrieval_tpu_torch.data.loader import _extract_columns
    from twotowermlretrieval_tpu_torch.tokenizer import tokenize_text

    df = pd.read_parquet(path)
    total_rows = len(df)
    if max_rows is not None and total_rows > max_rows:
        df = df.head(max_rows)

    queries, texts, selected = _extract_columns(df)

    q_lens: List[int] = []
    p_lens: List[int] = []
    n_passages: List[int] = []
    invalid = 0
    with_selected = 0
    oov = 0
    tokens_seen = 0

    def token_ids(text: str) -> List[int]:
        if tokenizer is not None:
            return tokenizer.encode(text)
        return list(range(len(tokenize_text(text))))  # length only

    unk_id = tokenizer.unk_token_id if tokenizer is not None else -1

    for query, passages, sel in zip(queries, texts, selected if selected is not None else [None] * len(df)):
        # the loader's validity filter (ref: data_loader.py:31-35)
        if not isinstance(query, str) or not query or not passages:
            invalid += 1
            continue
        ids = token_ids(query)
        q_lens.append(len(ids))
        if tokenizer is not None:
            oov += sum(1 for i in ids if i == unk_id)
            tokens_seen += len(ids)
        n_passages.append(len(passages))
        for p in passages:
            if isinstance(p, str) and p:
                pids = token_ids(p)
                p_lens.append(len(pids))
                if tokenizer is not None:
                    oov += sum(1 for i in pids if i == unk_id)
                    tokens_seen += len(pids)
        if sel is not None and any(int(s) == 1 for s in sel):
            with_selected += 1

    valid = len(q_lens)
    return {
        "path": str(path),
        "rows": total_rows,
        "rows_inspected": len(df),
        "invalid_rows": invalid,
        "passages_per_query": _percentiles(n_passages),
        "queries_with_is_selected": with_selected,
        "ranking_mode_feasible_frac": round(with_selected / valid, 4) if valid else 0.0,
        "query_token_len": _percentiles(q_lens),
        "passage_token_len": _percentiles(p_lens),
        "oov_rate": round(oov / tokens_seen, 4) if tokens_seen else None,
        "_passage_lengths": p_lens,  # consumed by suggest-buckets, not printed
    }


def inspect_embeddings(embeddings_path: str, word_to_idx_path: str) -> Dict:
    """Embedding-table / vocab agreement (ref: inspect_data.ipynb cell 12
    appends <pad>/<unk>; backend/main.py:176-182 patches a missing <UNK>
    row at train time when vocab > rows)."""
    import pickle

    table = np.load(embeddings_path, mmap_mode="r")
    with open(word_to_idx_path, "rb") as f:
        word_to_idx = pickle.load(f)
    norms = np.linalg.norm(np.asarray(table[: min(len(table), 100_000)], dtype=np.float32), axis=1)
    return {
        "embeddings_path": str(embeddings_path),
        "shape": list(table.shape),
        "dtype": str(table.dtype),
        "vocab_size": len(word_to_idx),
        "vocab_rows_mismatch": len(word_to_idx) - table.shape[0],
        "has_pad_token": "<pad>" in word_to_idx,
        "has_unk_token": "<unk>" in word_to_idx or "<UNK>" in word_to_idx,
        "row_norm_mean": round(float(norms.mean()), 4),
        "row_norm_std": round(float(norms.std()), 4),
        "zero_rows_sampled": int((norms == 0).sum()),
    }


def suggest_buckets(
    lengths: Sequence[int], k: int, max_len: int
) -> Tuple[List[int], float, float]:
    """K doc-width bucket edges minimizing total padded tokens.

    Exact DP over the clipped length histogram: for distinct sorted
    lengths l_1<...<l_m with counts c_i, a bucket covering (l_i, l_j]
    pads every member to l_j, costing ``l_j * sum(c_{i+1..j})`` tokens;
    choose k-1 interior cut points minimizing the total (the last edge
    is always the max observed length — the batcher independently pins
    a final bucket at MAX_DOC_LEN, data/batching.py:78-85). O(m^2 k)
    with m = distinct clipped lengths <= max_len, i.e. trivial.

    Returns (edges, waste_frac_bucketed, waste_frac_single_bucket) where
    waste_frac = padded_tokens/total_padded excluding real tokens.
    """
    if not len(lengths):
        return [max_len], 0.0, 0.0
    clipped = np.minimum(np.asarray(lengths, dtype=np.int64), max_len)
    ls, cs = np.unique(clipped, return_counts=True)
    m = len(ls)
    k = max(1, min(k, m))
    prefix = np.concatenate([[0], np.cumsum(cs)])  # counts
    real_tokens = int((ls * cs).sum())

    # dp[b][j] = min padded tokens covering lengths[0..j) with b buckets
    INF = float("inf")
    dp = np.full((k + 1, m + 1), INF)
    cut = np.zeros((k + 1, m + 1), dtype=np.int64)
    dp[0][0] = 0.0
    for b in range(1, k + 1):
        for j in range(1, m + 1):
            # bucket (i..j] padded to ls[j-1]
            costs = dp[b - 1][:j] + ls[j - 1] * (prefix[j] - prefix[:j])
            i = int(np.argmin(costs))
            dp[b][j], cut[b][j] = costs[i], i
    edges: List[int] = []
    j = m
    for b in range(k, 0, -1):
        edges.append(int(ls[j - 1]))
        j = int(cut[b][j])
    edges.reverse()

    padded = dp[k][m]
    single = float(ls[-1] * prefix[m])
    waste = (padded - real_tokens) / padded if padded else 0.0
    waste_single = (single - real_tokens) / single if single else 0.0
    return edges, round(float(waste), 4), round(float(waste_single), 4)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Inspect MS MARCO parquet splits, the embedding table, "
                    "and suggest LENGTH_BUCKETS edges")
    parser.add_argument("--config", help="training config JSON (reference key "
                                         "names); supplies all paths")
    parser.add_argument("--data-dir", type=Path,
                        help="directory with ms_marco_{split}.parquet "
                             "(+ embeddings.npy / word_to_idx.pkl if present)")
    parser.add_argument("--splits", default="train,validation,test")
    parser.add_argument("--max-rows", type=int, default=20_000,
                        help="inspect at most this many rows per split "
                             "(0 = all)")
    parser.add_argument("--suggest-buckets", type=int, default=3, metavar="K",
                        help="suggest K doc-length bucket edges minimizing "
                             "padded tokens (0 = skip)")
    parser.add_argument("--max-doc-len", type=int, default=None,
                        help="clip for the bucket suggestion (default: "
                             "config MAX_DOC_LEN or 128)")
    parser.add_argument("--json", action="store_true",
                        help="emit one machine-readable JSON object")
    args = parser.parse_args(argv)

    if not args.config and not args.data_dir:
        parser.error("need --config or --data-dir")

    if args.config:
        from twotowermlretrieval_tpu_torch.config import Config

        cfg = Config.from_json(args.config)
        split_paths = {
            "train": cfg.train_dataset_path,
            "validation": cfg.val_dataset_path,
            "test": cfg.test_dataset_path,
        }
        embeddings_path = cfg.embeddings_path
        word_to_idx_path = cfg.word_to_idx_path
        max_doc_len = args.max_doc_len or cfg.max_doc_len
    else:
        split_paths = {
            s: str(args.data_dir / f"ms_marco_{s}.parquet")
            for s in ("train", "validation", "test")
        }
        embeddings_path = str(args.data_dir / "embeddings.npy")
        word_to_idx_path = str(args.data_dir / "word_to_idx.pkl")
        max_doc_len = args.max_doc_len or 128

    tokenizer = None
    if Path(word_to_idx_path).exists():
        from twotowermlretrieval_tpu_torch.tokenizer import Tokenizer

        tokenizer = Tokenizer.from_pickle(word_to_idx_path)

    report: Dict = {"splits": {}, "embeddings": None, "bucket_suggestion": None}
    all_passage_lengths: List[int] = []
    max_rows = args.max_rows or None
    for split in args.splits.split(","):
        split = split.strip()
        path = split_paths.get(split)
        if not path or not Path(path).exists():
            report["splits"][split] = {"error": f"not found: {path}"}
            continue
        try:
            stats = inspect_split(path, tokenizer, max_rows=max_rows)
        except Exception as e:  # mirror the loader's per-split isolation
            report["splits"][split] = {"error": f"{type(e).__name__}: {e}"}
            continue
        all_passage_lengths.extend(stats.pop("_passage_lengths"))
        report["splits"][split] = stats

    if Path(embeddings_path).exists() and tokenizer is not None:
        report["embeddings"] = inspect_embeddings(embeddings_path, word_to_idx_path)

    if args.suggest_buckets and all_passage_lengths:
        edges, waste, waste_single = suggest_buckets(
            all_passage_lengths, args.suggest_buckets, max_doc_len)
        report["bucket_suggestion"] = {
            "LENGTH_BUCKETS": edges,
            "MAX_DOC_LEN": max_doc_len,
            "padded_token_waste": waste,
            "padded_token_waste_single_bucket": waste_single,
            "note": "batches pad docs to their bucket edge; the batcher "
                    "always keeps a final bucket at MAX_DOC_LEN "
                    "(data/batching.py). Assignment uses max(pos,neg) "
                    "length per triplet, so realized waste is slightly "
                    "higher than this per-passage estimate.",
        }

    if args.json:
        print(json.dumps(report))
        return report

    for split, stats in report["splits"].items():
        print(f"== split {split}")
        for key, value in stats.items():
            print(f"  {key}: {value}")
    if report["embeddings"]:
        print("== embeddings")
        for key, value in report["embeddings"].items():
            print(f"  {key}: {value}")
    if report["bucket_suggestion"]:
        sug = report["bucket_suggestion"]
        print("== bucket suggestion")
        print(f"  LENGTH_BUCKETS: {sug['LENGTH_BUCKETS']} (MAX_DOC_LEN {sug['MAX_DOC_LEN']})")
        print(f"  padded-token waste: {sug['padded_token_waste']:.1%} "
              f"(single bucket: {sug['padded_token_waste_single_bucket']:.1%})")
    return report


def cli() -> int:
    """Console-script entry: `main` returns the report dict (for library/test
    use); translate it to a process exit status here so the `ttr-inspect-data`
    wrapper's `sys.exit(...)` does not treat a successful run as failure."""
    return 0 if main() is not None else 1


if __name__ == "__main__":
    sys.exit(cli())
