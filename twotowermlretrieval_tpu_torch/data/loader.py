"""MS MARCO triplet pipeline: parquet -> (query, positive, negative) strings.

Re-implements the reference's ``DataLoader`` semantics
(ref: backend/data_loader.py:7-120) with the same determinism contract:

- per-split seeds: 42 for train, 123 for validation, 456 otherwise, chosen by
  path substring (data_loader.py:22-27, 46-52);
- pandas ``df.sample(frac=..., random_state=seed)`` subsampling
  (data_loader.py:25-29);
- row validity filter: non-null query, non-null passage list, non-empty list
  (data_loader.py:31-35);
- *retrieval* mode: every passage is a positive, negatives drawn uniformly
  from other queries' passages with a rejection loop (data_loader.py:57-70);
- *ranking* mode: ``is_selected==1`` rows are positives, same-query
  non-selected passages are hard negatives, random fallback
  (data_loader.py:72-99);
- per-split error isolation: a failing split yields ``[]`` (data_loader.py:113-118).

Departures (documented quirk fixes, SURVEY.md §7):

- The reference seeds the positive sampler with a *fresh* ``random.Random
  (seed + idx)`` per row while negatives share one stream — we keep the same
  construction so triplets are reproducible, but treat only the determinism
  guarantee as the contract, not the exact stream.
- Parquet is read through pyarrow (the environment has no fastparquet); both
  the flattened ``passages.passage_text`` column layout the reference reads
  and the nested ``passages`` struct layout HF datasets produce are accepted.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List, Optional, Tuple

Triplet = Tuple[str, str, str]


def _split_seed(path: str) -> int:
    """Seed-by-path-substring, identical to ref data_loader.py:22-27."""
    if "train" in path:
        return 42
    if "validation" in path:
        return 123
    return 456


def _extract_columns(df):
    """Return (queries, passage_lists, is_selected_lists) from either the
    flattened or the nested parquet schema."""
    import numpy as np

    if "passages.passage_text" in df.columns:
        texts = df["passages.passage_text"]
        selected = (
            df["passages.is_selected"]
            if "passages.is_selected" in df.columns
            else None
        )
    elif "passages" in df.columns:
        texts = df["passages"].apply(
            lambda p: p.get("passage_text") if isinstance(p, dict) else None
        )
        selected = df["passages"].apply(
            lambda p: p.get("is_selected") if isinstance(p, dict) else None
        )
    else:
        raise ValueError(f"no passages column found; columns={list(df.columns)}")

    def to_list(x):
        if isinstance(x, np.ndarray):
            return x.tolist()
        return x

    return df["query"], texts.apply(to_list), (selected.apply(to_list) if selected is not None else None)


class TripletBuilder:
    """Builds training triplets from MS MARCO parquet splits.

    Drop-in behavioral equivalent of the reference ``DataLoader``
    (ref: backend/data_loader.py:7-13): reads the same config keys
    (NUM_TRIPLETS_PER_QUERY, TRAINING_MODE) and emits the same triplet
    structure.
    """

    def __init__(self, config):
        # Accept either our Config dataclass or a raw reference-style dict.
        if hasattr(config, "num_triplets_per_query"):
            self.num_triplets_per_query = config.num_triplets_per_query
            self.training_mode = config.training_mode
            self._paths = {
                "train": config.train_dataset_path,
                "validation": config.val_dataset_path,
                "test": config.test_dataset_path,
            }
        else:
            self.num_triplets_per_query = config.get("NUM_TRIPLETS_PER_QUERY", 1)
            self.training_mode = config.get("TRAINING_MODE", "retrieval")
            self._paths = {
                "train": config["TRAIN_DATASET_PATH"],
                "validation": config["VAL_DATASET_PATH"],
                "test": config["TEST_DATASET_PATH"],
            }

    # ------------------------------------------------------------------
    def load_and_process_parquet(
        self, path: str, subsample_ratio: Optional[float] = None
    ) -> List[Triplet]:
        """One split -> triplets (ref: data_loader.py:15-102)."""
        import pandas as pd

        df = pd.read_parquet(path)  # pyarrow engine (fastparquet unavailable)

        if subsample_ratio and 0 < subsample_ratio < 1.0:
            seed = _split_seed(path)
            df = df.sample(frac=subsample_ratio, random_state=seed).reset_index(drop=True)

        queries, passage_lists, selected_lists = _extract_columns(df)
        valid = (
            queries.notna()
            & passage_lists.notna()
            & passage_lists.apply(lambda x: isinstance(x, list) and len(x) > 0)
        )
        df = df[valid].reset_index(drop=True)
        queries = queries[valid].reset_index(drop=True)
        passage_lists = passage_lists[valid].reset_index(drop=True)
        if selected_lists is not None:
            selected_lists = selected_lists[valid].reset_index(drop=True)

        # Pool of (source_row, passage) for random negatives
        # (ref: data_loader.py:38-39).
        all_passages = [
            (idx, p) for idx, plist in passage_lists.items() for p in plist
        ]
        passage_rows = {row for row, _ in all_passages}

        seed = _split_seed(path)
        rng = random.Random(seed)
        triplets: List[Triplet] = []

        for idx in range(len(df)):
            query = queries.iloc[idx]
            passages = passage_lists.iloc[idx]
            if not passages:
                continue

            if self.training_mode == "retrieval":
                # All passages are positives; negative = any other query's
                # passage, rejection-sampled (ref: data_loader.py:57-70).
                # Guard: if EVERY pooled passage belongs to this row (a
                # split reduced to one valid query), the rejection loop
                # could never exit — skip the row instead of hanging.
                if passage_rows == {idx}:
                    continue
                num_pos = min(self.num_triplets_per_query, len(passages))
                pos_indices = random.Random(seed + idx).sample(range(len(passages)), num_pos)
                for i in pos_indices:
                    positive = passages[i]
                    while True:
                        neg_row, negative = rng.choice(all_passages)
                        if neg_row != idx:
                            break
                    triplets.append((query, positive, negative))
            else:  # ranking (ref: data_loader.py:72-99)
                is_selected = (
                    list(selected_lists.iloc[idx]) if selected_lists is not None else []
                )
                if not is_selected or len(passages) != len(is_selected):
                    continue
                positive_indices = [i for i, s in enumerate(is_selected) if s == 1]
                negative_indices = [i for i, s in enumerate(is_selected) if s == 0]
                if not positive_indices:
                    continue
                for pos_idx in positive_indices:
                    positive = passages[pos_idx]
                    if negative_indices:
                        negative = passages[rng.choice(negative_indices)]
                    elif passage_rows != {idx}:
                        while True:
                            neg_row, negative = rng.choice(all_passages)
                            if neg_row != idx:
                                break
                    else:  # no same-query negatives AND no other rows
                        continue
                    triplets.append((query, positive, negative))

        return triplets

    def load_datasets(
        self, subsample_ratio: Optional[float] = None
    ) -> Dict[str, List[Triplet]]:
        """All three splits with per-split error isolation
        (ref: data_loader.py:104-120)."""
        datasets: Dict[str, List[Triplet]] = {}
        for split, path in self._paths.items():
            try:
                datasets[split] = self.load_and_process_parquet(path, subsample_ratio)
            except Exception as e:  # noqa: BLE001 — isolation is the contract
                print(f"error loading {split} dataset: {e}")
                datasets[split] = []
        return datasets


def load_datasets(config, subsample_ratio: Optional[float] = None):
    """Functional convenience wrapper (ref: backend/main.py:189-190)."""
    return TripletBuilder(config).load_datasets(subsample_ratio)
