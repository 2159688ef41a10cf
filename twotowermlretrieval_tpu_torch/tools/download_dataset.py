#!/usr/bin/env python3
"""MS MARCO acquisition: HuggingFace hub -> parquet splits.

CLI equivalent of the reference's download notebook
(ref: notebooks/download_dataset.ipynb cell 1): loads ``ms_marco`` v2.1,
converts each split to pandas, writes ``data/ms_marco_{split}.parquet`` in
the flattened column layout the triplet builder reads
(``query``, ``passages.passage_text``, ``passages.is_selected``, ...).

Needs network access to the HF hub. In air-gapped environments use
``--synthetic`` to generate a schema-identical synthetic corpus instead
(twotowermlretrieval_tpu_torch.data.synthetic).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def download(out_dir: Path, dataset: str = "ms_marco", version: str = "v2.1") -> None:
    import pandas as pd
    from datasets import load_dataset

    out_dir.mkdir(parents=True, exist_ok=True)
    ds = load_dataset(dataset, version)
    for split in ds.keys():
        df = ds[split].to_pandas()
        # flatten the nested passages struct into dotted columns
        # (the layout the reference reads, ref: data_loader.py:33-39)
        if "passages" in df.columns:
            passages = pd.json_normalize(df["passages"])
            passages.columns = [f"passages.{c}" for c in passages.columns]
            df = pd.concat([df.drop(columns=["passages"]), passages], axis=1)
        path = out_dir / f"ms_marco_{split}.parquet"
        df.to_parquet(path)
        print(f"wrote {path} ({len(df):,} rows)")


def main():
    parser = argparse.ArgumentParser(description="Download MS MARCO to parquet")
    parser.add_argument("--out", type=Path, default=Path("data"))
    parser.add_argument("--version", default="v2.1")
    parser.add_argument("--synthetic", action="store_true",
                        help="generate a synthetic schema-identical corpus (no network)")
    parser.add_argument("--num_queries", type=int, default=2000,
                        help="synthetic corpus size")
    args = parser.parse_args()
    if args.synthetic:
        from twotowermlretrieval_tpu_torch.data.synthetic import generate_corpus

        paths = generate_corpus(args.out, num_queries=args.num_queries)
        for name, path in paths.items():
            print(f"wrote {path}")
    else:
        download(args.out, version=args.version)


if __name__ == "__main__":
    main()
