#!/usr/bin/env python3
"""GloVe table preparation: .txt -> embeddings.npy + word_to_idx.pkl.

CLI equivalent of the reference's embedding notebook
(ref: notebooks/embeddings_processing.ipynb cell 1 + the pad/unk patch in
misc/inspect_data.ipynb cell 12): parses a GloVe text file and writes the
two-file table contract the trainer loads. Optionally appends an explicit
``<UNK>`` (mean vector) row. No ``<pad>`` row exists or is needed — unlike
the reference, which leaves id 0 doubling as both the word 'the' and the
padding sentinel (SURVEY.md §7), this build carries explicit length
channels and never infers padding from token ids.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main():
    parser = argparse.ArgumentParser(description="Prepare GloVe embedding artifacts")
    parser.add_argument("glove_txt", type=Path, help="GloVe .txt file (word v1 v2 ...)")
    parser.add_argument("--out", type=Path, default=Path("data"))
    parser.add_argument("--add_special", action="store_true",
                        help="append <UNK> (mean vector) row")
    args = parser.parse_args()

    from twotowermlretrieval_tpu_torch.data.glove import parse_glove_txt, save_embedding_artifacts

    table, word_to_idx = parse_glove_txt(args.glove_txt)
    print(f"parsed {len(word_to_idx):,} words, dim {table.shape[1]}")
    if args.add_special and "<UNK>" not in word_to_idx:
        word_to_idx["<UNK>"] = len(word_to_idx)
        table = np.vstack([table, table.mean(axis=0, keepdims=True)])
    save_embedding_artifacts(args.out, table, word_to_idx)
    print(f"wrote {args.out}/embeddings.npy {table.shape} and {args.out}/word_to_idx.pkl")


if __name__ == "__main__":
    main()
