"""The reference of a dense search: its own tokenizer, the query tower
without dropout, and an exact top-k over the corpus rows, which it makes
again block by block; products at the configuration's bf16 compute and
storage (operands, rows and queries rounded to bfloat16, sums in f32).

The tokenizer follows the port's stated semantics: lowercase, the words
of ``\\w+|[.,!?;]``, each looked up in the word-to-row map, an unknown
word at the ``<UNK>`` row (appended after the others), at most
``max_len`` words.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Sequence, Tuple

import torch

from benchmarks.reference.precision import PRECISION_OF_SEARCH, no_tf32, round_bf16
from benchmarks.reference.towers import tower

_WORDS = re.compile(r"\w+|[.,!?;]")


def tokenize(texts: Sequence[str], word_to_row: Dict[str, int], max_len: int, device):
    unk = word_to_row.get("<UNK>", len(word_to_row))
    rows = [[word_to_row.get(w, unk) for w in _WORDS.findall(t.lower())][:max_len] for t in texts]
    tokens = torch.zeros((len(rows), max_len), dtype=torch.int64)
    for i, r in enumerate(rows):
        tokens[i, : len(r)] = torch.tensor(r, dtype=torch.int64)
    lengths = torch.tensor([len(r) for r in rows], dtype=torch.int64)
    return tokens.to(device), lengths.to(device)


def encode_queries(params, texts, word_to_row, model, device) -> torch.Tensor:
    no_tf32()
    tokens, lengths = tokenize(texts, word_to_row, int(model["MAX_QUERY_LEN"]), device)
    with torch.no_grad():
        return tower(model)(params["query"], tokens, lengths, model, None, PRECISION_OF_SEARCH)


def exact_top_k(q: torch.Tensor, blocks: Callable, n_blocks: int, k: int,
                returned: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The top ``k`` scores of ``q`` [S, H] over the rows that ``blocks(i)``
    makes (block i: (first row, [n, H] f32 rows)), and the reference's
    score of each id of ``returned`` [S, k'] (-inf for an id out of range).
    Returns (scores [S, k], ids [S, k], scores of returned [S, k'])."""
    no_tf32()
    S = q.shape[0]
    q = round_bf16(q)
    best = torch.full((S, k), -float("inf"), device=q.device)
    best_ids = torch.full((S, k), -1, dtype=torch.int64, device=q.device)
    of_ret = torch.full(returned.shape, -float("inf"), device=q.device)
    ret = returned.to(q.device).long()
    for i in range(n_blocks):
        start, rows = blocks(i)
        s = q @ round_bf16(rows).t()
        v, ix = torch.topk(s, min(k, s.shape[1]), dim=1)
        vals, sel = torch.topk(torch.cat([best, v], dim=1), k, dim=1)
        best_ids = torch.gather(torch.cat([best_ids, ix + start], dim=1), 1, sel)
        best = vals
        inside = (ret >= start) & (ret < start + rows.shape[0])
        got = torch.gather(s, 1, (ret - start).clamp(0, rows.shape[0] - 1))
        of_ret = torch.where(inside, got, of_ret)
    return best, best_ids, of_ret
