"""The corpus rows of a search cell: unit rows of the tower's width, made
on the device from the seed block by block, so that the reference can make
any block again without the program's copy."""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.harness.seeds import sub_seed

BLOCK_ROWS = 1 << 20


def n_blocks(n_rows: int) -> int:
    return -(-n_rows // BLOCK_ROWS)


def block(i: int, n_rows: int, dim: int, seed: int, device):
    """Block ``i``: (its first row, [rows, dim] f32 unit rows on ``device``)."""
    start = i * BLOCK_ROWS
    rows = min(BLOCK_ROWS, n_rows - start)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, f"corpus{i}"))
    x = torch.randn((rows, dim), generator=gen, device=device)
    return start, x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def host_rows(n_rows: int, dim: int, seed: int, device) -> np.ndarray:
    """All rows as one host f32 array, the form ``RetrievalIndex`` takes."""
    out = np.empty((n_rows, dim), np.float32)
    for i in range(n_blocks(n_rows)):
        start, x = block(i, n_rows, dim, seed, device)
        out[start : start + x.shape[0]] = x.cpu().numpy()
    return out
