"""The comparison that decides ``correct``.

Training cells compare the program's first steps with the reference's
(``reference/train.py``), each number a gap between two readings:

- ``loss_gap``: the largest ``|L_prog - L_ref| / |L_ref|`` over the steps;
- ``grad_gap``: over the trainable leaves, the largest gap between the
  norms of the first step's clipped gradient (the program's worked out
  from Adam's first moment after one step, ``|mu| / (1 - b1)``), as a share
  of the larger of the reference leaf's norm and the median leaf's;
- ``update_gap``: the same for the norms of each leaf's change after the
  steps, counting only the rows (along a leaf's first axis; a vector's
  elements) whose first reference gradient is at least a thousandth of
  the median leaf's: the others, such as the key's bias under the
  softmax or a table row no token of the steps reads, get a gradient that
  is nought to rounding and move under Adam by round-off alone.
"""

from __future__ import annotations

import statistics
from typing import Dict

import numpy as np
import torch

ROUNDOFF_SHARE = 1e-3


def row_norms(x: torch.Tensor) -> torch.Tensor:
    """The norms of a leaf's rows along its first axis (a vector's
    elements), on the leaf's device."""
    x = x.detach().float()
    return x.abs() if x.dim() == 1 else torch.linalg.vector_norm(
        x.reshape(x.shape[0], -1), dim=1)


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    med = statistics.median(ref.values())
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in ref)


def training_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog``: ``loss`` (a list), ``grad_norms`` and ``change_rows``
    (dicts by leaf name); ``ref``: the reference's readings, lists in
    ``ref['names']`` order."""
    names = ref["names"]
    missing = [n for n in names if n not in prog["grad_norms"] or n not in prog["change_rows"]]
    if missing:
        raise ValueError(f"the program has no reading of leaves {missing[:4]}")
    rg = dict(zip(names, ref["grad_norms"]))
    floor = ROUNDOFF_SHARE * statistics.median(rg.values())
    pc, rc = {}, {}
    for n, grows, crows in zip(names, ref["grad_rows"], ref["change_rows"]):
        keep = np.asarray(grows) >= floor
        if keep.any():
            rc[n] = float(np.sqrt(np.sum(np.asarray(crows)[keep] ** 2)))
            pc[n] = float(np.sqrt(np.sum(np.asarray(prog["change_rows"][n])[keep] ** 2)))
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": _leaf_gap(prog["grad_norms"], rg),
        "update_gap": _leaf_gap(pc, rc),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number is finite and within its limit."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= limits[k]
               for k in limits)
