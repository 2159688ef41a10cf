"""The reference's first training steps and the readings compared.

From the benchmark's seed-made weights and the rows of the program's
first steps: the in-batch softmax loss (logits ``q d^T / temperature``,
the example weights' mean of the NLL), the gradient of the trainable
leaves (every leaf but the tables when ``FREEZE_EMBEDDINGS``), optax's
``clip_by_global_norm`` (``min(1, max_norm / max(|g|, 1e-16))``) and
optax's Adam (b1 0.9, b2 0.999, eps 1e-8 after the square root,
bias-corrected), ``-LR`` times the update. Dropout masks are
``torch.rand(shape) < keep`` drawn from a generator on the device seeded
with the run's dropout seed, in the order the towers use them (query
tower, then document tower; layer by layer or block by block).

``readings`` returns, per step, the loss; per trainable leaf, the norm of
the first step's clipped gradient (what Adam receives), and the norms of
the rows (along the first axis) of that gradient and of the leaf's change
after the steps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmarks.reference.precision import matmul, no_tf32
from benchmarks.reference.towers import tower

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def named_leaves(tree, prefix=()) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs: dict keys sorted, tuple positions, '/'-joined."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], prefix + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _rebuild(tree, leaves: Dict[str, torch.Tensor], prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_rebuild(v, leaves, prefix + (str(i),)) for i, v in enumerate(tree))
    return leaves["/".join(prefix)]


def row_norms(x: torch.Tensor):
    """The norms of a leaf's rows (along its first axis) as float64 numpy;
    a vector's rows are its elements."""
    x = x.detach().double()
    return (x.abs() if x.dim() == 1 else torch.linalg.vector_norm(
        x.reshape(x.shape[0], -1), dim=1)).cpu().numpy()


def trainable(name: str, model: dict) -> bool:
    return not (model.get("FREEZE_EMBEDDINGS", True) and name.endswith("embedding"))


def in_batch_loss(q, d, weights, temperature, precision):
    logits = matmul(q, d.t(), precision) / temperature
    B = q.shape[0]
    labels = torch.arange(B, device=q.device)
    keep = (weights > 0)[None, :] | (labels[None, :] == labels[:, None])
    logits = torch.where(keep, logits, torch.full_like(logits, -1e9))
    nll = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    return torch.sum(nll * weights) / torch.sum(weights).clamp_min(1.0)


class _RankMasks:
    """Dropout masks of a step split over ``ranks`` data-parallel ranks, as
    the port's data-parallel step draws them: one draw of
    ``randint(0, 2**62)`` from the replicated generator, then each rank r a
    generator seeded from ``SeedSequence([draw, r])`` (its first two 32-bit
    words, ``w0 << 31 ^ w1``), which draws the masks of the rank's block of
    rows. A mask of the global batch is the ranks' blocks side by side."""

    def __init__(self, gen, ranks: int, device, keep: float, only: Optional[int] = None):
        draw = int(torch.randint(0, 2 ** 62, (), generator=gen, device=device))
        self.gens = []
        for r in range(ranks):
            w = np.random.SeedSequence([draw, r]).generate_state(2, np.uint32)
            g = torch.Generator(device=device).manual_seed(int(w[0]) << 31 ^ int(w[1]))
            self.gens.append(g)
        self.ranks, self.device, self.keep, self.only = ranks, device, keep, only

    def __call__(self, shape):
        T, B, H = shape
        per = B if self.only is not None else B // self.ranks
        gens = [self.gens[self.only]] if self.only is not None else self.gens
        return torch.cat([(torch.rand((T, per, H), generator=g, device=self.device) < self.keep)
                          .float() for g in gens], dim=1)


def readings(params, batches: Sequence[dict], model: dict, dropout_seed: int, device,
             precision: str = "float32", half_batch: bool = False, ranks: int = 1,
             only_rank: Optional[int] = None) -> dict:
    """Run ``len(batches)`` steps from ``params`` (left unchanged). Each
    batch: ``q_tokens``, ``q_len``, ``d_tokens``, ``d_len``, ``weights``
    tensors on ``device``. ``half_batch``: a fault, every step on the
    first half of its rows only. ``ranks``: the global batch of a
    data-parallel step over that many ranks (its dropout masks drawn as
    ``_RankMasks`` says). ``only_rank``: a fault, the exchange between
    ranks left out, as that rank sees it: the step on its own block of rows,
    its own negatives and its own gradient."""
    no_tf32()
    encode = tower(model)
    keep = 1.0 - model["DROPOUT"]
    gen = torch.Generator(device=device).manual_seed(int(dropout_seed))

    def plain(shape):
        return (torch.rand(shape, generator=gen, device=device) < keep).float()

    named = named_leaves(params)
    live = {n: p.detach().clone().requires_grad_(trainable(n, model)) for n, p in named}
    names = [n for n, _ in named if trainable(n, model)]
    start = {n: live[n].detach().clone() for n in names}
    mu = {n: torch.zeros_like(live[n]) for n in names}
    nu = {n: torch.zeros_like(live[n]) for n in names}
    tree = _rebuild(params, live)
    out = {"loss": [], "names": names}
    for step, b in enumerate(batches, start=1):
        B = b["q_tokens"].shape[0]
        rows = slice(0, B // 2) if half_batch else slice(None)
        drop = plain if ranks == 1 else _RankMasks(gen, ranks, device, keep, only_rank)
        if only_rank is not None:
            rows = slice(only_rank * B // ranks, (only_rank + 1) * B // ranks)
        q = encode(tree["query"], b["q_tokens"][rows], b["q_len"][rows], model, drop, precision)
        d = encode(tree["doc"], b["d_tokens"][rows], b["d_len"][rows], model, drop, precision)
        loss = in_batch_loss(q, d, b["weights"][rows], model["TEMPERATURE"], precision)
        grads = torch.autograd.grad(loss, [live[n] for n in names], allow_unused=True)
        grads = [torch.zeros_like(live[n]) if g is None else g for n, g in zip(names, grads)]
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(model.get("GRAD_CLIP_NORM", 1.0) / gnorm.clamp_min(1e-16),
                                max=1.0)
            if step == 1:
                out["grad_norms"] = [float(torch.linalg.vector_norm(g * scale)) for g in grads]
                out["grad_rows"] = [row_norms(g * scale) for g in grads]
            bc1, bc2 = 1.0 - ADAM_B1 ** step, 1.0 - ADAM_B2 ** step
            for n, g in zip(names, grads):
                g = g * scale
                mu[n].mul_(ADAM_B1).add_((1.0 - ADAM_B1) * g)
                nu[n].mul_(ADAM_B2).add_((1.0 - ADAM_B2) * (g * g))
                live[n].add_(-model["LR"] * (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + ADAM_EPS))
        out["loss"].append(float(loss.detach()))
    with torch.no_grad():
        out["change_rows"] = [row_norms(live[n] - start[n]) for n in names]
    return out
