"""Retrieval losses: explicit-triplet (the reference's) + in-batch contrastive.

The port of the JAX package's ``models/losses.py``:

- :func:`triplet_loss_cosine`: ``mean(clamp(cos(q, neg) - cos(q, pos) +
  margin, 0))`` with ``F.cosine_similarity``'s per-norm ``max(., 1e-8)``
  guard, and an optional per-example weight so repeat-padded rows count
  zero.
- :func:`in_batch_softmax_loss`: every other document of the batch is a
  negative, scored by a softmax over ``Q @ D^T / temperature``; padded
  columns are masked with a finite -1e9 except each row's own label
  column, so a padded row's zero-weighted NLL stays finite.
- :func:`combined_loss`: the one ``Config.loss_type`` selects.

With ``axis_name`` (the ``data`` process group of the caller's mesh,
``parallel/mesh.py``) each rank holds its rows of the global batch: every
mean is normalized over the global batch, and ``gather_negatives``
gathers the documents of every rank (an all-gather autograd sees), so each
query is scored against the B_global documents.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from twotowermlretrieval_tpu_torch.parallel.collectives import (
    all_gather_rows,
    axis_index,
    axis_size,
    psum,
)


def _cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity with the eps guard on each norm."""
    na = torch.linalg.vector_norm(a, dim=-1).clamp_min(eps)
    nb = torch.linalg.vector_norm(b, dim=-1).clamp_min(eps)
    return torch.sum(a * b, dim=-1) / (na * nb)


def weighted_mean(per_example: torch.Tensor, weights: Optional[torch.Tensor] = None,
                  axis_name: Optional[str] = None) -> torch.Tensor:
    """sum(x * w) / max(sum(w), 1), or the plain mean without weights.

    With ``axis_name`` the denominator is the GLOBAL one, summed over the
    ranks, and the value is scaled by the rank count D: ``D * num /
    max(psum(den), 1)``. A per-rank denominator would be wrong whenever
    real rows are spread unevenly (a repeat-padded final batch puts its
    zero-weight rows on the tail ranks); scaled so, the mean over ranks of
    the values and of their gradients is the global mean's."""
    if weights is None:
        if axis_name is None:
            return torch.mean(per_example)
        weights = torch.ones_like(per_example)
    num = torch.sum(per_example * weights)
    if axis_name is None:
        return num / torch.sum(weights).clamp_min(1.0)
    den = psum(torch.sum(weights), axis_name)
    return axis_size(axis_name) * num / den.clamp_min(1.0)


def triplet_loss_cosine(
    triplet: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    margin: float = 0.2,
    weights: Optional[torch.Tensor] = None,
    axis_name: Optional[str] = None,
) -> torch.Tensor:
    """Cosine triplet margin loss; ``weights`` [B] zero out padded rows."""
    query, pos_doc, neg_doc = triplet
    per_example = torch.clamp(_cosine(query, neg_doc) - _cosine(query, pos_doc) + margin,
                              min=0.0)
    return weighted_mean(per_example, weights, axis_name)


def in_batch_softmax_loss(
    query_emb: torch.Tensor,  # [B, H], assumed L2-normalized
    doc_emb: torch.Tensor,  # [B, H]
    temperature: float = 0.05,
    weights: Optional[torch.Tensor] = None,
    axis_name: Optional[str] = None,
    gather_negatives: bool = True,
) -> torch.Tensor:
    """Softmax contrastive loss with in-batch negatives; the positive for
    query i is document i. Padded rows (weight 0) are weighted out of the
    mean and their document columns masked out of every softmax. With
    ``axis_name`` and ``gather_negatives`` the documents (and weights) of
    every rank are gathered, and local query i on rank k is labelled
    ``k * B_local + i``."""
    B = query_emb.shape[0]
    gather = axis_name is not None and gather_negatives
    all_docs = all_gather_rows(doc_emb, axis_name) if gather else doc_emb
    offset = axis_index(axis_name) * B if gather else 0
    logits = torch.matmul(query_emb.float(), all_docs.float().T) / temperature  # [B, B_global]
    labels = torch.arange(B, device=logits.device) + offset
    if weights is not None:
        col_weights = all_gather_rows(weights, axis_name) if gather else weights
        cols = torch.arange(all_docs.shape[0], device=logits.device)
        # keep column j when it is a real doc or this row's own label
        # (finite -1e9, not -inf: 0-weight * inf would give NaN)
        keep = (col_weights > 0)[None, :] | (cols[None, :] == labels[:, None])
        logits = torch.where(keep, logits, torch.full_like(logits, -1e9))
    nll = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    return weighted_mean(nll, weights, axis_name)


def combined_loss(
    query_emb: torch.Tensor,
    pos_emb: torch.Tensor,
    neg_emb: torch.Tensor,
    loss_type: str,
    margin: float,
    temperature: float,
    weights: Optional[torch.Tensor] = None,
    axis_name: Optional[str] = None,
    gather_negatives: bool = True,
) -> torch.Tensor:
    """'triplet', 'in_batch' (explicit negatives unused) or
    'triplet+in_batch' (the sum of both); ``axis_name`` and
    ``gather_negatives`` go to each term."""
    total = torch.zeros((), dtype=torch.float32, device=query_emb.device)
    if loss_type in ("triplet", "triplet+in_batch"):
        total = total + triplet_loss_cosine((query_emb, pos_emb, neg_emb), margin, weights,
                                            axis_name)
    if loss_type in ("in_batch", "triplet+in_batch"):
        total = total + in_batch_softmax_loss(query_emb, pos_emb, temperature, weights,
                                              axis_name, gather_negatives)
    return total
