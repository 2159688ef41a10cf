"""Retrieval losses: explicit-triplet (the reference's) + in-batch contrastive.

The port of the JAX package's ``models/losses.py``, one device:

- :func:`triplet_loss_cosine`: ``mean(clamp(cos(q, neg) - cos(q, pos) +
  margin, 0))`` with ``F.cosine_similarity``'s per-norm ``max(., 1e-8)``
  guard, and an optional per-example weight so repeat-padded rows count
  zero.
- :func:`in_batch_softmax_loss`: every other document of the batch is a
  negative, scored by a softmax over ``Q @ D^T / temperature``; padded
  columns are masked with a finite -1e9 except each row's own label
  column, so a padded row's zero-weighted NLL stays finite.
- :func:`combined_loss`: the one ``Config.loss_type`` selects.

The cross-device forms (``axis_name``, ``gather_negatives``) belong to the
multi-device slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_MESH_TODO = "cross-device losses are not ported yet (ROADMAP Queue 1 item 10, multi-device)"


def _cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity with the eps guard on each norm."""
    na = torch.linalg.vector_norm(a, dim=-1).clamp_min(eps)
    nb = torch.linalg.vector_norm(b, dim=-1).clamp_min(eps)
    return torch.sum(a * b, dim=-1) / (na * nb)


def weighted_mean(per_example: torch.Tensor, weights: Optional[torch.Tensor] = None,
                  axis_name: Optional[str] = None) -> torch.Tensor:
    """sum(x * w) / max(sum(w), 1), or the plain mean without weights."""
    if axis_name is not None:
        raise NotImplementedError(_MESH_TODO)
    if weights is None:
        return torch.mean(per_example)
    return torch.sum(per_example * weights) / torch.sum(weights).clamp_min(1.0)


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
    mean and their document columns masked out of every softmax."""
    if axis_name is not None:
        raise NotImplementedError(_MESH_TODO)
    B = query_emb.shape[0]
    logits = torch.matmul(query_emb.float(), doc_emb.float().T) / temperature  # [B, B]
    labels = torch.arange(B, device=logits.device)
    if weights is not None:
        # keep column j when it is a real doc or this row's own label
        # (finite -1e9, not -inf: 0-weight * inf would give NaN)
        keep = (weights > 0)[None, :] | (labels[None, :] == labels[:, None])
        logits = torch.where(keep, logits, torch.full_like(logits, -1e9))
    nll = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    return weighted_mean(nll, weights)


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
    'triplet+in_batch' (the sum of both)."""
    if axis_name is not None:
        raise NotImplementedError(_MESH_TODO)
    total = torch.zeros((), dtype=torch.float32, device=query_emb.device)
    if loss_type in ("triplet", "triplet+in_batch"):
        total = total + triplet_loss_cosine((query_emb, pos_emb, neg_emb), margin, weights)
    if loss_type in ("in_batch", "triplet+in_batch"):
        total = total + in_batch_softmax_loss(query_emb, pos_emb, temperature, weights)
    return total
