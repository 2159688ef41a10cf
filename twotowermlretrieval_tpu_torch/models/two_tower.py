"""Two-tower retrieval model: independent query and document encoders.

The port of the JAX package's ``models/two_tower.py``: params are
``{'query': ..., 'doc': ...}``, each an encoder tree of torch tensors; the
spec is a frozen dataclass whose ``tower_type`` picks the encoder, the
recurrent tower of ``models/rnn.py`` or the transformer of
``models/transformer.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from twotowermlretrieval_tpu_torch.models.rnn import RNNSpec, init_rnn_encoder, rnn_encode
from twotowermlretrieval_tpu_torch.models.transformer import (
    TransformerSpec,
    init_transformer_encoder,
    transformer_encode,
)
from twotowermlretrieval_tpu_torch.utils.profiling import annotate
from twotowermlretrieval_tpu_torch.utils.pytree import unflatten_params


@dataclasses.dataclass(frozen=True)
class TwoTowerSpec:
    tower_type: str = "rnn"  # 'rnn' | 'transformer'
    rnn: Optional[RNNSpec] = None
    transformer: Optional[TransformerSpec] = None

    def __post_init__(self):
        if self.tower_type not in ("rnn", "transformer"):
            raise ValueError(f"tower_type must be rnn|transformer, got {self.tower_type!r}")

    @classmethod
    def from_config(cls, config) -> "TwoTowerSpec":
        if config.tower_type == "transformer":
            return cls(tower_type="transformer", transformer=TransformerSpec.from_config(config))
        return cls(tower_type="rnn", rnn=RNNSpec.from_config(config))

    @property
    def hidden_dim(self) -> int:
        return (self.rnn or self.transformer).hidden_dim

    def _encode_fn(self):
        if self.tower_type == "transformer":
            return transformer_encode, self.transformer
        return rnn_encode, self.rnn

    def _init_fn(self):
        if self.tower_type == "transformer":
            return init_transformer_encoder, self.transformer
        return init_rnn_encoder, self.rnn


def init_two_tower(
    generator: torch.Generator,
    spec: TwoTowerSpec,
    pretrained_embeddings: Optional[np.ndarray] = None,
) -> Dict[str, Any]:
    """Two independently initialized towers from one spec, drawn in turn
    from ``generator``; both get a copy of the pretrained table."""
    init_fn, sub = spec._init_fn()
    return {
        "query": init_fn(generator, sub, pretrained_embeddings),
        "doc": init_fn(generator, sub, pretrained_embeddings),
    }


def encode_query(params, tokens, lengths, spec: TwoTowerSpec, *, train=False,
                 generator=None, model_group=None) -> torch.Tensor:
    """The query tower; ``model_group``: the process group of the spec's
    model axis, where ``params`` holds this rank's shards."""
    encode_fn, sub = spec._encode_fn()
    with annotate("ttr.tower.query"):
        return encode_fn(params["query"], tokens, lengths, sub, train=train,
                         generator=generator, model_group=model_group)


def encode_document(params, tokens, lengths, spec: TwoTowerSpec, *, train=False,
                    generator=None, model_group=None) -> torch.Tensor:
    encode_fn, sub = spec._encode_fn()
    with annotate("ttr.tower.doc"):
        return encode_fn(params["doc"], tokens, lengths, sub, train=train,
                         generator=generator, model_group=model_group)


def two_tower_forward(
    params,
    q_tokens,
    q_lengths,
    d_tokens,
    d_lengths,
    spec: TwoTowerSpec,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    model_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(query_emb, doc_emb); with dropout the query tower draws its masks
    from ``generator`` first, then the doc tower."""
    return (
        encode_query(params, q_tokens, q_lengths, spec, train=train, generator=generator,
                     model_group=model_group),
        encode_document(params, d_tokens, d_lengths, spec, train=train, generator=generator,
                        model_group=model_group),
    )


def params_from_jax(tree_or_flat, device="cpu") -> Dict[str, Any]:
    """The JAX package's parameters as the port's: a nested tree of numpy
    arrays (``init_two_tower``'s output, fetched to the host) or the flat
    '/'-keyed dict of ``model.npz``, to a tree of f32 tensors on
    ``device``. The layout is the same, so this only converts leaves."""
    tree = tree_or_flat
    if isinstance(tree, dict) and any("/" in k for k in tree):
        tree = unflatten_params(tree)
    return to_device(tree, device)


def to_device(tree, device) -> Any:
    """Every leaf of a params tree as an f32 tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)
