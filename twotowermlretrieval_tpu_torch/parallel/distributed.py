"""Data-parallel training and encoding over the mesh's ``data`` group.

The port of the data-parallel half of the JAX package's
``parallel/distributed.py``. Where JAX runs the single-device step under
``shard_map`` with the batch on ``P('data')`` and the state replicated,
here every rank is a process that holds the whole replicated
:class:`TrainState` and runs the step on its rows of each global batch
(``parallel/mesh.py:put_global``); the step's collectives go over
``mesh.data_group`` (``train/train_step.py``, ``models/losses.py``):

- the losses and metrics are normalized over the global batch;
- with ``config.cross_device_negatives`` the in-batch loss scores every
  rank's documents (an all-gather that autograd sees);
- the gradients and metrics are summed in one all-reduce and divided by
  the rank count, so every rank applies the same update.

The model axis (the transformer's tensor-parallel specs, the row-sharded
table, the model-sharded clip) is ROADMAP Queue 1 item 10b.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from twotowermlretrieval_tpu_torch.data.batching import unpack_batch
from twotowermlretrieval_tpu_torch.encoder import run_batched_encode
from twotowermlretrieval_tpu_torch.models.two_tower import (
    TwoTowerSpec,
    encode_document,
    encode_query,
)
from twotowermlretrieval_tpu_torch.parallel.collectives import all_gather_rows
from twotowermlretrieval_tpu_torch.parallel.mesh import Mesh, put_global
from twotowermlretrieval_tpu_torch.train.train_step import (
    TrainState,
    make_eval_step,
    make_train_step,
    merge_params,
)
from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves


def leaf_checksums(tree) -> torch.Tensor:
    """One int64 checksum per leaf of ``tree`` (in :func:`named_leaves`
    order) over the leaf's bits: two ranks' leaves with equal checksums
    are, but for a collision, bit for bit equal."""
    out = []
    for _, leaf in named_leaves(tree):
        x = leaf.detach().contiguous().reshape(-1)
        bits = x.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[x.element_size()]).to(torch.int64)
        weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append(torch.stack([bits.sum(), (bits * weight).sum()]))
    return torch.stack(out)


def replicas_agree(tree, mesh: Mesh) -> bool:
    """Whether every rank of the data group holds ``tree`` bit for bit as
    this one does (checksums gathered from every rank)."""
    mine = leaf_checksums(tree)
    every = all_gather_rows(mine[None], mesh.data_group)
    return bool((every == mine[None]).all())


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The state, checked to be the same on every rank. Initialization
    from ``config.seed`` is deterministic, so every rank builds the same
    state; a rank that did not (another table, another seed) raises here
    rather than train a different model."""
    trees = {"trainable": state.trainable, "frozen": state.frozen,
             "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}
    if not replicas_agree(trees, mesh):
        raise RuntimeError(f"rank {mesh.rank}: the train state differs between the ranks; "
                           "every rank must start from the same parameters")
    return state


def make_distributed_train_step(spec: TwoTowerSpec, config, mesh: Mesh):
    """``step(state, batch) -> (state, metrics)`` on this rank's rows of
    the global batch (``put_global``); the metrics are global."""
    return make_train_step(spec, config, axis_name=mesh.data_group)


def make_distributed_eval_step(spec: TwoTowerSpec, config, mesh: Mesh):
    """``eval_step(state, batch) -> (q_emb, pos_emb, {'val_loss'})`` on
    this rank's rows: the embeddings are this rank's, the loss the global
    batch's."""
    return make_eval_step(spec, config, axis_name=mesh.data_group)


def make_sharded_packed_train_step(spec: TwoTowerSpec, config, mesh: Mesh,
                                   max_query_len: int):
    """The driver's train step over this rank's rows of one packed [B, W]
    buffer (``put_global`` of the [k, B, W] group on axis 1, then one
    [B_local, W] row block a step)."""
    step = make_distributed_train_step(spec, config, mesh)

    def packed_step(state: TrainState, packed: torch.Tensor):
        return step(state, unpack_batch(packed, max_query_len))

    return packed_step


def make_sharded_packed_eval_step(spec: TwoTowerSpec, config, mesh: Mesh,
                                  max_query_len: int):
    """The driver's eval step over this rank's rows of one packed buffer;
    the embeddings of every rank are gathered, so each rank returns the
    global batch's [B, H] (as the JAX package's multi-process eval step
    does) for the batch evaluator."""
    step = make_distributed_eval_step(spec, config, mesh)

    def packed_eval(state: TrainState, packed: torch.Tensor):
        q, p, m = step(state, unpack_batch(packed, max_query_len))
        return all_gather_rows(q, mesh.data_group), all_gather_rows(p, mesh.data_group), m

    return packed_eval


def make_sharded_encode_fns(spec: TwoTowerSpec, mesh: Mesh):
    """Query and doc encoders over this rank's rows of a token batch,
    returning every rank's embeddings (``fn(state, tokens, lengths) ->
    [B, H]``)."""

    def wrap(encode):
        @torch.inference_mode()
        def fn(state: TrainState, tokens: torch.Tensor, lengths: torch.Tensor):
            params = merge_params(state.trainable, state.frozen)
            return all_gather_rows(encode(params, tokens, lengths, spec), mesh.data_group)

        return fn

    return wrap(encode_query), wrap(encode_document)


class MeshTextEncoder:
    """A :class:`TextEncoder` whose batches are split over the ranks: each
    rank encodes its rows and every rank gets every embedding, so corpus
    and test evaluation run through the mesh. Batch buckets are rounded up
    to a multiple of the rank count. ``state`` is read at each call (the
    driver trains it in place)."""

    def __init__(self, state: TrainState, spec: TwoTowerSpec, tokenizer, mesh: Mesh, device,
                 batch_size: int = 256, max_query_len: int = 32, max_doc_len: int = 128):
        self.state = state
        self.spec = spec
        self.tokenizer = tokenizer
        self.mesh = mesh
        self.device = torch.device(device)
        self.max_query_len = max_query_len
        self.max_doc_len = max_doc_len
        n = mesh.data

        def fit(b):  # buckets must split evenly over 'data'
            return max(-(-b // n) * n, n)

        self._bucket_small, self._bucket_mid = fit(16), fit(128)
        self.corpus_batch_size = fit(max(batch_size, 1024))
        self._q_fn, self._d_fn = make_sharded_encode_fns(spec, mesh)

    def _run(self, texts: Sequence[str], fn, max_len: int) -> np.ndarray:
        if len(texts) <= self._bucket_small:
            bs = self._bucket_small
        elif len(texts) <= self._bucket_mid:
            bs = self._bucket_mid
        else:
            bs = self.corpus_batch_size
        return run_batched_encode(
            texts, self.tokenizer, max_len, bs, self.spec.hidden_dim,
            lambda tokens, lengths: fn(
                self.state,
                put_global(tokens.astype(np.int64), self.mesh, self.device),
                put_global(lengths.astype(np.int64), self.mesh, self.device)),
        )

    def encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        return self._run(texts, self._q_fn, self.max_query_len)

    def encode_documents(self, texts: Sequence[str]) -> np.ndarray:
        return self._run(texts, self._d_fn, self.max_doc_len)

    def encode_query(self, text: str) -> np.ndarray:
        return self.encode_queries([text])[0]
