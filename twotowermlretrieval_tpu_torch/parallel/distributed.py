"""Parallel training and encoding over the mesh's ``data`` and ``model`` groups.

The port of the JAX package's ``parallel/distributed.py``. Where JAX runs
the single-device step under ``shard_map`` with the batch on ``P('data')``
and the state placed by per-leaf ``PartitionSpec``s, here every rank is a
process that holds its part of the :class:`TrainState` and runs the step
on its rows of each global batch (``parallel/mesh.py:put_global``); the
step's collectives go over ``mesh.data_group`` (``train/train_step.py``,
``models/losses.py``):

- the losses and metrics are normalized over the global batch;
- with ``config.cross_device_negatives`` the in-batch loss scores every
  rank's documents (an all-gather that autograd sees);
- the gradients and metrics are summed in one all-reduce and divided by
  the rank count, so every rank applies the same update.

The model axis (``MESH_MODEL`` M > 1): the leaves the rules of
:func:`partition_dim` name are split over ``mesh.model_group`` (JAX's
``transformer_tp_spec`` and ``state_partition_specs``, as "which
dimension of this leaf is split, or none"): the transformer's heads and
FFN columns (config 5) and, with ``SHARD_EMBEDDING_TABLE``, each tower's
[V, E] table by rows; Adam's moments follow their params. Everything else
is replicated over the whole world. The ranks of a model group hold the
same data index, so they take the same rows. :func:`shard_params` and
:func:`gather_params` carry a full tree (the JAX package's params through
``params_from_jax``, or the port's own init) to this rank's shard and
back; the checkpoint and the export gather the same way.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from twotowermlretrieval_tpu_torch.data.batching import unpack_batch
from twotowermlretrieval_tpu_torch.encoder import run_batched_encode
from twotowermlretrieval_tpu_torch.models.two_tower import (
    TwoTowerSpec,
    encode_document,
    encode_query,
)
from twotowermlretrieval_tpu_torch.parallel.collectives import all_gather_rows, gather_dim
from twotowermlretrieval_tpu_torch.parallel.mesh import Mesh, put_global
from twotowermlretrieval_tpu_torch.train.train_step import (
    TrainState,
    make_eval_step,
    make_train_step,
    merge_params,
)
from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves

Rules = Callable[[str, torch.Tensor], Optional[int]]


# ---------------------------------------------------------------------------
# which leaves the model axis splits
# ---------------------------------------------------------------------------


def transformer_tp_spec(names, leaf) -> Optional[int]:
    """The dimension of a transformer block leaf split over 'model', keyed
    on the names on its path (``None``: replicated), Megatron's layout:

    qkv w [H, 3, H] / b [3, H]  -> the last axis (whole heads)
    ffn_in w [H, F] / b [F]     -> the last axis (FFN columns)
    attn_out / ffn_out w        -> the first axis (rows; partial sums)
    """
    if "qkv" in names or "ffn_in" in names:
        return leaf.dim() - 1
    if ("attn_out" in names or "ffn_out" in names) and leaf.dim() == 2:
        return 0
    return None


def partition_dim(path: str, leaf, shard_embedding: bool = False,
                  shard_transformer: bool = False) -> Optional[int]:
    """The dimension of the leaf at ``path`` ('/'-joined, as
    :func:`named_leaves` names it) split over 'model', or ``None``: the
    rows of a [V, E] table with ``shard_embedding``, a transformer block's
    heads and FFN columns with ``shard_transformer``. A full leaf and its
    shard get the same answer."""
    names = set(path.split("/"))
    if shard_embedding and "embedding" in names and leaf.dim() == 2:
        return 0
    if shard_transformer:
        return transformer_tp_spec(names, leaf)
    return None


def partition_rules(shard_embedding: bool = False, shard_transformer: bool = False) -> Rules:
    """:func:`partition_dim` with its two switches set: ``rules(path, leaf)``."""
    return functools.partial(partition_dim, shard_embedding=shard_embedding,
                             shard_transformer=shard_transformer)


def rules_for(config, mesh: Optional[Mesh]) -> Rules:
    """The rules of a run's mesh: nothing is split without a model group;
    on one, the transformer's heads and FFN columns, and the tables with
    ``SHARD_EMBEDDING_TABLE``."""
    if mesh is None or mesh.model_group is None:
        return partition_rules()
    return partition_rules(bool(config.shard_embedding_table),
                           config.tower_type == "transformer")


def _state_trees(state: TrainState) -> Dict[str, object]:
    return {"trainable": state.trainable, "frozen": state.frozen,
            "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}


def state_partition_specs(state: TrainState, shard_embedding: bool,
                          shard_transformer: bool = False) -> Dict[str, Dict[str, Optional[int]]]:
    """Each leaf's split dimension (or ``None``), by tree ('trainable',
    'frozen', 'mu', 'nu') and path: the moments mirror the params."""
    rules = partition_rules(shard_embedding, shard_transformer)
    return {name: {path: rules(path, leaf) for path, leaf in named_leaves(tree)}
            for name, tree in _state_trees(state).items()}


def _map_with_path(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _head_major(path: str, leaf: torch.Tensor) -> torch.Tensor:
    """A qkv leaf in the legacy 2-D layout ([H, 3H] / [3H], q|k|v columns)
    as the head-major [H, 3, H] / [3, H], so a split of the last axis
    hands each rank whole heads of q, k and v."""
    if "qkv" in path.split("/"):
        if path.endswith("/w") and leaf.dim() == 2:
            return leaf.reshape(leaf.shape[0], 3, leaf.shape[1] // 3)
        if path.endswith("/b") and leaf.dim() == 1:
            return leaf.reshape(3, -1)
    return leaf


def shard_slice(path: str, leaf: torch.Tensor, rules: Rules, index: int,
                size: int) -> torch.Tensor:
    """Rank ``index`` of ``size``'s block of a full leaf (the leaf itself
    where the rules keep it whole). A split dimension that ``size`` does
    not divide raises a ``ValueError``, as JAX refuses to place such an
    array."""
    leaf = _head_major(path, leaf)
    dim = rules(path, leaf)
    if dim is None or size == 1:
        return leaf
    n = leaf.shape[dim]
    if n % size:
        raise ValueError(f"{path}: dimension {dim} of shape {tuple(leaf.shape)} does not "
                         f"split evenly over the model axis ({size})")
    return leaf.narrow(dim, index * (n // size), n // size)


def shard_params(tree, rules: Rules, index: int, size: int):
    """This rank's shard of a full tree: each split leaf's block ``index``
    of ``size`` along its dimension (a view), the other leaves as they
    are."""
    return _map_with_path(lambda path, leaf: shard_slice(path, leaf, rules, index, size), tree)


def gather_params(tree, rules: Rules, group):
    """The full tree from every rank's shard: each split leaf gathered over
    ``group`` along its dimension, in rank order (a collective: every rank
    of the group calls it). ``group`` ``None``: the tree as it is."""
    if group is None:
        return tree

    def gather(path, leaf):
        dim = rules(path, leaf)
        return leaf.detach() if dim is None else gather_dim(leaf.detach(), dim, group)

    return _map_with_path(gather, tree)


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


def _agree(tree, group) -> bool:
    mine = leaf_checksums(tree)
    every = all_gather_rows(mine[None], group)
    return bool((every == mine[None]).all())


def replicas_agree(tree, mesh: Mesh) -> bool:
    """Whether every rank of the data group holds ``tree`` bit for bit as
    this one does (checksums gathered from every rank)."""
    return _agree(tree, mesh.data_group)


def state_agrees(state: TrainState, mesh: Mesh, rules: Rules) -> bool:
    """Whether the replicated leaves (params and moments) are bit for bit
    the same on every rank of the world, and the split ones on every rank
    of the data group (the ranks that hold the same shard)."""
    whole, split = {}, {}
    for name, tree in _state_trees(state).items():
        for path, leaf in named_leaves(tree):
            (whole if rules(path, leaf) is None else split)[f"{name}/{path}"] = leaf
    return _agree(whole, dist.group.WORLD) and (not split or _agree(split, mesh.data_group))


def shard_state(state: TrainState, rules: Rules, index: int, size: int) -> TrainState:
    """The state with every split leaf (params and moments) cut to block
    ``index`` of ``size``: fresh leaves, the trainable ones leaves of
    autograd again."""
    def cut(tree, trainable=False):
        def leaf_fn(path, leaf):
            out = shard_slice(path, leaf.detach(), rules, index, size).clone()
            return out.requires_grad_(True) if trainable else out
        return _map_with_path(leaf_fn, tree)

    return TrainState(
        trainable=cut(state.trainable, trainable=True), frozen=cut(state.frozen),
        opt_state={"count": state.opt_state["count"], "mu": cut(state.opt_state["mu"]),
                   "nu": cut(state.opt_state["nu"])},
        step=state.step, generator=state.generator)


def replicate_state(state: TrainState, mesh: Mesh,
                    rules: Rules = partition_rules()) -> TrainState:
    """The rank's part of the full state every rank built: on a model axis,
    the leaves ``rules`` split (:func:`rules_for`) cut to this rank's
    shard (:func:`shard_state`). Initialization from ``config.seed`` is
    deterministic, so every rank builds the same state; the replicated
    leaves are checked to agree over the whole world and the split ones
    over the data group (the ranks that hold the same shard). A rank that
    differs (another table, another seed) raises here rather than train a
    different model."""
    if mesh.model > 1:
        state = shard_state(state, rules, mesh.model_index, mesh.model)
    if not state_agrees(state, mesh, rules):
        raise RuntimeError(f"rank {mesh.rank}: the train state differs between the ranks; "
                           "every rank must start from the same parameters")
    return state


def make_distributed_train_step(spec: TwoTowerSpec, config, mesh: Mesh):
    """``step(state, batch) -> (state, metrics)`` on this rank's rows of
    the global batch (``put_global``); the metrics are global. On a model
    axis the leaves :func:`rules_for` splits are this rank's shards."""
    return make_train_step(spec, config, axis_name=mesh.data_group,
                           model_group=mesh.model_group, rules=rules_for(config, mesh))


def make_distributed_eval_step(spec: TwoTowerSpec, config, mesh: Mesh):
    """``eval_step(state, batch) -> (q_emb, pos_emb, {'val_loss'})`` on
    this rank's rows: the embeddings are this rank's, the loss the global
    batch's."""
    return make_eval_step(spec, config, axis_name=mesh.data_group, model_group=mesh.model_group)


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
            emb = encode(params, tokens, lengths, spec, model_group=mesh.model_group)
            return all_gather_rows(emb, mesh.data_group)

        return fn

    return wrap(encode_query), wrap(encode_document)


class MeshTextEncoder:
    """A :class:`TextEncoder` whose batches are split over the ranks: each
    rank encodes its rows (through the model group's shards) and every
    rank gets every embedding, so corpus and test evaluation run through
    the mesh. Batch buckets are rounded up
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
