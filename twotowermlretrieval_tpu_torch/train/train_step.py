"""The training step: forward 3 towers -> loss -> grad -> clip -> Adam.

The port of the JAX package's ``train/train_step.py``:

- frozen embedding tables are partitioned out of the trained params, so
  they get no gradient and no Adam state (the reference's
  ``requires_grad=False``);
- the gradient clip is optax's ``clip_by_global_norm`` formula, ``scale =
  min(1, max_norm / max(|g|, 1e-16))`` (not ``torch.nn.utils.
  clip_grad_norm_``, which adds 1e-6 to the norm);
- Adam is optax's with its defaults (b1 0.9, b2 0.999, eps 1e-8 added
  after the square root, bias-corrected), ``-lr`` times the update; on a
  card the clip and Adam are one multi-tensor kernel (``ops/adam.py``);
- the metric set is the JAX step's, ``grad_norm`` taken before the clip;
  per-leaf norms and fixed-bin histograms when the config asks for them.

State is a plain dataclass (trainable and frozen trees of tensors, the
Adam moments, the step, the dropout generator). Unlike the JAX step,
which returns a new state, :func:`make_train_step`'s function updates the
parameters and moments in place and returns the same state object.

The data-parallel step (``axis_name``, the ``data`` process group of the
caller's mesh) runs on each rank over its rows of the global batch, with
the state replicated: the losses and metrics are normalized over the
global batch; the gradients and the metrics go through ONE all-reduce a
step, then the gradients are divided by the rank count D (JAX's
``pmean``), clipped by their plain global norm (every gradient is
replicated) and applied by Adam, so every rank takes the same update.
Dropout follows JAX's split-then-fold-in: each step draws one seed from
the state's generator (the same draw on every rank, so the generator
advances alike everywhere) and the rank seeds a device generator of its
own from (that seed, its index).

On the model axis (``model_group``; ``rules`` name the trainable leaves
that hold only this rank's shard) the
towers run their tensor-parallel or row-sharded forms over the model
group; a sharded leaf's gradient has only its local shape, so the
data-group all-reduce above is unchanged. The clip and ``grad_norm`` use
:func:`global_norm_sharded`: a sharded leaf's square sum is summed over
the model group, a replicated leaf counts once, so every rank of the
group clips by the same factor. The per-leaf norms and histograms sum (or
take the max) over the model group the same way. The ranks of a model
group share their data index, so their dropout seeds, and masks, agree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from twotowermlretrieval_tpu_torch.data.batching import Batch
from twotowermlretrieval_tpu_torch.models.losses import (
    combined_loss,
    triplet_loss_cosine,
)
from twotowermlretrieval_tpu_torch.parallel.collectives import (
    axis_index,
    axis_size,
    pmax,
    psum,
    psum_,
)
from twotowermlretrieval_tpu_torch.models.two_tower import (
    TwoTowerSpec,
    encode_document,
    encode_query,
)
from twotowermlretrieval_tpu_torch.ops import adam
from twotowermlretrieval_tpu_torch.utils.profiling import annotate
from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves, tree_map

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
HISTOGRAM_BINS = 64


@dataclasses.dataclass
class TrainState:
    trainable: Any  # differentiated params (leaves require grad)
    frozen: Any  # non-differentiated params (the GloVe tables)
    opt_state: Dict[str, Any]  # {'count': int32 scalar, 'mu': tree, 'nu': tree}
    step: int
    generator: torch.Generator  # the dropout stream, on the params' device
    # ops/adam.py's table of these leaves, made at the first update on a card
    leaf_table: Any = dataclasses.field(default=None, repr=False, compare=False)


def partition_params(params: Dict[str, Any], freeze_embeddings: bool):
    """Split two-tower params into (trainable, frozen): frozen [V, E]
    tables move to the frozen tree and never see autograd."""
    if not freeze_embeddings:
        return params, {}
    trainable, frozen = {}, {}
    for tower, tower_params in params.items():
        t = dict(tower_params)
        frozen[tower] = {"embedding": t.pop("embedding")}
        trainable[tower] = t
    return trainable, frozen


def merge_params(trainable: Dict[str, Any], frozen: Dict[str, Any]) -> Dict[str, Any]:
    if not frozen:
        return trainable
    return {tower: {**trainable[tower], **frozen.get(tower, {})} for tower in trainable}


def create_train_state(generator: torch.Generator, params: Dict[str, Any], config) -> TrainState:
    """State over ``params`` (already on their device); ``generator`` is the
    dropout stream and must live on the same device."""
    trainable, frozen = partition_params(params, config.freeze_embeddings)
    trainable = tree_map(lambda p: p.detach().clone().requires_grad_(True), trainable)
    frozen = tree_map(lambda p: p.detach(), frozen)
    leaves = [p for _, p in named_leaves(trainable)]
    device = leaves[0].device
    return TrainState(
        trainable=trainable,
        frozen=frozen,
        opt_state={
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tree_map(lambda p: torch.zeros_like(p, requires_grad=False), trainable),
            "nu": tree_map(lambda p: torch.zeros_like(p, requires_grad=False), trainable),
        },
        step=0,
        generator=generator,
    )


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in leaves))


def global_norm_sharded(leaves, model_group=None, model_sharded=None) -> torch.Tensor:
    """The global L2 norm of gradients some of which are shards over the
    model group (``model_sharded[i]``): a sharded leaf's square sum is
    summed over the group (one all-reduce for all of them), a replicated
    leaf's counts once. Without a group, :func:`global_norm`. Every rank
    adds the same terms in the same order, so all get the same bits."""
    if model_group is None or not model_sharded or not any(model_sharded):
        return global_norm(leaves)
    squares = [torch.sum(torch.square(g)) for g in leaves]
    summed = iter(psum(torch.stack([q for q, s in zip(squares, model_sharded) if s]),
                       model_group))
    return torch.sqrt(sum(next(summed) if s else q for q, s in zip(squares, model_sharded)))


def clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm's factor: min(1, max_norm / max(|g|, 1e-16))."""
    return torch.clamp(max_norm / gnorm.clamp_min(1e-16), max=1.0)


@torch.no_grad()
def apply_clip_and_adam(state: TrainState, grads, config, model_group=None,
                        model_sharded=None) -> torch.Tensor:
    """clip_by_global_norm(grad_clip_norm) then Adam(lr), in place on the
    state's params and moments, in optax's arithmetic. ``grads`` is the
    list of gradients in :func:`named_leaves` order. Returns the global
    norm of ``grads`` (before the clip), over the model group's shards
    (:func:`global_norm_sharded`).

    Leaves on a card take ``csrc/adam.cu`` (``ops/adam.py``): the same
    arithmetic in two launches, the step count and the norm read on the
    card, so nothing synchronizes; it takes f32 contiguous leaves and
    raises ``ValueError`` for others. Leaves on the CPU take the loop
    below."""
    opt = state.opt_state
    named = named_leaves(state.trainable)
    params = [p for _, p in named]
    mus = [m for _, m in named_leaves(opt["mu"])]
    nus = [v for _, v in named_leaves(opt["nu"])]
    state.leaf_table = adam.table_for(params, mus, nus, state.leaf_table, [n for n, _ in named])
    if state.leaf_table is not None:
        opt["count"] += 1
        return adam.clip_and_adam(state.leaf_table, grads, opt["count"], config.grad_clip_norm,
                                  config.lr, model_sharded if model_group is not None else None,
                                  lambda t: psum_(t, model_group))
    gnorm = global_norm_sharded(grads, model_group, model_sharded)
    scale = clip_scale(gnorm, config.grad_clip_norm)
    opt["count"] += 1
    count = opt["count"].float()
    bc1 = 1.0 - torch.pow(torch.tensor(ADAM_B1, device=count.device), count)
    bc2 = 1.0 - torch.pow(torch.tensor(ADAM_B2, device=count.device), count)
    for p, g, mu, nu in zip(params, grads, mus, nus):
        g = g * scale
        mu.mul_(ADAM_B1).add_((1.0 - ADAM_B1) * g)  # (1-b1) g + b1 mu, as optax
        nu.mul_(ADAM_B2).add_((1.0 - ADAM_B2) * (g * g))
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        p.add_(-config.lr * update)
    return gnorm


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def _forward_and_metrics(params, batch: Batch, spec: TwoTowerSpec, config,
                         generator: Optional[torch.Generator], train: bool, axis_name=None,
                         model_group=None):
    """(loss, metric numerators, their denominator): each metric but the
    loss is ``sums[name] / max(den, 1)``, a weighted mean over this rank's
    rows; the data-parallel step sums both over the ranks first."""
    q = encode_query(params, batch.q_tokens, batch.q_len, spec, train=train,
                     generator=generator, model_group=model_group)
    B = batch.pos_tokens.shape[0]
    # With a pure in-batch loss the explicit negative never reaches the
    # gradient; only the triplet metric set reads it. TRIPLET_METRICS=false
    # skips its forward too: the doc tower encodes [B] rows, not [2B].
    need_neg = config.loss_type != "in_batch" or getattr(config, "triplet_metrics", True)
    if need_neg:
        # one doc-tower call over [2B, T] (pos ++ neg)
        d = encode_document(
            params, torch.cat([batch.pos_tokens, batch.neg_tokens]),
            torch.cat([batch.pos_len, batch.neg_len]), spec, train=train, generator=generator,
            model_group=model_group,
        )
        p, n = d[:B], d[B:]
    else:
        p = encode_document(params, batch.pos_tokens, batch.pos_len, spec, train=train,
                            generator=generator, model_group=model_group)
        n = None
    w = batch.example_mask

    loss = combined_loss(q, p, n if n is not None else p, config.loss_type, config.margin,
                         config.temperature, weights=w, axis_name=axis_name,
                         gather_negatives=config.cross_device_negatives)

    with torch.no_grad():
        def wsum(x):
            return torch.sum(x * w)

        pos_sim = torch.sum(q * p, dim=-1)
        sums = {
            "pos_similarity": wsum(pos_sim),
            "query_magnitude": wsum(torch.linalg.vector_norm(q, dim=-1)),
            "doc_magnitude": wsum(torch.linalg.vector_norm(p, dim=-1)),
        }
        if n is not None:
            neg_sim = torch.sum(q * n, dim=-1)
            sums["triplet_accuracy"] = wsum((pos_sim > neg_sim).float())
            sums["similarity_gap"] = wsum(pos_sim - neg_sim)
            sums["neg_similarity"] = wsum(neg_sim)
        if "in_batch" in config.loss_type:
            # top-1 retrieval accuracy over this rank's [B, B] in-batch
            # similarity matrix (positive on the diagonal), as JAX's;
            # padded columns excluded as in the loss
            logits = torch.matmul(q, p.T)
            eye = torch.eye(B, dtype=torch.bool, device=q.device)
            col_ok = (w > 0)[None, :] | eye
            logits = torch.where(col_ok, logits, torch.full_like(logits, -torch.inf))
            hit = (torch.argmax(logits, dim=-1) == torch.arange(B, device=q.device)).float()
            sums["in_batch_accuracy"] = wsum(hit)
    return loss, sums, torch.sum(w)


def _leaf_histogram(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-bin histogram over [-absmax, absmax]: (counts [BINS] f32,
    absmax), the JAX step's binning. With ``group`` (a leaf sharded over
    it) the absmax is the group's max and the counts its sum, so every
    rank reports the whole leaf's histogram."""
    absmax = torch.max(torch.abs(x))
    if group is not None:
        absmax = pmax(absmax, group)
    scale = absmax.clamp_min(1e-30)
    idx = ((x.reshape(-1) + scale) * (HISTOGRAM_BINS / (2.0 * scale))).to(torch.int32)
    idx = idx.clamp(0, HISTOGRAM_BINS - 1).long()
    counts = torch.bincount(idx, minlength=HISTOGRAM_BINS).float()
    if group is not None:
        counts = psum_(counts, group)
    return counts, absmax


@torch.no_grad()
def _add_param_stats(metrics, names, grads, params, histograms: bool, norms: bool,
                     model_group=None, model_sharded=None) -> None:
    """Per-leaf norms and histograms; a leaf sharded over ``model_group``
    sums its squares (or counts) over the group."""
    sharded = model_sharded or [False] * len(names)
    for name, g, p, s in zip(names, grads, params, sharded):
        group = model_group if s else None
        if norms:
            gs, ps = torch.sum(torch.square(g)), torch.sum(torch.square(p))
            if group is not None:
                gs, ps = psum_(torch.stack([gs, ps]), group)
            metrics[f"grad_norm/{name}"] = torch.sqrt(gs)
            metrics[f"param_norm/{name}"] = torch.sqrt(ps)
        if histograms:
            metrics[f"grad_hist/{name}"], metrics[f"grad_hist_max/{name}"] = \
                _leaf_histogram(g, group)
            metrics[f"param_hist/{name}"], metrics[f"param_hist_max/{name}"] = \
                _leaf_histogram(p, group)


def _fold_in(generator: torch.Generator, index: int, cache: dict) -> torch.Generator:
    """A generator on ``generator``'s device seeded from (one draw of
    ``generator``, ``index``): the same draw on every rank, a different
    stream on each."""
    dev = generator.device
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator, device=dev))
    mixed = np.random.SeedSequence([seed, index]).generate_state(2, np.uint32)
    rank_gen = cache.get(dev)
    if rank_gen is None:
        rank_gen = cache[dev] = torch.Generator(device=dev)
    return rank_gen.manual_seed(int(mixed[0]) << 31 ^ int(mixed[1]))


def make_grad_step(spec: TwoTowerSpec, config, axis_name=None, model_group=None):
    """``grad_step(state, batch) -> (grads, metrics)``: the train step up
    to the clip, gradients in :func:`named_leaves` order. With
    ``axis_name`` the gradients are the mean over the ranks and the
    metrics global, through one all-reduce. ``model_group``: the towers'
    model axis (a sharded leaf's gradient is its shard's)."""
    rank_gens: dict = {}

    def grad_step(state: TrainState, batch: Batch):
        leaves = [p for _, p in named_leaves(state.trainable)]
        generator = state.generator
        if axis_name is not None:
            # decorrelate dropout masks across ranks (the replicated
            # generator would otherwise drop the same units of other rows)
            generator = _fold_in(generator, axis_index(axis_name), rank_gens)
        with torch.enable_grad():
            params = merge_params(state.trainable, state.frozen)
            with annotate("ttr.train.forward"):
                loss, sums, den = _forward_and_metrics(params, batch, spec, config, generator,
                                                       train=True, axis_name=axis_name,
                                                       model_group=model_group)
            with annotate("ttr.train.backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        loss = loss.detach()
        if axis_name is not None:
            with torch.no_grad(), annotate("ttr.train.allreduce"):
                # one all-reduce a step: the gradients, the per-rank loss
                # (scaled by D, see weighted_mean), the metric sums and den
                names = list(sums)
                flat = torch.cat([g.reshape(-1).float() for g in grads]
                                 + [torch.stack([loss] + [sums[k] for k in names] + [den])])
                psum_(flat, axis_name)
                D = axis_size(axis_name)
                out, off = [], 0
                for g in grads:
                    out.append((flat[off : off + g.numel()] / D).view_as(g).to(g.dtype))
                    off += g.numel()
                grads = out
                loss = flat[off] / D
                sums = dict(zip(names, flat[off + 1 : off + 1 + len(names)]))
                den = flat[-1]
        metrics = {"loss": loss}
        den = den.clamp_min(1.0)
        metrics.update({k: v / den for k, v in sums.items()})
        return grads, metrics

    return grad_step


def make_train_step(spec: TwoTowerSpec, config, axis_name=None, model_group=None,
                    rules=None):
    """The train-step function ``step(state, batch) -> (state, metrics)``.
    Metrics are scalar (or histogram) tensors on the device; nothing is
    fetched to the host. ``axis_name``: the ``data`` process group of the
    data-parallel step (``parallel/distributed.py``); ``model_group`` and
    ``rules`` (``rules(path, leaf)``: the dimension of a trainable leaf
    split over the group, or ``None``; ``parallel/distributed.py:rules_for``):
    the model axis and which leaves are shards over it."""
    grad_step = make_grad_step(spec, config, axis_name, model_group)

    def train_step(state: TrainState, batch: Batch):
        with annotate("ttr.train.step"):
            named = named_leaves(state.trainable)
            names = [n for n, _ in named]
            leaves = [p for _, p in named]
            model_sharded = (None if model_group is None or rules is None
                             else [rules(n, p) is not None for n, p in named])
            grads, metrics = grad_step(state, batch)
            norms = bool(getattr(config, "log_param_stats", False))
            hists = bool(getattr(config, "log_param_histograms", False))
            with annotate("ttr.train.optimizer"):
                if norms or hists:  # of the params before this step's update, as JAX's
                    _add_param_stats(metrics, names, grads, leaves, hists, norms, model_group,
                                     model_sharded)
                metrics["grad_norm"] = apply_clip_and_adam(state, grads, config, model_group,
                                                           model_sharded)
            state.step += 1
        return state, metrics

    return train_step


def make_eval_step(spec: TwoTowerSpec, config, axis_name=None, model_group=None):
    """Validation step: no dropout, no update. Returns (q_emb, pos_emb,
    {'val_loss'}); the validation loss is the triplet loss whatever the
    training loss. With ``axis_name`` the embeddings are this rank's rows
    and the loss is the global batch's; ``model_group``: the towers' model
    axis."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch):
        params = merge_params(state.trainable, state.frozen)
        q = encode_query(params, batch.q_tokens, batch.q_len, spec, model_group=model_group)
        B = batch.pos_tokens.shape[0]
        d = encode_document(
            params, torch.cat([batch.pos_tokens, batch.neg_tokens]),
            torch.cat([batch.pos_len, batch.neg_len]), spec, model_group=model_group,
        )
        p, n = d[:B], d[B:]
        loss = triplet_loss_cosine((q, p, n), config.margin, weights=batch.example_mask,
                                   axis_name=axis_name)
        if axis_name is not None:
            loss = psum_(loss, axis_name) / axis_size(axis_name)
        return q, p, {"val_loss": loss}

    return eval_step
