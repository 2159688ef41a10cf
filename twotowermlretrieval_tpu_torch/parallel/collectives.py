"""The collectives of the parallel step, over one process group.

``group`` here is what the JAX package's ``axis_name`` names: the
``data`` group of a :class:`~twotowermlretrieval_tpu_torch.parallel.mesh.Mesh`
(``mesh.data_group``) or its ``model`` group (``mesh.model_group``). Only
``all_gather_into_tensor`` and ``all_reduce`` are used, the two
collectives gloo takes on CUDA tensors as well as NCCL does.

The model axis adds Megatron's two conjugate operators as autograd
functions (the JAX package's ``_copy_to_tp`` and ``_reduce_from_tp``):
:func:`copy_to_tp` (identity forward, sum backward) on the replicated
activation entering a column-split product, and :func:`reduce_from_tp`
(sum forward, identity backward) on a row-split product's partial sums.
Neither a raw ``dist.all_reduce`` (autograd does not see it) nor
``torch.distributed.nn.functional.all_reduce`` (its backward is another
sum, which counts the replicated cotangent M times) takes their place. Gloo reads a CUDA tensor through the host without waiting for
torch's current stream, where the kernels launch, so each collective on a
gloo group first waits for that stream; NCCL orders itself after it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def axis_size(group) -> int:
    return dist.get_world_size(group)


def axis_index(group) -> int:
    return dist.get_rank(group)


def _ready(t: torch.Tensor, group) -> None:
    if t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        torch.cuda.current_stream(t.device).synchronize()


def psum_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over the group (no gradient); returns ``t``."""
    _ready(t, group)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of a tensor that needs no gradient."""
    return psum_(t.detach().clone(), group)


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group of a tensor that needs no gradient."""
    t = t.detach().clone()
    _ready(t, group)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


class _CopyToTP(torch.autograd.Function):
    """Identity forward, sum over the group backward (Megatron's 'f'): each
    rank's backward carries only its own heads' or FFN columns' part of
    the cotangent, so the replicated parameters upstream (layer norms, the
    input projection, the table) get their whole gradient only after the
    sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum_(g.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Sum over the group forward, identity backward (Megatron's 'g'): the
    output's cotangent is replicated over the group, so each rank's
    partial sum takes it as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return psum_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((axis_size(group) * x.shape[0], *x.shape[1:]))
    _ready(x, group)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (no
    gradient): the inverse of splitting a tensor in blocks along ``dim``."""
    return _gather(x.movedim(dim, 0), group).movedim(0, dim).contiguous()


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's [B_local, ...] rows, stacked in rank order
    into [D * B_local, ...] (JAX's tiled ``all_gather``). Backward: its
    transpose, each rank's rows of the SUM over ranks of the cotangent
    (JAX's ``psum_scatter``), as one all-reduce of the whole cotangent and
    a slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        g = psum_(g.contiguous().clone(), ctx.group)
        start = axis_index(ctx.group) * ctx.rows
        return g[start : start + ctx.rows], None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``x`` in rank order; autograd sees the gather."""
    return _GatherRows.apply(x, group)
