"""Row-sharded embedding-table lookup over the mesh's ``model`` group.

The port of the JAX package's ``parallel/embedding.py``: with
``SHARD_EMBEDDING_TABLE`` each rank of a model group holds the rows
``[shard * V/M, (shard+1) * V/M)`` of a tower's [V, E] table, and a lookup
is a masked gather of the rows this rank owns, then a sum over the group.

The backward is purely local: the masked cotangent is scatter-added into
this shard's rows, with no collective. The mechanical transpose of the
forward's sum would sum the output cotangents, which are the same on every
rank of the group, and scale the table's gradient by M.
"""

from __future__ import annotations

import torch

from twotowermlretrieval_tpu_torch.parallel.collectives import axis_index, psum_


class _ShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_shard, tokens, group):
        rows = table_shard.shape[0]
        local = tokens.long().to(table_shard.device) - axis_index(group) * rows
        in_range = (local >= 0) & (local < rows)
        local = local.clamp(0, rows - 1)
        out = torch.where(in_range[..., None], table_shard[local], 0.0)
        psum_(out, group)
        ctx.save_for_backward(local, in_range)
        ctx.shard_shape, ctx.shard_dtype = table_shard.shape, table_shard.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        local, in_range = ctx.saved_tensors
        E = ctx.shard_shape[-1]
        g = torch.where(in_range[..., None], g, 0.0).to(ctx.shard_dtype)
        d_table = torch.zeros(ctx.shard_shape, dtype=ctx.shard_dtype, device=g.device)
        d_table.index_add_(0, local.reshape(-1), g.reshape(-1, E))
        return d_table, None, None


def sharded_embedding_lookup(table_shard: torch.Tensor, tokens: torch.Tensor,
                             group) -> torch.Tensor:
    """``full_table[tokens]`` ([..., E]) from this rank's rows of the table,
    on every rank of ``group``; autograd gives each shard the gradient of
    its own rows only."""
    return _ShardedLookup.apply(table_shard, tokens, group)


def embedding_lookup(table: torch.Tensor, tokens: torch.Tensor, axis, group) -> torch.Tensor:
    """A tower's lookup: through the row-sharded table when the spec names
    an ``embedding_axis`` (``group`` is then that axis's process group),
    a plain gather otherwise."""
    if axis is None:
        return table[tokens.long().to(table.device)]
    if group is None:
        raise ValueError(f"the spec shards the table over {axis!r} but no process group "
                         "was passed (model_group)")
    return sharded_embedding_lookup(table, tokens, group)
