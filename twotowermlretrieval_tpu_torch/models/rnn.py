"""Masked recurrent text encoders (GRU / LSTM / RNN) in PyTorch.

The port of the JAX package's ``models/rnn.py``: embedding gather, an
N-layer optionally bidirectional recurrent stack whose time loop is
:func:`ops.rnn_scan.rnn_layer_fwd` (the CUDA kernel on the card), the
final hidden state of the last layer (bidirectional: concat fwd+bwd, then
Linear(2H -> H)), zero-length rows forced to exact zeros, and L2
normalization with a 1e-12 guard. With ``train=True`` inter-layer dropout
applies, as torch's: on every layer's output except the last, only when
``num_layers > 1``, kept units scaled by 1 / keep.

Each layer's time loop is :class:`_ScanLayer`, the counterpart of the JAX
``_scan_layer`` custom VJP: its backward is :func:`ops.rnn_scan.
rnn_layer_bwd`, the ``csrc/rnn_bwd.cu`` kernel with the weight gradients
accumulated inside it. ``TTMR_RNN_BWD_PLAN=hoisted`` swaps in the
split-mode kernel with the weight gradient as one product outside, as in
the JAX package, and ``TTMR_RNN_HISTORY`` picks the saved history's
dtype (:func:`history_in_cdt`); both are read at every call. Hopper has
no VMEM budget, so the JAX package's ``'split'`` shape rule for wide
towers has no counterpart: every width the kernels hold runs the
combined kernel. Every layer runs at the kernels' width
(``ops.rnn_scan.kernel_width``, H rounded up to 8): its weights are
zero-padded to it, so the input projection already yields the padded xp,
both passes run at that width with nothing padded or sliced between them,
and the outputs are sliced back to H; a width beyond the kernels' limits
raises on the card (``ops/rnn_scan.py``).

Parameters are the JAX package's tree with torch tensors as leaves:
``{'embedding': [V, E], 'layers': ({'fwd'|'bwd': {'w_ih': [I, G*H],
'w_hh': [H, G*H], 'b_ih': [G*H], 'b_hh': [G*H]}}, ...), 'projection':
{'w': [2H, H], 'b': [H]}}``, weights stored [in, out] as in ``model.npz``.

With ``embedding_axis`` set (``SHARD_EMBEDDING_TABLE`` on a mesh with a
``model`` axis) ``params['embedding']`` is this rank's row block of the
table and the lookup goes through :func:`parallel.embedding.
sharded_embedding_lookup` over the ``model_group`` the caller passes.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from twotowermlretrieval_tpu_torch.parallel.embedding import embedding_lookup
from twotowermlretrieval_tpu_torch.ops.rnn_scan import (
    rnn_layer_bwd,
    rnn_layer_bwd_hoisted,
    kernel_width,
    pad_layer,
    pad_units,
    rnn_layer_fwd,
)
from twotowermlretrieval_tpu_torch.utils.dtypes import bernoulli_mask, matmul_f32, torch_dtype

_GATES = {"GRU": 3, "LSTM": 4, "RNN": 1}


@dataclasses.dataclass(frozen=True)
class RNNSpec:
    """Static architecture description (field meanings as in the JAX
    package's ``RNNSpec``)."""

    vocab_size: int
    embed_dim: int
    hidden_dim: int
    rnn_type: str = "GRU"
    num_layers: int = 1
    dropout: float = 0.0
    bidirectional: bool = False
    normalize_output: bool = True
    compute_dtype: str = "bfloat16"
    # row-shard the table over this mesh axis; None: a plain gather
    embedding_axis: Optional[str] = None

    def __post_init__(self):
        if self.rnn_type not in _GATES:
            raise ValueError(f"rnn_type must be one of {list(_GATES)}")

    @property
    def num_gates(self) -> int:
        return _GATES[self.rnn_type]

    @classmethod
    def from_config(cls, config) -> "RNNSpec":
        return cls(
            vocab_size=config.vocab_size,
            embed_dim=config.embed_dim,
            hidden_dim=config.hidden_dim,
            rnn_type=config.rnn_type,
            num_layers=config.num_layers,
            dropout=config.dropout,
            bidirectional=config.bidirectional,
            normalize_output=config.normalize_output,
            compute_dtype=config.compute_dtype,
            embedding_axis="model" if config.shard_embedding_table else None,
        )


def init_rnn_encoder(
    generator: torch.Generator,
    spec: RNNSpec,
    pretrained_embeddings: Optional[np.ndarray] = None,
) -> Dict[str, Any]:
    """Encoder params as f32 CPU tensors: uniform(-1/sqrt(H), 1/sqrt(H))
    like ``torch.nn.GRU``; the embedding table copied from the pretrained
    array or drawn N(0, 1). The numbers differ from the JAX package's for
    the same seed (another generator); the layout is the same."""
    h = spec.hidden_dim
    g = spec.num_gates
    scale = 1.0 / math.sqrt(h)
    directions = ("fwd", "bwd") if spec.bidirectional else ("fwd",)

    def uniform(shape, lim):
        return (torch.rand(shape, generator=generator, dtype=torch.float32) * 2.0 - 1.0) * lim

    if pretrained_embeddings is not None:
        if pretrained_embeddings.shape != (spec.vocab_size, spec.embed_dim):
            raise ValueError(
                f"pretrained table {pretrained_embeddings.shape} != "
                f"({spec.vocab_size}, {spec.embed_dim})"
            )
        embedding = torch.as_tensor(np.asarray(pretrained_embeddings, np.float32)).clone()
    else:
        embedding = torch.randn(
            (spec.vocab_size, spec.embed_dim), generator=generator, dtype=torch.float32
        )

    layers = []
    for layer in range(spec.num_layers):
        in_dim = spec.embed_dim if layer == 0 else h * len(directions)
        layers.append({
            d: {
                "w_ih": uniform((in_dim, g * h), scale),
                "w_hh": uniform((h, g * h), scale),
                "b_ih": uniform((g * h,), scale),
                "b_hh": uniform((g * h,), scale),
            }
            for d in directions
        })
    params: Dict[str, Any] = {"embedding": embedding, "layers": tuple(layers)}
    if spec.bidirectional:
        lim = 1.0 / math.sqrt(2 * h)
        params["projection"] = {"w": uniform((2 * h, h), lim), "b": uniform((h,), lim)}
    return params


class _ScanLayer(torch.autograd.Function):
    """One recurrent layer over all directions: ``apply(rnn_type,
    compute_dtype, history_in_cdt, mask2, w_hh, b_hh, *xps)`` returns
    ``(*outs, h_final)``. Saves ``(xps, mask, w_hh, b_hh, outs, c_hist)``
    as the JAX custom VJP does; the mask gets no gradient."""

    @staticmethod
    def forward(ctx, rnn_type, compute_dtype, history_in_cdt, mask2, w_hh, b_hh, *xps):
        outs, c_hist, h_final = rnn_layer_fwd(
            rnn_type, xps, mask2, w_hh, b_hh,
            compute_dtype=compute_dtype, history_in_cdt=history_in_cdt,
        )
        ctx.rnn_type, ctx.compute_dtype = rnn_type, compute_dtype
        ctx.n_dir = len(xps)
        ctx.save_for_backward(mask2, w_hh, b_hh, *xps, *outs, *c_hist)
        return (*outs, h_final)

    @staticmethod
    def backward(ctx, *grads):
        D = ctx.n_dir
        mask2, w_hh, b_hh, *rest = ctx.saved_tensors
        xps, outs, c_hist = rest[:D], rest[D : 2 * D], rest[2 * D :]
        # an output nothing read (the last layer's history) has no cotangent
        douts = [torch.zeros_like(o) if g is None else g for g, o in zip(grads[:D], outs)]
        d_hfinal = grads[D]
        if d_hfinal is None:
            d_hfinal = torch.zeros((D, *outs[0].shape[1:]), dtype=torch.float32,
                                   device=outs[0].device)
        bwd = (rnn_layer_bwd_hoisted if os.environ.get("TTMR_RNN_BWD_PLAN") == "hoisted"
               else rnn_layer_bwd)
        dxps, dw_hh, db_hh = bwd(
            ctx.rnn_type, xps, mask2, w_hh, b_hh, outs, c_hist, douts, d_hfinal,
            compute_dtype=ctx.compute_dtype,
        )
        dxps = [d.to(x.dtype) for d, x in zip(dxps, xps)]
        return (None, None, None, None, dw_hh.to(w_hh.dtype), db_hh.to(b_hh.dtype), *dxps)


def history_in_cdt(compute_dtype) -> bool:
    """Whether a layer saves its state history in the compute dtype (else
    f32): ``TTMR_RNN_HISTORY`` as the JAX package reads it. Unset (or
    empty): the compact history when compute is 16-bit, f32 otherwise;
    ``"cdt"``: the compact history (a no-op under f32 compute); any other
    value: f32. Read at every call: a change of the variable takes effect
    on the next step (the JAX package reads it once, when a step is
    traced)."""
    env = os.environ.get("TTMR_RNN_HISTORY")
    if env:
        return env == "cdt"
    return torch_dtype(compute_dtype).itemsize == 2


def dropout_parts(parts, keep: float, generator: torch.Generator):
    """Inverted dropout on each per-direction part: x * Bernoulli(keep) /
    keep, one draw per part in order."""
    return tuple(
        p * bernoulli_mask(generator, keep, p.shape, p.device) / keep for p in parts
    )


def rnn_encode(
    params: Dict[str, Any],
    tokens: torch.Tensor,  # int [B, T]
    lengths: torch.Tensor,  # int [B]
    spec: RNNSpec,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    model_group=None,
) -> torch.Tensor:
    """Encode token batches to [B, H] f32 embeddings on the params' device.

    ``train=True`` turns inter-layer dropout on (when ``spec.dropout > 0``
    and there is more than one layer); its masks are drawn from
    ``generator``, which must live on the params' device. ``model_group``:
    the process group of ``spec.embedding_axis`` (a row-sharded table)."""
    cdt = torch_dtype(spec.compute_dtype)
    B, T = tokens.shape
    x = embedding_lookup(params["embedding"], tokens, spec.embedding_axis,
                         model_group)  # [B, T, E] f32
    lengths = lengths.to(x.device)
    mask2 = (torch.arange(T, device=x.device)[:, None] < lengths[None, :]).float()  # [T, B]
    directions = ("fwd", "bwd") if spec.bidirectional else ("fwd",)
    use_dropout = train and spec.dropout > 0.0 and spec.num_layers > 1
    if use_dropout and generator is None:
        raise ValueError("a dropout generator is required when train=True and dropout > 0")
    hist = history_in_cdt(spec.compute_dtype)

    # The layer input is carried as per-direction parts (the previous
    # layer's fwd/bwd outputs): the input projection contracts each part
    # against its row block of w_ih, so no [T, B, 2H] concat is made, and
    # it is hoisted out of the time loop as one product per part.
    # torch.matmul on bf16 would return bf16 where JAX asks for f32
    # (preferred_element_type), so matmul_f32 multiplies the cdt-rounded
    # operands in f32.
    # On the card the kernel then reads xp rounded to cdt (as the TPU
    # kernel does); the XLA scan JAX runs on the CPU keeps xp in f32, so
    # the two agree exactly only at f32 compute.
    # Each layer runs at the kernels' width Hk: its weights are zero-padded
    # to Hk units (autograd slices the padded gradients away), a padded
    # unit stays zero and feeds nothing into the real ones, and its outputs
    # are sliced back to H.
    parts = (x.transpose(0, 1),)  # tuple of [T, B, *]
    finals = {}
    G, H = spec.num_gates, spec.hidden_dim
    Hk = kernel_width(H)
    for li, layer in enumerate(params["layers"]):
        w_hh = torch.stack([layer[d]["w_hh"] for d in directions])  # [D, H, G*H]
        b_hh = torch.stack([layer[d]["b_hh"] for d in directions])  # [D, G*H]
        w_hh, b_hh, _ = pad_layer(spec.rnn_type, Hk, w_hh, b_hh, ())
        xps = []
        for d in directions:
            w_ih = pad_units(layer[d]["w_ih"], G, H, Hk)
            acc = None
            row = 0
            for p in parts:
                term = matmul_f32(p, w_ih[row : row + p.shape[-1]], cdt)
                acc = term if acc is None else acc + term
                row += p.shape[-1]
            xps.append(acc + pad_units(layer[d]["b_ih"], G, H, Hk))  # [T, B, G*Hk] f32
        *outs, h_final = _ScanLayer.apply(
            spec.rnn_type, spec.compute_dtype, hist, mask2, w_hh, b_hh, *xps
        )
        for di, d in enumerate(directions):
            finals[d] = h_final[di, :, :H]
        parts = tuple(o[..., :H] for o in outs)
        if use_dropout and li < spec.num_layers - 1:
            parts = dropout_parts(parts, 1.0 - spec.dropout, generator)

    if spec.bidirectional:
        hidden = torch.cat([finals["fwd"], finals["bwd"]], dim=-1)  # [B, 2H]
        proj = params["projection"]
        hidden = matmul_f32(hidden, proj["w"], cdt) + proj["b"]
    else:
        hidden = finals["fwd"]

    # Zero-length rows encode to exactly zero (the projection bias would
    # otherwise leak through).
    hidden = hidden * (lengths > 0).float()[:, None]
    if spec.normalize_output:
        norm = torch.linalg.vector_norm(hidden, dim=-1, keepdim=True).clamp_min(1e-12)
        hidden = hidden / norm
    return hidden
