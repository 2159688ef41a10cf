"""Transformer encoder towers in PyTorch.

The port of the JAX package's ``models/transformer.py`` (the config-5
tower, ``configs/transformer_tp.json``): a pre-LN transformer encoder over
the GloVe vocabulary, masked mean-pooled to a [B, H] embedding, zero-length
rows exactly zero, L2 normalized with a 1e-12 guard.

What it keeps from the JAX tower:

- the parameter tree and its ``model.npz`` keys: the head-major qkv weight
  ``[H, 3, H]`` (bias ``[3, H]``), ``blocks`` as a tuple, ``ln_final``; the
  legacy ``[H, 3H]`` qkv layout of older checkpoints is read too;
- both attention routes under the JAX policy (``use_fused_attention``):
  by default scores in the compute dtype times a compute-dtype
  ``1/sqrt(hd)`` plus the compute-dtype bias, an f32 softmax and
  compute-dtype probabilities; with ``fused_attention=True`` the fused
  kernels (:func:`ops.attention.fused_attention`, f32 scores);
- ``residual_dtype`` (float32 or bfloat16) with f32 layer-norm statistics
  (eps 1e-6, population variance) and GELU (tanh approximation, as
  ``jax.nn.gelu``) on the f32 product before the residual cast;
- dropout after the attention and FFN sublayers from the explicit
  generator, dividing by the keep rate rounded to the stream dtype (JAX
  rounds the weak-typed scalar so, as it does the compute-dtype scale);
- ``remat_blocks`` through ``torch.utils.checkpoint``. A block's dropout
  masks are drawn before the block runs and passed in, so the
  recomputation in the backward reuses them: ``checkpoint`` restores the
  global generators only, and drawing from ``generator`` again would give
  other masks.

Tensor parallelism over the mesh's ``model`` group (``model_axis_size``
M > 1, config 5's ``MESH_MODEL``): each rank holds whole heads (qkv
``[H, 3, H/M]``, bias ``[3, H/M]``) and a slice of the FFN columns
(``ffn_in`` ``[H, F/M]``), and the row-split ``attn_out`` and ``ffn_out``
weights (``[H/M, H]``, ``[F/M, H]``); the replicated activation entering
each column-split product passes :func:`parallel.collectives.copy_to_tp`
and each row-split product's partial sum :func:`~parallel.collectives.
reduce_from_tp`, two sums a block forward and two backward, and the
replicated out-projection biases are added once, after the sum. The
process group is passed at call time (``model_group``); the spec only
names the axis. With ``embedding_axis`` the table is this rank's row
block (``parallel/embedding.py``). Dropout masks are [B, T, H] and drawn
the same on every rank of a model group (their generators share a seed:
``train/train_step.py:_fold_in`` keys on the data index only).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from twotowermlretrieval_tpu_torch.ops.attention import fused_attention, use_fused_attention
from twotowermlretrieval_tpu_torch.parallel.collectives import copy_to_tp, reduce_from_tp
from twotowermlretrieval_tpu_torch.parallel.embedding import embedding_lookup
from twotowermlretrieval_tpu_torch.utils.dtypes import bernoulli_mask, matmul_f32, torch_dtype


@dataclasses.dataclass(frozen=True)
class TransformerSpec:
    """Static architecture description (field meanings as in the JAX
    package's ``TransformerSpec``)."""

    vocab_size: int
    embed_dim: int
    hidden_dim: int
    num_layers: int = 6
    num_heads: int = 4
    ffn_dim: int = 1024
    dropout: float = 0.0
    normalize_output: bool = True
    compute_dtype: str = "bfloat16"
    max_len: int = 512  # learned positional table size
    embedding_axis: Optional[str] = None
    model_axis: Optional[str] = None
    model_axis_size: int = 1
    remat_blocks: bool = False
    residual_dtype: str = "float32"
    fused_attention: Optional[bool] = None  # None = off, True/False force

    def __post_init__(self):
        if self.hidden_dim % self.num_heads != 0:
            raise ValueError("hidden_dim must divide num_heads")
        if self.model_axis is not None and self.model_axis_size > 1:
            if self.num_heads % self.model_axis_size:
                raise ValueError(f"num_heads={self.num_heads} must divide evenly over the "
                                 f"model axis ({self.model_axis_size})")
            if self.ffn_dim % self.model_axis_size:
                raise ValueError(f"ffn_dim={self.ffn_dim} must divide evenly over the "
                                 f"model axis ({self.model_axis_size})")

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @classmethod
    def from_config(cls, config) -> "TransformerSpec":
        tp = getattr(config, "mesh_model", 1) > 1
        return cls(
            vocab_size=config.vocab_size,
            embed_dim=config.embed_dim,
            hidden_dim=config.hidden_dim,
            num_layers=config.num_layers,
            num_heads=config.num_heads,
            ffn_dim=config.ffn_dim,
            dropout=config.dropout,
            normalize_output=config.normalize_output,
            compute_dtype=config.compute_dtype,
            max_len=max(config.max_doc_len, config.max_query_len),
            embedding_axis="model" if config.shard_embedding_table else None,
            model_axis="model" if tp else None,
            model_axis_size=config.mesh_model if tp else 1,
            remat_blocks=getattr(config, "remat_blocks", False),
            residual_dtype=getattr(config, "residual_dtype", "float32"),
            fused_attention=getattr(config, "fused_attention", None),
        )


def init_transformer_encoder(
    generator: torch.Generator,
    spec: TransformerSpec,
    pretrained_embeddings: Optional[np.ndarray] = None,
) -> Dict[str, Any]:
    """Encoder params as f32 CPU tensors, the JAX init's laws: dense weights
    N(0, 1/fan_in), biases and layer-norm shifts 0, scales 1, positions
    N(0, 0.02^2), the table copied from the pretrained array or drawn
    N(0, 1). The numbers differ from the JAX package's for the same seed
    (another generator); the layout is the same."""
    H, ffn = spec.hidden_dim, spec.ffn_dim

    def normal(shape, std=1.0):
        return torch.randn(shape, generator=generator, dtype=torch.float32) * std

    def dense(fan_in, fan_out):
        return normal((fan_in, fan_out), 1.0 / math.sqrt(fan_in))

    def norm():
        return {"scale": torch.ones(H), "bias": torch.zeros(H)}

    if pretrained_embeddings is not None:
        if pretrained_embeddings.shape != (spec.vocab_size, spec.embed_dim):
            raise ValueError(
                f"pretrained table {pretrained_embeddings.shape} != "
                f"({spec.vocab_size}, {spec.embed_dim})"
            )
        embedding = torch.as_tensor(np.asarray(pretrained_embeddings, np.float32)).clone()
    else:
        embedding = normal((spec.vocab_size, spec.embed_dim))
    params: Dict[str, Any] = {
        "embedding": embedding,
        "input_proj": {"w": dense(spec.embed_dim, H), "b": torch.zeros(H)},
        "pos_embedding": normal((spec.max_len, H), 0.02),
    }
    blocks = []
    for _ in range(spec.num_layers):
        blocks.append({
            "ln1": norm(),
            # head-major [H, 3, H]: the last axis is heads x head_dim
            "qkv": {"w": dense(H, 3 * H).reshape(H, 3, H), "b": torch.zeros(3, H)},
            "attn_out": {"w": dense(H, H), "b": torch.zeros(H)},
            "ln2": norm(),
            "ffn_in": {"w": dense(H, ffn), "b": torch.zeros(ffn)},
            "ffn_out": {"w": dense(ffn, H), "b": torch.zeros(H)},
        })
    params["blocks"] = tuple(blocks)
    params["ln_final"] = norm()
    return params


def _layer_norm(x, p, out_dtype=None, eps=1e-6):
    """f32 statistics (population variance) whatever the stream dtype; the
    result cast to ``out_dtype`` (default: x's dtype)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(out_dtype or x.dtype)


def _dense(x, p, cdt):
    return matmul_f32(x, p["w"], cdt) + p["b"]


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a host float: a scalar operand
    that keeps a tensor's dtype (JAX rounds a weak-typed scalar so)
    without a copy to the device."""
    return torch.tensor(value, dtype=dtype).item()


def _dropout(x, mask, keep: float):
    """Inverted dropout with a drawn mask (None: off)."""
    if mask is None:
        return x
    return x * mask / _rounded(keep, x.dtype)


def _attention(qkv, attn_bias, spec: TransformerSpec, cdt, rdt):
    """Softmax attention over ``qkv`` [B, T, 3, H_local] (this rank's heads;
    f32 sums, read in the residual dtype) -> [B, T, H_local] f32, by the
    route the JAX policy picks."""
    B, T, _, n_out = qkv.shape
    hd = spec.head_dim
    nh = n_out // hd
    split = [qkv[:, :, c].reshape(B, T, nh, hd) for c in range(3)]
    if use_fused_attention(T, hd, spec.fused_attention):
        # [B, nh, T, hd] flattened to [R, T, hd], the bias broadcast to [R, T];
        # the kernel reads q, k, v in the residual dtype and, as in JAX,
        # their gradients come back in f32
        q, k, v = (t.transpose(1, 2).reshape(B * nh, T, hd) for t in split)
        bias_rows = attn_bias[:, 0].expand(B, nh, T).reshape(B * nh, T)
        attn = fused_attention(q, k, v, bias_rows, float(1.0 / np.sqrt(hd)), spec.compute_dtype,
                               input_dtype=rdt)
        return attn.reshape(B, nh, T, hd).transpose(1, 2).reshape(B, T, nh * hd)
    # the default route: scores rounded to the compute dtype, times the
    # compute-dtype scale, plus the compute-dtype bias; f32 softmax
    q, k, v = (t.to(rdt).transpose(1, 2) for t in split)  # [B, nh, T, hd]
    scale = _rounded(1.0 / np.sqrt(hd), cdt)
    scores = matmul_f32(q, k.transpose(-1, -2), cdt).to(cdt) * scale + attn_bias.to(cdt)
    probs = torch.softmax(scores.float(), dim=-1).to(cdt)
    attn = matmul_f32(probs, v, cdt)  # [B, nh, T, hd]
    return attn.transpose(1, 2).reshape(B, T, nh * hd)


def _run_block(x, attn_bias, block, masks, spec: TransformerSpec, group=None):
    """One pre-LN block; ``group``: the model group under tensor
    parallelism (``None``: the whole block on this rank)."""
    cdt, rdt = torch_dtype(spec.compute_dtype), torch_dtype(spec.residual_dtype)
    B, T, _ = x.shape
    keep = 1.0 - spec.dropout

    def enter(v):  # the replicated activation into a column-split product
        return v if group is None else copy_to_tp(v, group)

    def leave(v):  # a row-split product's partial sum
        return v if group is None else reduce_from_tp(v, group)

    # --- attention sublayer (pre-LN) ---
    y = enter(_layer_norm(x, block["ln1"], out_dtype=rdt))
    w_qkv, b_qkv = block["qkv"]["w"], block["qkv"]["b"]
    if w_qkv.dim() == 2:
        # legacy checkpoint layout [H, 3H] / [3H], columns ordered q|k|v
        w_qkv = w_qkv.reshape(w_qkv.shape[0], 3, w_qkv.shape[1] // 3)
        b_qkv = b_qkv.reshape(3, -1)
    n_out = w_qkv.shape[-1]
    qkv = matmul_f32(y, w_qkv.reshape(w_qkv.shape[0], 3 * n_out), cdt).reshape(B, T, 3, n_out)
    attn = _attention(qkv + b_qkv, attn_bias, spec, cdt, rdt)
    # the replicated bias is added once, after the sum
    attn = leave(matmul_f32(attn.to(rdt), block["attn_out"]["w"], cdt)) + block["attn_out"]["b"]
    x = x + _dropout(attn.to(rdt), masks[0], keep).to(rdt)
    # --- FFN sublayer ---
    y = enter(_layer_norm(x, block["ln2"], out_dtype=rdt))
    h = F.gelu(_dense(y, block["ffn_in"], cdt), approximate="tanh").to(rdt)
    y = leave(matmul_f32(h, block["ffn_out"]["w"], cdt)) + block["ffn_out"]["b"]
    return x + _dropout(y.to(rdt), masks[1], keep).to(rdt)


def transformer_encode(
    params: Dict[str, Any],
    tokens: torch.Tensor,  # int [B, T]
    lengths: torch.Tensor,  # int [B]
    spec: TransformerSpec,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    model_group=None,
) -> torch.Tensor:
    """Masked pre-LN transformer encoder -> masked mean-pool -> [B, H] f32
    on the params' device. ``train=True`` turns dropout on (when
    ``spec.dropout > 0``); its masks come from ``generator``, which must
    live on the params' device. ``model_group``: the process group of the
    spec's model axis (tensor parallelism, a row-sharded table), where
    ``params`` holds this rank's shards."""
    cdt, rdt = torch_dtype(spec.compute_dtype), torch_dtype(spec.residual_dtype)
    B, T = tokens.shape
    H = spec.hidden_dim
    use_dropout = train and spec.dropout > 0.0
    if use_dropout and generator is None:
        raise ValueError("a dropout generator is required when train=True and dropout > 0")
    tp = spec.model_axis is not None and spec.model_axis_size > 1
    if tp and model_group is None:
        raise ValueError(f"the spec splits heads over {spec.model_axis!r} but no process "
                         "group was passed (model_group)")
    group = model_group if tp else None
    emb = params["embedding"]
    lengths = lengths.to(emb.device)
    valid = (torch.arange(T, device=emb.device)[None, :] < lengths[:, None]).float()  # [B, T]
    attn_bias = ((1.0 - valid) * -1e9)[:, None, None, :]  # [B, 1, 1, T]

    x = embedding_lookup(emb, tokens, spec.embedding_axis, model_group)  # [B, T, E]
    x = (_dense(x, params["input_proj"], cdt) + params["pos_embedding"][:T][None]).to(rdt)
    for block in params["blocks"]:
        masks = (None, None)
        if use_dropout:  # drawn here, in the order the block applies them
            masks = tuple(bernoulli_mask(generator, 1.0 - spec.dropout, (B, T, H), x.device)
                          for _ in range(2))
        if spec.remat_blocks and torch.is_grad_enabled():
            # the backward re-runs the block's forward sums, on every rank
            # of the group in the same order
            x = checkpoint(_run_block, x, attn_bias, block, masks, spec, group,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _run_block(x, attn_bias, block, masks, spec, group)

    x = _layer_norm(x, params["ln_final"], out_dtype=torch.float32)
    denom = valid.sum(dim=-1, keepdim=True).clamp_min(1.0)
    pooled = (x * valid[..., None]).sum(dim=1) / denom
    pooled = pooled * (lengths > 0).float()[:, None]
    if spec.normalize_output:
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-12)
        pooled = pooled / norm
    return pooled
