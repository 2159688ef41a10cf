"""The two towers in plain PyTorch, as the configurations describe them.

Recurrent tower (``TOWER_TYPE`` rnn, GRU cell): the table lookup; per
layer and direction the input projection ``x W_ih + b_ih`` and the
recurrence ``r = s(xr + h Whr + bhr)``, ``z = s(xz + h Whz + bhz)``,
``n = tanh(xn + r * (h Whn + bhn))``, ``h' = (1 - z) n + z h`` (torch's
GRU), a padded position keeping the state (so the backward direction
starts at the last real token); inter-layer dropout on each direction's
outputs but the last layer's; the last layer's final states concatenated
and projected [2H -> H]; L2 normalized (1e-12 guard).

Transformer tower: the table lookup, the input projection plus learned
positions; per block pre-LN (eps 1e-6, population variance) softmax
attention with padded keys biased by -1e9, the output projection,
dropout, residual; pre-LN FFN with tanh GELU, dropout, residual; a final
layer norm, the mean over real positions, L2 normalized.

``drop(shape)`` returns a keep mask: the caller's dropout stream, drawn
in the order the masks are used; ``drop`` None encodes without dropout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmarks.reference.precision import matmul, recurrent_input


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def gru_tower(p, tokens, lengths, model, drop, precision):
    H, L = model["HIDDEN_DIM"], model["NUM_LAYERS"]
    keep = 1.0 - model["DROPOUT"]
    dirs = ("fwd", "bwd") if model["BIDIRECTIONAL"] else ("fwd",)
    B, T = tokens.shape
    x = p["embedding"][tokens.long()].transpose(0, 1)  # [T, B, E]
    mask = (torch.arange(T, device=x.device)[:, None] < lengths[None, :]).float()[..., None]
    parts = [x]
    finals = {}
    for li in range(L):
        layer = p["layers"][li]
        outs = []
        for d in dirs:
            w = layer[d]
            xp = None
            row = 0
            for part in parts:
                term = matmul(part, w["w_ih"][row : row + part.shape[-1]], precision)
                xp = term if xp is None else xp + term
                row += part.shape[-1]
            xp = recurrent_input(xp + w["b_ih"], precision)
            h = torch.zeros((B, H), device=x.device)
            seq = [None] * T
            steps = range(T) if d == "fwd" else range(T - 1, -1, -1)
            for t in steps:
                hp = matmul(h, w["w_hh"], precision) + w["b_hh"]
                r = torch.sigmoid(xp[t, :, :H] + hp[:, :H])
                z = torch.sigmoid(xp[t, :, H : 2 * H] + hp[:, H : 2 * H])
                n = torch.tanh(xp[t, :, 2 * H :] + r * hp[:, 2 * H :])
                m = mask[t]
                h = m * ((1.0 - z) * n + z * h) + (1.0 - m) * h
                seq[t] = h
            outs.append(torch.stack(seq))
            finals[d] = h
        parts = outs
        if drop is not None and li < L - 1 and model["DROPOUT"] > 0:
            parts = [o * drop(o.shape) / keep for o in parts]
    if len(dirs) == 2:
        hidden = torch.cat([finals["fwd"], finals["bwd"]], dim=-1)
        hidden = matmul(hidden, p["projection"]["w"], precision) + p["projection"]["b"]
    else:
        hidden = finals["fwd"]
    hidden = hidden * (lengths > 0).float()[:, None]
    return _normalize(hidden)


def _layer_norm(x, p, eps=1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def transformer_tower(p, tokens, lengths, model, drop, precision):
    H, nh = model["HIDDEN_DIM"], model["NUM_HEADS"]
    hd = H // nh
    keep = 1.0 - model["DROPOUT"]
    B, T = tokens.shape
    valid = (torch.arange(T, device=tokens.device)[None, :] < lengths[:, None]).float()
    bias = ((1.0 - valid) * -1e9)[:, None, None, :]
    x = p["embedding"][tokens.long()]
    x = matmul(x, p["input_proj"]["w"], precision) + p["input_proj"]["b"] \
        + p["pos_embedding"][:T][None]
    for blk in p["blocks"]:
        masks = ([drop((B, T, H)) for _ in range(2)] if drop is not None and model["DROPOUT"] > 0
                 else [None, None])
        y = _layer_norm(x, blk["ln1"])
        qkv = matmul(y, blk["qkv"]["w"].reshape(H, 3 * H), precision).reshape(B, T, 3, H) \
            + blk["qkv"]["b"]
        q, k, v = (qkv[:, :, c].reshape(B, T, nh, hd).transpose(1, 2) for c in range(3))
        s = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(hd) + bias
        a = matmul(torch.softmax(s, dim=-1), v, precision)
        a = a.transpose(1, 2).reshape(B, T, H)
        a = matmul(a, blk["attn_out"]["w"], precision) + blk["attn_out"]["b"]
        x = x + (a * masks[0] / keep if masks[0] is not None else a)
        y = _layer_norm(x, blk["ln2"])
        f = F.gelu(matmul(y, blk["ffn_in"]["w"], precision) + blk["ffn_in"]["b"],
                   approximate="tanh")
        f = matmul(f, blk["ffn_out"]["w"], precision) + blk["ffn_out"]["b"]
        x = x + (f * masks[1] / keep if masks[1] is not None else f)
    x = _layer_norm(x, p["ln_final"])
    pooled = (x * valid[..., None]).sum(dim=1) / valid.sum(dim=-1, keepdim=True).clamp_min(1.0)
    pooled = pooled * (lengths > 0).float()[:, None]
    return _normalize(pooled)


def tower(model):
    return transformer_tower if model.get("TOWER_TYPE", "rnn") == "transformer" else gru_tower
