"""The weights of a run, made on the device from the seed.

Both sides get the same tensors: the program (through
``train/train_step.py:create_train_state``, which copies its trainable
leaves) and the plain reference, which makes them again from the seed.
The tree has the layout of the port's ``init_two_tower`` and its laws: a
recurrent tower's weights uniform in +-1/sqrt(H) (the projection
+-1/sqrt(2H)), a transformer's dense weights N(0, 1/fan_in), biases and
layer-norm shifts 0, scales 1, positions N(0, 0.02^2). The table is
N(0, table_std^2), shared by both towers, in the shape of the
configuration's vocabulary. Each law is one draw from a CUDA (or CPU)
generator over all the leaves it covers, then cut into views.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmarks.harness.seeds import sub_seed


def _cut(flat: torch.Tensor, shapes: List[Tuple[int, ...]]) -> List[torch.Tensor]:
    out, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[off : off + n].view(shape))
        off += n
    return out


def make_table(model: dict, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "table"))
    V, E = model["VOCAB_SIZE"], model["EMBED_DIM"]
    return torch.randn((V, E), generator=gen, device=device) * float(model["TABLE_STD"])


def _rnn_tower_shapes(model: dict):
    H, E, L = model["HIDDEN_DIM"], model["EMBED_DIM"], model["NUM_LAYERS"]
    G = {"GRU": 3, "LSTM": 4, "RNN": 1}[model.get("RNN_TYPE", "GRU").upper()]
    dirs = ("fwd", "bwd") if model.get("BIDIRECTIONAL", False) else ("fwd",)
    leaves = []
    for layer in range(L):
        inp = E if layer == 0 else H * len(dirs)
        for d in dirs:
            leaves += [((layer, d, "w_ih"), (inp, G * H)), ((layer, d, "w_hh"), (H, G * H)),
                       ((layer, d, "b_ih"), (G * H,)), ((layer, d, "b_hh"), (G * H,))]
    return dirs, leaves


def make_rnn_params(model: dict, seed: int, device, table: torch.Tensor) -> Dict:
    H, L = model["HIDDEN_DIM"], model["NUM_LAYERS"]
    dirs, leaves = _rnn_tower_shapes(model)
    proj = [(2 * H, H), (H,)] if len(dirs) == 2 else []
    shapes = [s for _, s in leaves]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    n_main = 2 * sum(math.prod(s) for s in shapes)
    n_proj = 2 * sum(math.prod(s) for s in proj)
    u = torch.rand(n_main + n_proj, generator=gen, device=device) * 2.0 - 1.0
    main = u[:n_main] / math.sqrt(H)
    side = u[n_main:] / math.sqrt(2 * H)
    trees = {}
    half, half_p = n_main // 2, n_proj // 2
    for t, tower in enumerate(("query", "doc")):
        cut = _cut(main[t * half : (t + 1) * half], shapes)
        layers = [{d: {} for d in dirs} for _ in range(L)]
        for ((layer, d, name), _), leaf in zip(leaves, cut):
            layers[layer][d][name] = leaf
        tree = {"embedding": table, "layers": tuple(layers)}
        if proj:
            w, b = _cut(side[t * half_p : (t + 1) * half_p], proj)
            tree["projection"] = {"w": w, "b": b}
        trees[tower] = tree
    return trees


def make_transformer_params(model: dict, seed: int, device, table: torch.Tensor) -> Dict:
    H, E, L, F = model["HIDDEN_DIM"], model["EMBED_DIM"], model["NUM_LAYERS"], model["FFN_DIM"]
    max_len = max(model["MAX_DOC_LEN"], model["MAX_QUERY_LEN"])
    dense = [(E, H)] + [(H, 3 * H), (H, H), (H, F), (F, H)] * L
    shapes = dense + [(max_len, H)]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    per_tower = sum(math.prod(s) for s in shapes)
    z = torch.randn(2 * per_tower, generator=gen, device=device)
    trees = {}
    for t, tower in enumerate(("query", "doc")):
        cut = _cut(z[t * per_tower : (t + 1) * per_tower], shapes)
        ws = [c / math.sqrt(s[0]) for c, s in zip(cut[:-1], dense)]
        pos = cut[-1] * 0.02

        def norm():
            return {"scale": torch.ones(H, device=device), "bias": torch.zeros(H, device=device)}

        def zeros(*shape):
            return torch.zeros(shape, device=device)

        blocks = []
        for b in range(L):
            qkv, out, fin, fout = ws[1 + 4 * b : 5 + 4 * b]
            blocks.append({
                "ln1": norm(),
                "qkv": {"w": qkv.reshape(H, 3, H), "b": zeros(3, H)},
                "attn_out": {"w": out, "b": zeros(H)},
                "ln2": norm(),
                "ffn_in": {"w": fin, "b": zeros(F)},
                "ffn_out": {"w": fout, "b": zeros(H)},
            })
        trees[tower] = {
            "embedding": table,
            "input_proj": {"w": ws[0], "b": zeros(H)},
            "pos_embedding": pos,
            "blocks": tuple(blocks),
            "ln_final": norm(),
        }
    return trees


def make_params(model: dict, seed: int, device) -> Dict:
    """The two towers' weights for a run with ``seed``: a tree of f32
    tensors on ``device``."""
    table = make_table(model, seed, device)
    if model.get("TOWER_TYPE", "rnn") == "transformer":
        return make_transformer_params(model, seed, device, table)
    return make_rnn_params(model, seed, device, table)
