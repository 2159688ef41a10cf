"""The frozen yardstick: peaks, the kernels' least work and a training
step's model operations.

The bound functions are copies of the port's, frozen here so that a later
change to the program cannot move the measure it is held to
(``ops/rnn_scan.py`` ``rnn_fwd_bound`` / ``rnn_bwd_bound``,
``ops/attention.py`` ``attention_bound``, ``ops/topk.py``
``segmax_bound``). Each returns ``(bytes, operations)``: every input read
once, every output written once. ``benchmarks/tests/test_bench_yardstick.py``
holds them against the port's, so a drift in the program shows.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# The split products of an f32-compute product: (left piece, right piece),
# 0 = hi, 1 = mid, 2 = lo (utils/dtypes.py SPLIT_PRODUCTS).
SPLIT_PRODUCTS = ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))
SEG = 128  # the scans' covering-segment width


def least_seconds(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES_PER_S)


def rnn_fwd_bound(T: int, B: int, H: int, D: int, G: int, cdt_bytes: int, hist_bytes: int):
    """One recurrent forward call over D directions."""
    nbytes = (
        D * T * B * G * H * cdt_bytes  # xp
        + T * B * 4  # mask
        + D * H * G * H * cdt_bytes + D * G * H * 4  # w_hh, b_hh
        + D * T * B * H * hist_bytes * (2 if G == 4 else 1)  # outs (+ c history)
        + D * B * H * 4  # h_final
    )
    flops = 2 * T * D * B * H * G * H
    return nbytes, flops


def rnn_bwd_bound(T: int, B: int, H: int, D: int, G: int, cdt_bytes: int, hist_bytes: int,
                  split: bool = False):
    """One recurrent backward call: the gate recompute (a product for GRU
    and LSTM), the dh chain and the weight gradient; split mode does no
    weight-gradient product and writes dhp (GRU) instead of dW/db."""
    GH = G * H
    stream = D * T * B * GH * cdt_bytes
    nbytes = (
        stream
        + T * B * 4
        + D * T * B * H * hist_bytes * (3 if G == 4 else 2)
        + D * H * GH * cdt_bytes + D * GH * 4 + D * B * H * 4
        + stream
    )
    nbytes += stream * (G == 3) if split else D * H * GH * 4 + D * GH * 4
    products = (1 if G > 1 else 0) + 1 + (0 if split else 1)
    return nbytes, 2 * products * T * D * B * H * GH


def _bf16_products(a_bf16: bool, b_bf16: bool) -> int:
    return sum(1 for i, j in SPLIT_PRODUCTS if (i == 0 or not a_bf16) and (j == 0 or not b_bf16))


def attention_bound(R: int, T: int, hd: int, in_bytes: int, backward: bool = False,
                    compute_dtype: str = "bfloat16"):
    """One fused-attention call over R flattened heads: S = Q K^T and
    O = P V forward; S, dP, dQ, dV and dK backward, each 2*R*T*T*hd
    operations at the bf16 rate (at f32 compute once per bf16 product of
    its split)."""
    n, one = R * T * hd, 2 * R * T * T * hd
    x = in_bytes == 2
    mul = _bf16_products if compute_dtype == "float32" else (lambda a, b: 1)
    if backward:
        ops = one * (mul(x, x) + 3 * mul(False, x) + mul(False, False))
        return 3 * n * in_bytes + n * 4 + R * T * 4 + 3 * n * 4, ops
    return 3 * n * in_bytes + R * T * 4 + n * 4, one * (mul(x, x) + mul(False, x))


def segmax_bound(B: int, H: int, npad: int, storage_bytes: int):
    """Phase 1 of the exact scan, without the score cache."""
    nbytes = npad * H * storage_bytes + B * H * storage_bytes + (npad // SEG) * B * 4
    return nbytes, 2 * B * H * npad


# ---------------------------------------------------------------------------
# model operations of a training step
# ---------------------------------------------------------------------------


def gru_tower_flops(B: int, T: int, E: int, H: int, layers: int, directions: int,
                    gates: int = 3) -> int:
    """Forward multiply-adds x 2 of one recurrent tower over a [B, T]
    batch, every position of the bucket counted: each layer's input
    projection and recurrent product per direction, and the bidirectional
    projection [2H -> H]."""
    total = 0
    for layer in range(layers):
        inp = E if layer == 0 else directions * H
        total += directions * 2 * T * B * (inp + H) * gates * H
    if directions == 2:
        total += 2 * B * 2 * H * H
    return total


def transformer_tower_flops(B: int, T: int, E: int, H: int, layers: int, ffn: int) -> int:
    """Forward multiply-adds x 2 of one pre-LN transformer tower: the input
    projection, and per block qkv, Q K^T, P V, the output projection and
    the two FFN products."""
    per_block = 2 * B * T * H * 3 * H + 2 * 2 * B * T * T * H + 2 * B * T * H * H \
        + 2 * 2 * B * T * H * ffn
    return 2 * B * T * E * H + layers * per_block


def train_step_flops(model: dict, B: int, Tq: int, Td: int) -> int:
    """A training step's model operations: both towers and the in-batch
    logits [B, B] forward, times 3 (forward, and the backward's two
    products per forward product). ``model``: the configuration's keys."""
    E, H, L = model["EMBED_DIM"], model["HIDDEN_DIM"], model["NUM_LAYERS"]
    if model.get("TOWER_TYPE", "rnn") == "transformer":
        towers = sum(transformer_tower_flops(B, T, E, H, L, model["FFN_DIM"]) for T in (Tq, Td))
    else:
        gates = {"GRU": 3, "LSTM": 4, "RNN": 1}[model.get("RNN_TYPE", "GRU").upper()]
        D = 2 if model.get("BIDIRECTIONAL", False) else 1
        towers = sum(gru_tower_flops(B, T, E, H, L, D, gates) for T in (Tq, Td))
    return 3 * (towers + 2 * B * B * H)
