"""Arithmetic the per-layer metrics share: a kernel's roofline share over
a traced window, from the calls the window's steps made (their shapes are
the benchmark's own) and the device time of the launches whose names
match the metric's patterns."""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

from benchmarks.harness.yardstick import least_seconds


def roofline_share(trace, pattern: str, calls: Iterable[Tuple[int, int]]) -> Optional[float]:
    """100 x (the calls' least seconds) / (the matching launches' device
    seconds); ``calls``: (bytes, operations) of every call in the window.
    None where the trace has no such launch."""
    if trace is None:
        return None
    device_us, n = trace.device_time_us(pattern)
    if n == 0 or device_us <= 0:
        return None
    least = sum(least_seconds(b, f) for b, f in calls)
    return 100.0 * least / (device_us / 1e6)


def dtype_bytes(model: dict, key: str, default: str) -> int:
    return 4 if str(model.get(key, default)) == "float32" else 2


def per_tower_widths(steps) -> Iterable[Tuple[int, int]]:
    """(global batch rows, width) of each tower call of the traced steps."""
    for B, Tq, Td in steps:
        yield B, Tq
        yield B, Td


def recurrent_calls(ctx, bound: Callable):
    """(bytes, operations) of each recurrent layer call of the traced
    steps, both towers, all directions in one call, at the rows one card
    holds."""
    m = ctx.model
    H = -(-int(m["HIDDEN_DIM"]) // 8) * 8  # the kernels' width
    G = {"GRU": 3, "LSTM": 4, "RNN": 1}[str(m.get("RNN_TYPE", "GRU")).upper()]
    D = 2 if m.get("BIDIRECTIONAL", False) else 1
    cdt = dtype_bytes(m, "COMPUTE_DTYPE", "bfloat16")
    for B, T in per_tower_widths(ctx.traced_steps):
        for _ in range(int(m["NUM_LAYERS"])):
            yield bound(T, B // ctx.ranks, H, D, G, cdt, cdt)


def span_self_ms(trace, span: str):
    """Mean over the trace's ``span`` spans of each one's wall time less the
    device's busy time inside it, in ms; None without such spans or without
    device operations."""
    if trace is None or not trace.device:
        return None
    spans = [(a, b) for a, b, n in trace.spans if n == span]
    if not spans:
        return None
    total = 0.0
    for a, b in spans:
        busy = sum(max(0.0, min(e, b) - max(s, a)) for s, e in trace.merged)
        total += (b - a) - busy
    return total / len(spans) / 1e3


def search_batch_least_seconds(model: dict, cell: dict, batch: int) -> float:
    """The least time of one micro-batch of the dense chain: the query
    tower's and the scan's operations at the bf16 rate against the bytes
    read once: the index (its rows padded to the 8192-row tile, in the
    storage dtype), the query tower's f32 weights, the table rows the
    tokens select, the token ids and lengths (int64), and the [batch, 2k]
    f32 result."""
    from benchmarks.harness.yardstick import gru_tower_flops

    H, E, L = int(model["HIDDEN_DIM"]), int(model["EMBED_DIM"]), int(model["NUM_LAYERS"])
    T = int(model["MAX_QUERY_LEN"])
    D = 2 if model.get("BIDIRECTIONAL", False) else 1
    rows = -(-int(cell["index_rows"]) // 8192) * 8192
    storage = {"float32": 4, "bfloat16": 2, "int8": 1}[cell["storage_dtype"]]
    flops = gru_tower_flops(batch, T, E, H, L, D) + 2 * batch * H * rows
    weights = sum(D * ((E if i == 0 else D * H) + H + 2) * 3 * H for i in range(L))
    if D == 2:
        weights += 2 * H * H + H
    nbytes = (rows * H * storage + 4 * weights + batch * T * E * 4 + batch * (T + 1) * 8
              + batch * 2 * int(cell["k"]) * 4)
    return least_seconds(nbytes, flops)
