"""The recurrent forward kernel's share of its roofline in the query
tower: every layer call of the traced batches (``yardstick.rnn_fwd_bound``
at the batch's rows and the query width) over the device time of the
launches named ``rnn_fwd_*``."""

from benchmarks.harness.readers import dtype_bytes, roofline_share
from benchmarks.harness.yardstick import rnn_fwd_bound

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "Recurrent kernels", "search_qps"
PATTERN = r"\brnn_fwd_"


def read(ctx):
    m = ctx.model
    H = -(-int(m["HIDDEN_DIM"]) // 8) * 8
    G = {"GRU": 3, "LSTM": 4, "RNN": 1}[str(m.get("RNN_TYPE", "GRU")).upper()]
    D = 2 if m.get("BIDIRECTIONAL", False) else 1
    cdt = dtype_bytes(m, "COMPUTE_DTYPE", "bfloat16")
    n = ctx.traced_batches * int(m["NUM_LAYERS"])
    call = rnn_fwd_bound(int(m["MAX_QUERY_LEN"]), ctx.window["batch"], H, D, G, cdt, cdt)
    return roofline_share(ctx.trace, PATTERN, [call] * n)
