"""The segment-max scan's share of its roofline: the traced batches'
scans (``yardstick.segmax_bound``, one launch a batch of 32 queries over
the padded index in the storage dtype, without the score cache) over the
device time of the launches named ``segmax_mma_kernel``."""

from benchmarks.harness.readers import roofline_share
from benchmarks.harness.yardstick import segmax_bound

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "Index search", "search_qps"
PATTERN = r"\bsegmax_mma_kernel\b"


def read(ctx):
    n = ctx.traced_batches
    rows = -(-int(ctx.spec["index_rows"]) // 8192) * 8192
    H = -(-int(ctx.model["HIDDEN_DIM"]) // 16) * 16
    storage = {"float32": 4, "bfloat16": 2}[ctx.spec["storage_dtype"]]
    B = ctx.window["batch"]
    return roofline_share(ctx.trace, PATTERN, [segmax_bound(B, H, rows, storage)] * n)
