"""The recurrent backward's share of its roofline in training: the least
time of every backward layer call of the traced steps
(``yardstick.rnn_bwd_bound``) over the device time of its launches: the
gate recompute and weight-gradient products (``rnn_bwd_gemm``), the dh
chain, the sum, the weight packing and the split planes."""

from benchmarks.harness.readers import recurrent_calls, roofline_share
from benchmarks.harness.yardstick import rnn_bwd_bound

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "Recurrent kernels", "train_examples_per_s"
PATTERN = r"\brnn_bwd_|\bsplit_planes\b"


def read(ctx):
    return roofline_share(ctx.trace, PATTERN, recurrent_calls(ctx, rnn_bwd_bound))
