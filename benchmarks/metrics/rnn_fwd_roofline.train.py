"""The recurrent forward kernel's share of its roofline in training: the
least time of every forward layer call of the traced steps
(``yardstick.rnn_fwd_bound``, both towers, each layer one call over its
directions, at the kernels' width) over the device time of the launches
named ``rnn_fwd_*`` (the kernel and its weight packing)."""

from benchmarks.harness.readers import recurrent_calls, roofline_share
from benchmarks.harness.yardstick import rnn_fwd_bound

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "Recurrent kernels", "train_examples_per_s"
PATTERN = r"\brnn_fwd_"


def read(ctx):
    return roofline_share(ctx.trace, PATTERN, recurrent_calls(ctx, rnn_fwd_bound))
