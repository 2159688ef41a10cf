"""Device time of the collectives a data-parallel training step runs on
the first card: the traced window's launches whose names hold ``nccl``
(the gradient and metric all-reduce, the gathers of the cross-device
negatives), over its steps, in ms."""

UNIT, SOURCE, LAYER, MOVES = "ms", "device_trace", "Data parallel", "train_examples_per_s"
PATTERN = r"(?i)nccl"


def read(ctx):
    if ctx.trace is None or not ctx.traced_steps:
        return None
    us, n = ctx.trace.device_time_us(PATTERN)
    if n == 0:
        return None
    return us / 1e3 / len(ctx.traced_steps)
