"""Device time of a training step's forward: the kernels, copies and memsets
launched inside the program's ``ttr.train.forward`` spans (the towers, the
loss and the metric sums), matched to their launches by correlation id,
over the traced window's steps."""

from benchmarks.harness.spans import per_step

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "Train step", "train_examples_per_s"


def read(ctx):
    return per_step(ctx, lambda spans, steps: spans.device_us("ttr.train.forward") / steps / 1e3)
