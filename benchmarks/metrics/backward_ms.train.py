"""Device time of a training step's backward: the kernels, copies and memsets
launched inside the program's ``ttr.train.backward`` spans (autograd's
kernels, those launched on its own thread included, and the zero fill of
unused gradients), matched to their launches by correlation id, over the
traced window's steps."""

from benchmarks.harness.spans import per_step

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "Train step", "train_examples_per_s"


def read(ctx):
    return per_step(ctx, lambda spans, steps: spans.device_us("ttr.train.backward") / steps / 1e3)
