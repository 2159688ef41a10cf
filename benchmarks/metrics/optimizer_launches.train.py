"""Device operations a training step's optimizer launches: the kernels,
copies and memsets launched inside the program's ``ttr.train.optimizer``
spans (the gradient clip and Adam), matched to their launches by
correlation id, over the traced window's steps. The per-leaf loop launches
about 18 a leaf; the multi-tensor kernel two, and one for the step count."""

from benchmarks.harness.spans import per_step

UNIT, SOURCE, LAYER, MOVES = "count", "program_counter", "Train step", "train_examples_per_s"


def read(ctx):
    return per_step(ctx, lambda spans, steps: spans.launches_in("ttr.train.optimizer") / steps)
