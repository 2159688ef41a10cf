"""Host time a training step spends waiting for the card: the summed
duration of the synchronizing calls inside the program's
``ttr.train.step`` spans (``step_syncs.train``'s calls), over the traced
window's steps."""

from benchmarks.harness.spans import per_step, step_sync_ms

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "Train step", "train_examples_per_s"


def read(ctx):
    return per_step(ctx, step_sync_ms)
