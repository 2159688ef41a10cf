"""Synchronizing calls a training step makes: the CUDA runtime's and
driver's calls that wait for the card (``harness/spans.py``
``SYNC_CALLS``) made inside the program's ``ttr.train.step`` spans, on any
thread, over the traced window's steps."""

from benchmarks.harness.spans import per_step

UNIT, SOURCE, LAYER, MOVES = "count", "program_counter", "Train step", "train_examples_per_s"


def read(ctx):
    return per_step(ctx, lambda spans, steps: len(spans.syncs_in("ttr.train.step")) / steps)
