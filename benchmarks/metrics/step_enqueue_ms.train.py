"""The host's own cost of a training step: the wall time of the program's
``ttr.train.step`` spans less the time they spend in synchronizing calls
(``step_sync_ms.train``), over the traced window's steps."""

from benchmarks.harness.spans import per_step, step_sync_ms

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "Train step", "train_examples_per_s"


def read(ctx):
    return per_step(ctx, lambda spans, steps: spans.wall_us("ttr.train.step") / steps / 1e3
                    - step_sync_ms(spans, steps))
