"""Host time of the query tower a search micro-batch: the wall time of the
program's ``ttr.tower.query`` spans (enqueueing the tower's launches),
over the traced batches."""

from benchmarks.harness.spans import per_batch

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "Engine dense chain", "search_qps"


def read(ctx):
    return per_batch(ctx, lambda spans, n: spans.wall_us("ttr.tower.query") / n / 1e3)
