"""Device time of the query tower a search micro-batch: the kernels,
copies and memsets launched inside the program's ``ttr.tower.query``
spans, matched to their launches by correlation id, over the traced
batches."""

from benchmarks.harness.spans import per_batch

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "Engine dense chain", "search_qps"


def read(ctx):
    return per_batch(ctx, lambda spans, n: spans.device_us("ttr.tower.query") / n / 1e3)
