"""Device time of the search's phase 2 a micro-batch: the kernels, copies
and memsets launched inside the program's ``ttr.search.phase2`` spans
(segment selection, re-score or gather, the final top-k), matched to
their launches by correlation id, over the traced batches."""

from benchmarks.harness.spans import per_batch

UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "Index search", "search_qps"


def read(ctx):
    return per_batch(ctx, lambda spans, n: spans.device_us("ttr.search.phase2") / n / 1e3)
