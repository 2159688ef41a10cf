"""Host time a search micro-batch adds: over the traced batches
(``bench.batch`` spans), each batch's wall time less the card's busy time
inside it, averaged. It moves ``search_qps`` because one client waits for
each batch before it sends the next."""

from benchmarks.harness.readers import span_self_ms

UNIT, SOURCE, LAYER, MOVES = "ms", "device_trace", "Engine dense chain", "search_qps"


def read(ctx):
    return span_self_ms(ctx.trace, "bench.batch")
