"""The whole micro-batch's share of the card's peak: the least time of a
batch (``readers.search_batch_least_seconds``: the larger of its
operations over 989 TFLOP/s and its bytes over 3.35 TB/s; the bytes are
the index read once, the query tower's weights, its inputs and the
result) times the window's batches, over the window's wall time (the
untraced window of a traced run, on the host clock). It names no
kernel."""

from benchmarks.harness.readers import search_batch_least_seconds

UNIT, SOURCE, LAYER, MOVES = "%", "host_clock", "Engine dense chain", "search_qps"


def read(ctx):
    w = ctx.window
    if not w or not w.get("batches"):
        return None
    least = search_batch_least_seconds(ctx.model, ctx.spec, w["batch"])
    return 100.0 * least * w["batches"] / w["wall_s"]
