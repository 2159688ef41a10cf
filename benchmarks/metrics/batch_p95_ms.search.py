"""The 95th percentile of the search micro-batches' latency (from the start
of a batch's tokenization to its results on the host), over every batch
of the window, by nearest rank (the untraced window of a traced run, on
the host clock). The cell runs at saturation, one client back to back, so
this tail is a per-layer reading beside ``search_qps``."""

from benchmarks.harness.search_driver import p95

UNIT, SOURCE, LAYER, MOVES = "ms", "host_clock", "Engine dense chain", "search_qps"


def read(ctx):
    w = ctx.window
    if not w or not w.get("latencies_s"):
        return None
    return 1e3 * p95(w["latencies_s"])
