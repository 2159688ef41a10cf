"""The card's idle share of the traced training window: 100 x (1 - the
union of the device operations' intervals / the window's extent), the
arithmetic of the port's ``trace_summary``, frozen in
``harness/trace.py``."""

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "Device", "train_examples_per_s"


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)
