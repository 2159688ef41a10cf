"""The card's idle share of the traced search window: 100 x (1 - the
union of the device operations' intervals / the window's extent)."""

UNIT, SOURCE, LAYER, MOVES = "%", "device_trace", "Device", "search_qps"


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)
