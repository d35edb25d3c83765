"""The share of the traced steps' wall time in which no kernel, copy or set
runs on the card (the union of the device's intervals)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
