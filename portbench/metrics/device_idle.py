"""device_idle.<cells>: the device's idle share of the traced window, in
%: 1 - (the union of its operations' intervals) / (the window)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
