"""The share of the traced window in which no kernel, copy or fill ran on
the device, in %."""


def read(out, ctx):
    if out.trace is None or out.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - out.trace.busy_s / out.trace.window_s)
