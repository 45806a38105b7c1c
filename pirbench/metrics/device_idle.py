"""device_idle: the share of the traced window in which no operation of
the program ran on the card (1 - the union of its device intervals over
the window)."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
