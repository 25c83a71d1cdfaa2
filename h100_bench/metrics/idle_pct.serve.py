"""The device's idle share of the traced window: 1 - (the union of its
activities' intervals / the window), in %."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.device or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
