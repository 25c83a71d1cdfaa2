"""The device's idle share of a step, in %: 1 - (the device's busy seconds
per step in the traced window, the union of its activities' intervals) /
(the host seconds per step after the profiler stopped), so that the
profiler's own host cost does not count as idle time."""


def read(ctx):
    tr, steps, untraced = ctx.get("trace"), ctx.get("trace_steps"), ctx.get("untraced_steps")
    if tr is None or not tr.device or not steps or not untraced:
        return None
    return 100.0 * (1.0 - (tr.busy_s() / steps) / (ctx["untraced_s"] / untraced))
