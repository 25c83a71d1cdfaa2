"""Model FLOPs per second over the card's bf16 peak, in %: 3 x the forward's
FLOPs of each batch stepped (remat's recompute not counted), over the part
of the window after the profiler stopped (steps and host seconds)."""


def read(ctx):
    peak, steps = ctx.get("peak"), ctx.get("untraced_steps")
    if not peak or not steps:
        return None
    return 100.0 * 3.0 * ctx["forward_flops_per_batch"] * steps / (ctx["untraced_s"] * peak)
