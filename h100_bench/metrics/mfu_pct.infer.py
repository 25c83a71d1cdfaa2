"""Model FLOPs per second over the card's bf16 peak, in %: the forward's
FLOPs of each batch decoded, over the part of the window after the profiler
stopped (batches and host seconds)."""


def read(ctx):
    peak, steps = ctx.get("peak"), ctx.get("untraced_steps")
    if not peak or not steps:
        return None
    return 100.0 * ctx["forward_flops_per_batch"] * steps / (ctx["untraced_s"] * peak)
