"""The serving call's model FLOPs (a full batch, padded slots included) over
its mean host time after the profiler stopped and the card's bf16 peak, in %."""


def read(ctx):
    calls, peak = ctx.get("calls"), ctx.get("peak")
    if not calls or not peak:
        return None
    per_call = sum(t1 - t0 for t0, t1 in calls) / len(calls)
    return 100.0 * ctx["forward_flops_per_batch"] / (per_call * peak)
