"""The deformable convs' bound (K4's products and bytes at every DCN conv of
a batch's forward) over their device time per batch, in %. Ranges and
kernel names: the data file."""

from h100_bench import flops


def read(ctx):
    tr, peak, steps = ctx.get("trace"), ctx.get("peak"), ctx.get("trace_steps")
    if tr is None or not peak or not steps:
        return None
    t = tr.device_time(ctx["data"]["ranges"], ctx["data"]["kernels"])
    if t <= 0.0:
        return None
    shapes = flops.dcn_shapes(ctx["spec"]["model"], ctx["batch"] * ctx["views"], ctx["hw"])
    bound = sum(n * flops.dcn_forward(*shape, peak)[0] for n, shape in shapes)
    return 100.0 * bound * steps / t
