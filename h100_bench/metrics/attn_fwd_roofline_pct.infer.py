"""The decoder cross-attention's forward bound (K1 at every decoder layer of
a batch's forward) over its device time per batch, in %. Ranges and kernel
names: the data file."""

from h100_bench import flops


def read(ctx):
    tr, peak, steps = ctx.get("trace"), ctx.get("peak"), ctx.get("trace_steps")
    if tr is None or not peak or not steps:
        return None
    t = tr.device_time(ctx["data"]["ranges"], ctx["data"]["kernels"])
    if t <= 0.0:
        return None
    m = ctx["spec"]["model"]
    hc = m["head"]
    H, W = ctx["hw"]
    stride = 4 * 2 ** m["backbone"]["out_indices"][m["head_feat_level"]]
    L = ctx["views"] * (H // stride) * (W // stride)
    bound = hc["num_layers"] * flops.attention_forward(ctx["batch"], hc["num_heads"], hc["num_query"], L,
                                                       hc["embed_dim"] // hc["num_heads"], peak)[0]
    return 100.0 * bound * steps / t
