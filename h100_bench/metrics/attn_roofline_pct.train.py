"""The decoder cross-attention's bound (K1's forward and K2's backward of
every layer, once each per step) over its device time per step (every
launch inside the op's ranges: remat's second forward counts as time), in %.
Ranges and kernel names: the data file."""

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
    args = (ctx["batch"], hc["num_heads"], hc["num_query"], L, hc["embed_dim"] // hc["num_heads"], peak)
    bound = hc["num_layers"] * (flops.attention_forward(*args)[0] + flops.attention_backward(*args)[0])
    return 100.0 * bound * steps / t
