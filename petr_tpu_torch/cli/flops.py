"""Model complexity report (reference `tools/analysis_tools/get_flops.py`).

    python -m petr_tpu_torch.cli.flops --config petr_vov_p4_800x320 [--device cuda]

Counterpart of `petr_tpu/cli/flops.py`: the parameter count and the FLOPs
of one B=1 forward, as one JSON line. ``params_m`` counts every parameter
and frozen-BN statistic once (a shared branch once), as petr_tpu counts the
leaves of its ``params`` tree; ``forward_gflops`` is ``utils.mfu.
count_flops`` of the eval-mode forward on ``benchmark_batch``'s inputs. XLA's
memory analysis has no eager counterpart: on the card the line reports the
forward's peak allocation (``torch.cuda.max_memory_allocated``) instead, on
the CPU nothing. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import torch

from petr_tpu_torch.cli.benchmark import benchmark_batch, forward_inputs
from petr_tpu_torch.configs import eval_model_config, get_config
from petr_tpu_torch.models import PETRDetector
from petr_tpu_torch.serve import build_detector, resolve_device
from petr_tpu_torch.utils.mfu import count_flops


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="petr_vov_p4_800x320")
    p.add_argument(
        "--set", nargs="*", default=[], dest="overrides", metavar="KEY=VAL",
        help="dotted config overrides",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def param_count(cfg) -> int:
    """Parameters and BN statistics of ``cfg``'s detector, each tensor once:
    the model is built on the meta device, so no weight is allocated."""
    with torch.device("meta"):
        model = PETRDetector(eval_model_config(cfg.model))
    seen = {}
    for t in model.state_dict(keep_vars=True).values():
        seen[id(t)] = t.numel()
    return sum(seen.values())


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.config, args.overrides)
    N = cfg.data.num_views * cfg.data.num_frames
    H, W = cfg.data.image_size
    inputs, kwargs = forward_inputs(cfg, benchmark_batch(cfg, 1, seed=0), device)
    model = build_detector(cfg, seed=0, device=device)

    def forward():
        with torch.inference_mode():
            return model(*inputs, **kwargs)

    mem = {}
    if device.type == "cuda":
        forward()  # the first call builds the kernels and picks cuDNN's algorithms
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        forward()
        torch.cuda.synchronize(device)
        mem["peak_memory_mb"] = round(torch.cuda.max_memory_allocated(device) / 1e6, 1)
    flops = count_flops(forward)
    result = {
        "config": args.config,
        "params_m": round(param_count(cfg) / 1e6, 2),
        "forward_gflops": round(flops / 1e9, 1) if flops else None,
        "input": f"{N}x{H}x{W}",
        **mem,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
