"""Throughput benchmark CLI (reference `tools/analysis_tools/benchmark.py`).

    python -m petr_tpu_torch.cli.benchmark --config petr_vov_p4_800x320 [--train] \
        [--quant-scales scales.npz] [--device cuda]

Counterpart of `petr_tpu/cli/benchmark.py`, with its flags and its JSON
line, plus ``--device`` (the card unless ``--device cpu``) and the card's
name and power limit under ``device``. Random weights from seed 0, 4
distinct batches (`__graft_entry__._batch`'s draw: ``benchmark_batch``),
``--warmup`` iterations (5) and then ``--iters`` timed ones between two
``torch.cuda.synchronize()``, each reading a host scalar (the summed class
logits, or the step's loss). One sample is ``num_views`` images
(``num_frames`` times that for PETRv2). ``--train`` times the full training
step; ``--quant-scales`` serves the int8 backbone (K6) with the scales of
``cli.quantize``. The FLOPs behind ``mfu_pct`` are ``utils.mfu.count_flops``
of one iteration after the timed loop.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from petr_tpu_torch.cli.quantize import synthetic_cams
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.serve import build_detector, resolve_device
from petr_tpu_torch.utils.mfu import count_flops, device_name, mfu_fields


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="petr_vov_p4_800x320")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--train", action="store_true")
    p.add_argument(
        "--set", nargs="*", default=[], dest="overrides", metavar="KEY=VAL",
        help="dotted config overrides, e.g. model.remat=False",
    )
    p.add_argument(
        "--quant-scales", default=None, metavar="NPZ",
        help="int8 PTQ: activation-scale .npz from petr_tpu_torch.cli.quantize "
        "(the int8 backbone; inference mode only)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def benchmark_batch(cfg, batch_size: int, seed: int):
    """`__graft_entry__._batch(B, N, H, W, max_gt, with_ts, seed)`: standard
    normal images, ``synthetic_cams``, full-size ``img_hw``, ``max_gt`` GT
    boxes drawn from the same ``RandomState(seed)`` after the images (all
    valid), zero timestamps for a 2-frame config and, for the Depthr head
    (which reads the GT at test time too), ``lidar2img``."""
    B, G = batch_size, cfg.data.max_gt
    N = cfg.data.num_views * cfg.data.num_frames
    H, W = cfg.data.image_size
    rng = np.random.RandomState(seed)
    batch = {
        "images": rng.randn(B, N, H, W, 3).astype(np.float32),
        "img2lidar": synthetic_cams(B, N),
        "img_hw": np.full((B, N, 2), [H, W], np.float32),
        "gt_boxes": np.concatenate([
            rng.uniform(-40, 40, (B, G, 2)),
            rng.uniform(-3, 1, (B, G, 1)),
            rng.uniform(1, 4, (B, G, 3)),
            rng.uniform(-np.pi, np.pi, (B, G, 1)),
            rng.uniform(-2, 2, (B, G, 2)),
        ], -1).astype(np.float32),
        "gt_labels": rng.randint(0, 10, (B, G)).astype(np.int32),
        "gt_valid": np.ones((B, G), bool),
    }
    if cfg.data.num_frames > 1:
        batch["timestamp"] = np.zeros((B, N), np.float32)
    if cfg.model.head.kind == "depthr":
        batch["lidar2img"] = np.linalg.inv(batch["img2lidar"].astype(np.float64)).astype(np.float32)
    return batch


def forward_inputs(cfg, batch, device):
    """The detector's (args, kwargs) for ``batch`` on ``device``: images,
    img2lidar, img_hw, the timestamps of a 2-frame config and the Depthr
    head's GT boxes and cameras."""
    t = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    kwargs = {"timestamp": t.get("timestamp")}
    if cfg.model.head.kind == "depthr":
        kwargs.update(gt_boxes=t["gt_boxes"], gt_valid=t["gt_valid"], lidar2img=t["lidar2img"])
    return (t["images"], t["img2lidar"], t["img_hw"]), kwargs


def _train_run(cfg, batches, device):
    from petr_tpu_torch.train import create_train_state, make_train_step, step_generator

    state = create_train_state(cfg, 0, 1000, device)
    step = make_train_step(cfg)

    def run(i=0):
        _, metrics = step(state, batches[i % len(batches)], step_generator(1, i))
        return float(metrics["loss"])

    return run


def _inference_run(cfg, batches, device, quant_scales):
    from petr_tpu_torch.quant import apply_scales, load_scales

    model = build_detector(cfg, seed=0, device=device)
    if quant_scales:
        apply_scales(model, load_scales(quant_scales))
    on_device = [forward_inputs(cfg, b, device) for b in batches]

    def run(i=0):
        args, kwargs = on_device[i % len(on_device)]
        with torch.inference_mode():
            return float(model(*args, **kwargs)["cls_logits"].sum())

    return run


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parse_args(argv)
    if args.train and args.quant_scales:
        raise SystemExit("--quant-scales is inference mode only")
    device = resolve_device(args.device)
    cfg = get_config(args.config, args.overrides)
    B = args.batch_size
    # distinct batches: identical inputs could let a cache or the runtime
    # hide work and undercount wall time
    batches = [benchmark_batch(cfg, B, seed=s) for s in range(4)]
    if args.train:
        run = _train_run(cfg, batches, device)
    else:
        run = _inference_run(cfg, batches, device, args.quant_scales)

    for i in range(args.warmup):
        run(i)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(args.iters):
        run(i)
    _sync(device)
    dt = time.perf_counter() - t0
    mode = "train" if args.train else "inference"

    flops = count_flops(run, args.iters)
    fps = args.iters * B / dt
    result = {
        "metric": f"{args.config}_{mode}",
        "value": round(fps, 3),
        "unit": "samples/s",
        "ms_per_iter": round(1000 * dt / args.iters, 2),
        **mfu_fields(flops / B if flops else None, fps, device),
        "device": device_name(device),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
