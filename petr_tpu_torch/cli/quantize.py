"""Calibrate int8 PTQ activation scales for a trained model.

    python -m petr_tpu_torch.cli.quantize --config petr_vov_p4_800x320 \
        --infos data/nuscenes_infos_val.pkl --data-root data/nuscenes \
        --ckpt work_dirs/petr_vov/ckpts/step_N --out scales.npz \
        [--num-batches 32] [--device cuda]

Counterpart of `petr_tpu/cli/quantize.py`: runs calibration batches through
the model recording each quantised conv's input range, then writes the
scale file read by ``cli.test --quant-scales`` and ``cli.export
--quant-scales``, in petr_tpu's ``.npz`` keys (either package reads it).
``--synthetic`` calibrates on random inputs (smoke tests and benchmarking
only; real deployments calibrate on real frames). Runs on the card unless
``--device cpu``; without ``--ckpt`` the weights are random, from seed 0.
"""

from __future__ import annotations

import argparse

import numpy as np

from petr_tpu_torch.configs import get_config
from petr_tpu_torch.quant import calibrate_detector, save_scales
from petr_tpu_torch.serve import build_detector, resolve_device
from petr_tpu_torch.train.checkpoint import load_params


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--infos", default=None)
    p.add_argument("--data-root", default="")
    p.add_argument("--ckpt", default=None, help="a checkpoint directory of train.checkpoint.save_checkpoint")
    p.add_argument("--out", required=True)
    p.add_argument("--num-batches", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--synthetic", action="store_true", help="calibrate on random inputs (no dataset needed)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", nargs="*", default=[], dest="overrides", metavar="KEY=VAL")
    return p.parse_args(argv)


def synthetic_cams(B: int, N: int) -> np.ndarray:
    """img2lidar (B, N, 4, 4) of N outward-facing pinhole cameras."""
    mats = np.zeros((B, N, 4, 4), np.float64)
    for b in range(B):
        for i in range(N):
            yaw = 2 * np.pi * i / max(N, 1)
            R = np.array([[-np.sin(yaw), np.cos(yaw), 0], [0, 0, -1], [np.cos(yaw), np.sin(yaw), 0]])
            E = np.eye(4)
            E[:3, :3] = R
            E[:3, 3] = -R @ np.array([np.cos(yaw), np.sin(yaw), 1.5])
            K = np.eye(4)
            K[0, 0] = K[1, 1] = 400.0
            K[0, 2], K[1, 2] = 400.0, 160.0
            mats[b, i] = K @ E
    return np.linalg.inv(mats).astype(np.float32)


def synthetic_batch(cfg, batch_size: int, seed: int):
    """A serving batch of standard-normal images (``np.random.RandomState(seed)``),
    the cameras of ``synthetic_cams``, full-size ``img_hw`` and, for a
    2-frame config, zero timestamps: the inputs petr_tpu's ``--synthetic``
    calibrates on."""
    N = cfg.data.num_views * cfg.data.num_frames
    H, W = cfg.data.image_size
    rng = np.random.RandomState(seed)
    batch = {
        "images": rng.randn(batch_size, N, H, W, 3).astype(np.float32),
        "img2lidar": synthetic_cams(batch_size, N),
        "img_hw": np.full((batch_size, N, 2), [H, W], np.float32),
    }
    if cfg.data.num_frames > 1:
        batch["timestamp"] = np.zeros((batch_size, N), np.float32)
    return batch


def _leaves(tree) -> int:
    return sum(_leaves(v) if isinstance(v, dict) else 1 for v in tree.values())


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.config, args.overrides)
    if args.synthetic or not args.infos:
        batches = [synthetic_batch(cfg, args.batch_size, s) for s in range(min(args.num_batches, 8))]
    else:
        from petr_tpu_torch.data import Loader, NuScenesDataset

        ds = NuScenesDataset.from_pkl(args.infos, cfg.data, training=False, data_root=args.data_root)
        loader = Loader(ds, args.batch_size, shuffle=False, drop_last=False)
        batches = []
        for batch in loader.epoch(0):
            batch.pop("tokens", None)
            batches.append(batch)
            if len(batches) >= args.num_batches:
                break
    model = build_detector(cfg, seed=0, device=device)
    if args.ckpt:
        load_params(args.ckpt, model)
    scales = calibrate_detector(cfg, model, batches)
    save_scales(args.out, scales)
    print(f"calibrated {_leaves(scales)} activation scales over {len(batches)} batches -> {args.out}")
    return scales


if __name__ == "__main__":
    main()
