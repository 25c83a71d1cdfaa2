"""Evaluation CLI (reference `tools/test.py` capability).

    python -m petr_tpu_torch.cli.test --config petr_vov_p4_800x320 \
        --infos data/nuscenes_infos_val.pkl --data-root data/nuscenes \
        --ckpt work_dirs/petr_vov/ckpts/step_00001234 [--out results.json]

Counterpart of `petr_tpu/cli/test.py`: NMS-free decoding over the val
split, nuScenes mAP/NDS from the built-in evaluator, and optionally a
results json (nuScenes submission schema) for the official devkit. It runs
on the card unless ``--device cpu`` is given, and raises when the card is
asked for and absent. Without ``--ckpt`` the weights are random, drawn
from seed 0. ``--tta``, ``--quant-scales`` and ``--fuse-conv-bn`` are not
ported yet (ROADMAP.md §1, item 11): anything but their defaults raises.
"""

from __future__ import annotations

import argparse
import json
import time

from petr_tpu_torch.configs import get_config
from petr_tpu_torch.data import Loader, NuScenesDataset
from petr_tpu_torch.metrics.nuscenes import boxes_from_arrays, evaluate_detections, ground_truth_from_infos
from petr_tpu_torch.metrics.submission import build_submission
from petr_tpu_torch.serve import StreamingPETRv2, build_detector, resolve_device
from petr_tpu_torch.train import make_eval_step
from petr_tpu_torch.train.checkpoint import load_params

UNPORTED = "ROADMAP.md §1, item 11"


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--infos", required=True)
    p.add_argument("--data-root", default="")
    p.add_argument("--ckpt", default=None, help="a checkpoint directory of train.checkpoint.save_checkpoint")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--out", default=None, help="dump detections json")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument(
        "--fuse-conv-bn", action="store_true",
        help="fold frozen BN into conv kernels before inference "
        f"(reference tools/test.py --fuse-conv-bn); not ported yet: {UNPORTED}",
    )
    p.add_argument(
        "--set", nargs="*", default=[], dest="overrides", metavar="KEY=VAL",
        help="dotted config overrides, e.g. max_det=500 model.use_flash_attention=False",
    )
    p.add_argument(
        "--quant-scales", default=None, metavar="NPZ",
        help=f"int8 PTQ serving: activation-scale .npz; not ported yet: {UNPORTED}",
    )
    p.add_argument(
        "--tta", default="none", choices=("none", "identity", "hflip"),
        help="test-time augmentation (reference MultiScaleFlipAug3D + "
        f"petr3d.aug_test feature averaging, petr3d.py:239-247); not ported yet: {UNPORTED}",
    )
    p.add_argument(
        "--classes", default=None, metavar="A,B,...",
        help="restrict metric scoring to these classes (devkit semantics "
        "score ALL classes, counting no-GT classes as AP 0 — pass the "
        "present subset on restricted synthetic data)",
    )
    p.add_argument(
        "--streaming", action="store_true",
        help="PETRv2 streaming eval: scene-ordered, backbone on the 6 new "
        "views per frame, previous-frame features cached "
        "(petr_tpu_torch.serve.StreamingPETRv2). The previous frame is the actual "
        "previous keyframe instead of the offline mid-sweep pick.",
    )
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Raise for each option whose machinery the port lacks, rather than
    evaluate without it."""
    for flag, on in (("--tta", args.tta != "none"), ("--quant-scales", args.quant_scales is not None),
                     ("--fuse-conv-bn", args.fuse_conv_bn)):
        if on:
            raise NotImplementedError(f"{flag} is not ported yet: {UNPORTED}")


def run_streaming_inference(cfg, model, ds, device="cuda"):
    """Scene-ordered streaming inference over the val infos.

    Uses each sample's own ego-aligned sweep record for the previous
    keyframe's matrices (`NuScenesDataset.streaming_sample`); the feature
    cache resets at scene boundaries (detected by sweep-path mismatch).
    Returns (preds by token, frames, wall seconds).
    """
    if cfg.data.num_frames < 2:
        raise SystemExit("--streaming needs a 2-frame (petrv2) config")
    order = list(range(len(ds.infos)))
    if ds.infos and "scene_token" in ds.infos[0]:
        order.sort(key=lambda i: (
            str(ds.infos[i]["scene_token"]), float(ds.infos[i]["timestamp"])))
    runner = StreamingPETRv2(cfg, model, decode=True, device=device)
    preds = {}
    prev_info = None
    t0 = time.time()
    n_cached = 0
    for i in order:
        smp = ds.streaming_sample(i, prev_info)
        if not smp["cached"]:
            runner.reset()
            if smp.get("prev_images") is not None:
                # scene start with a stored sweep: prime the cache with the
                # sweep's views so the frame matches the full 12-view eval
                runner.prime(smp["prev_images"][None])
        else:
            n_cached += 1
        det = runner.step(
            smp["images"][None], smp["img2lidar"][None],
            smp["img_hw"][None], smp["timestamp"][None],
        )
        det = {k: v.cpu().numpy() for k, v in det.items()}
        preds[smp["token"]] = boxes_from_arrays(
            smp["token"], det["boxes"][0], det["scores"][0],
            det["labels"][0], det["valid"][0], info=ds.infos[i],
        )
        prev_info = ds.infos[i]
    wall = time.time() - t0
    print(f"streaming: {n_cached}/{len(order)} frames served from the feature cache")
    return preds, len(order), wall


def main(argv=None):
    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    cfg = get_config(args.config, args.overrides)
    ds = NuScenesDataset.from_pkl(
        args.infos, cfg.data, training=False, data_root=args.data_root
    )
    if args.max_samples:
        ds.infos = ds.infos[: args.max_samples]
    model = build_detector(cfg, seed=0, device=device)
    if args.ckpt:
        load_params(args.ckpt, model)

    preds = {}
    if args.streaming:
        preds, n, wall = run_streaming_inference(cfg, model, ds, device=device)
    else:
        loader = Loader(ds, args.batch_size, shuffle=False, drop_last=False)
        eval_step = make_eval_step(cfg)
        t0 = time.time()
        n = 0
        info_by_token = {info["token"]: info for info in ds.infos}
        for batch in loader.epoch(0):
            tokens = batch.pop("tokens")
            det = {k: v.cpu().numpy() for k, v in eval_step(model, batch).items()}
            for i, tok in enumerate(tokens):
                preds[tok] = boxes_from_arrays(
                    tok, det["boxes"][i], det["scores"][i], det["labels"][i],
                    det["valid"][i], info=info_by_token.get(tok),
                )
            n += len(tokens)
        wall = time.time() - t0
    print(f"inference: {n} samples in {wall:.3f}s ({n / wall:.3f} samples/s)")

    gts = ground_truth_from_infos(ds.infos)
    if args.classes:
        results = evaluate_detections(gts, preds, classes=tuple(args.classes.split(",")))
    else:
        results = evaluate_detections(gts, preds)
    for k, v in sorted(results.items()):
        print(f"{k}: {v:.4f}")

    if args.out:
        # official submission schema: GLOBAL-frame boxes (upstream mmdet3d
        # lidar_nusc_box_to_global; see metrics/submission.py)
        sub = build_submission(preds, ds.infos)
        with open(args.out, "w") as f:
            json.dump(sub, f)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
