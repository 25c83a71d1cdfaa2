"""Multi-scene synthetic end-to-end training validation.

    python -m petr_tpu_torch.tools.synth_train_eval --config synth_small --steps 4000 \
        --scenes 84 --val-scenes 6 --no-velocity-hue --floor 0.05 --out-dir /tmp/petr_synth_verify

Counterpart of `tools/synth_train_eval.py`. It renders a procedural
multi-scene dataset (``data.generate_synthetic_scenes``: distinct scenes, 3
colour-coded classes, moving objects), trains a config on the TRAIN scenes
through the loader and the train step, and scores HELD-OUT scenes with the
nuScenes evaluator: the stand-in for the reference's golden-metric protocol
(`tools/dist_test.sh <cfg> <ckpt> --eval bbox` on nuScenes val). It
measures generalisation, not memorisation: the val scenes are never trained
on. It runs on the card unless ``--device cpu`` is given.

Prints a progress line every 100 steps (loss, ``gnorm``, the count of
skipped non-finite steps), and at the end one JSON line {steps,
train_loss_first, train_loss_last, wall_s, val/mAP, val/NDS, ...}. Exits 1
if the held-out mAP (over the 3 classes present) is below ``--floor`` or
its mAVE at or above ``--mave-ceiling``, and 2 when training diverges (a
forensics snapshot of the last healthy state goes to
``<out-dir>/forensics``, for ``petr_tpu_torch.tools.nan_replay``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="synth_small")
    p.add_argument("--steps", type=int, default=12000)
    p.add_argument("--scenes", type=int, default=80)
    p.add_argument("--val-scenes", type=int, default=2)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--objects", type=int, default=6)
    p.add_argument("--image-hw", type=int, nargs=2, default=(128, 320))
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--min-lr-ratio", type=float, default=0.2,
                   help="cosine-schedule floor as a fraction of --lr (the velocity recipe keeps this "
                   "high: petr_tpu's mAVE failure traced to the LR decaying below what cross-frame "
                   "correspondence needs to escape the v=0 local optimum)")
    p.add_argument("--floor", type=float, default=0.15, help="min held-out mAP")
    p.add_argument("--mave-ceiling", type=float, default=None,
                   help="max held-out mAVE (temporal validation: a v2 run must BEAT the single-frame "
                   "floor on motion-only data)")
    p.add_argument("--out-dir", default="/tmp/petr_synth")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=0,
                   help="evaluate held-out every N steps (progress diagnostic)")
    p.add_argument("--eval-train", action="store_true",
                   help="also score the TRAIN scenes (memorisation diagnostic)")
    p.add_argument("--no-aug", action="store_true", help="disable flip/BEV aug (diagnostic)")
    p.add_argument("--no-velocity-hue", action="store_true",
                   help="render WITHOUT the velocity hue cue: inter-frame motion becomes the only "
                   "velocity signal (see data/synthetic.py)")
    p.add_argument("--probe-velocity", action="store_true",
                   help="print TP-matched velocity stats (pred std, corr, error vs the predict-zero "
                   "baseline) at every eval boundary (train/diagnostics.py)")
    p.add_argument("--bn-warmup", type=int, default=0, metavar="N",
                   help="estimate BN running stats from N forward passes before training (precise "
                   "BN; the pretrained-stats regime the reference recipes train in; "
                   "train/bn_warmup.py)")
    p.add_argument("--bn-refresh", action="store_true",
                   help="re-estimate BN stats (--bn-warmup batches) at every eval boundary so the "
                   "frozen stats track the drifting weights")
    p.add_argument("--save-ckpt", default=None, metavar="DIR",
                   help="save the final state as a checkpoint under DIR (train.checkpoint), and one "
                   "at every --eval-every boundary")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint under --save-ckpt (weights, AdamW state, "
                   "step), so a cut run continues instead of restarting")
    p.add_argument("--set", nargs="*", default=[], dest="overrides", metavar="KEY=VAL",
                   help="dotted config overrides")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def recipe_config(name: str, image_hw=(128, 320), lr: float = 2e-4, min_lr_ratio: float = 0.2,
                  overrides=(), no_aug: bool = False):
    """The config the harness trains: preset ``name`` with its overrides,
    the images at ``image_hw`` uncropped and unscaled, 32 GT boxes at most,
    50 warm-up iterations of the given LR and cosine floor, and the
    backbone at the head's LR (flip and BEV augmentation off with
    ``no_aug``)."""
    from petr_tpu_torch.configs import get_config

    H, W = image_hw
    cfg = get_config(name, overrides)
    dcfg = dataclasses.replace(
        cfg.data, image_size=(H, W), final_dim=(H, W), resize_lim=(1.0, 1.0),
        bot_pct_lim=(0.0, 0.0), max_gt=32,
        **(dict(rand_flip=False, bev_rot_range=(0.0, 0.0),
                bev_scale_range=(1.0, 1.0)) if no_aug else {}),
    )
    ocfg = dataclasses.replace(
        cfg.train.optim, lr=lr, warmup_iters=50,
        min_lr_ratio=min_lr_ratio, backbone_lr_mult=1.0,
    )
    return dataclasses.replace(cfg, data=dcfg, train=dataclasses.replace(cfg.train, optim=ocfg))


def main(argv=None):
    args = parse_args(argv)

    from petr_tpu_torch.data import Loader, NuScenesDataset, generate_synthetic_scenes
    from petr_tpu_torch.data.synthetic import SYNTH_CLASSES
    from petr_tpu_torch.serve import resolve_device
    from petr_tpu_torch.train import create_train_state, make_train_step, step_generator
    from petr_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
    from petr_tpu_torch.train.evaluate import evaluate_model
    from petr_tpu_torch.train.forensics import host_copy, save_snapshot

    device = resolve_device(args.device)
    H, W = args.image_hw
    t0 = time.time()
    splits = generate_synthetic_scenes(
        args.out_dir, n_scenes=args.scenes, frames_per_scene=args.frames,
        image_hw=(H, W), n_objects=args.objects, seed=args.seed,
        val_scenes=args.val_scenes, velocity_hue=not args.no_velocity_hue,
    )
    print(f"generated {len(splits['train'])} train / {len(splits['val'])} val "
          f"frames in {time.time() - t0:.1f}s", flush=True)

    cfg = recipe_config(args.config, (H, W), args.lr, args.min_lr_ratio, args.overrides, args.no_aug)
    train_ds = NuScenesDataset(splits["train"], cfg.data, training=True, src_hw=(H, W))
    val_ds = NuScenesDataset(splits["val"], cfg.data, training=False, src_hw=(H, W))
    loader = Loader(train_ds, args.batch_size, seed=args.seed)

    state = create_train_state(cfg, args.seed, args.steps, device)
    step_fn = make_train_step(cfg)

    def loader_batches(n):
        """The first n train batches (for BN estimation)."""
        out = []
        for batch in loader.epoch(0):
            batch.pop("tokens")
            out.append(batch)
            if len(out) >= n:
                break
        return out

    def evaluate(ds):
        """mAP, NDS and the TP errors over ``ds``, the model in eval mode for it."""
        state.model.eval()
        try:
            return evaluate_model(cfg, state.model, ds, batch_size=args.batch_size, classes=SYNTH_CLASSES)
        finally:
            state.model.train()

    vel_probe = None
    if args.probe_velocity:
        from petr_tpu_torch.train.diagnostics import make_velocity_probe

        vel_probe = make_velocity_probe(cfg, val_ds, batch_size=args.batch_size)

    first = last = None
    step = 0
    if args.resume and args.save_ckpt:
        ck = latest_checkpoint(args.save_ckpt)
        if ck is not None:
            state = restore_checkpoint(ck, state)
            step = state.step
            print(f"resumed from {ck} at step {step}", flush=True)
    if args.bn_warmup and step == 0:
        # fresh start only: a resumed run's statistics are in the checkpoint
        from petr_tpu_torch.train.bn_warmup import estimate_bn_stats

        t1 = time.time()
        estimate_bn_stats(cfg, state.model, loader_batches(args.bn_warmup))
        print(f"bn-warmup: estimated BN stats from {args.bn_warmup} "
              f"batches in {time.time() - t1:.1f}s", flush=True)
    skips = 0
    snap = None  # (step, host copy of the state) from the last healthy boundary
    t0 = time.time()
    while step < args.steps:
        epoch = step // max(len(loader), 1)
        for batch in loader.epoch(epoch):
            batch.pop("tokens")
            state, metrics = step_fn(state, batch, step_generator(args.seed + 1, state.step))
            step += 1
            skips += metrics["skipped"]
            if step % 100 == 0 or step == 1:
                last = float(metrics["loss"])
                if first is None:
                    first = last
                gn = float(metrics["grad_norm"])
                nf = metrics["grad_nonfinite"]
                print(f"step {step:5d}  loss {last:.4f}  gnorm {gn:9.2f}  "
                      f"({step / max(time.time() - t0, 1e-9):.2f} it/s)"
                      + (f"  NONFINITE->SKIPPED (total {skips})" if nf else ""),
                      flush=True)
                # non-finite steps are skipped (mmcv fp16-hook parity), so a
                # spike is survivable; abort only when the weights are already
                # dead (loss 0 for good: the losses are nan_to_num'd) or the
                # run skips so often that it cannot be learning
                if not (last > 0.0) or skips > 20 + step // 10:
                    print(f"ABORT: training diverged at step {step} "
                          f"(loss={last}, nonfinite_grads={nf}, skips={skips})",
                          flush=True)
                    if snap is not None:
                        path = save_snapshot(
                            f"{args.out_dir}/forensics", snap[1], snap[0], cfg,
                            loader_args=dict(batch_size=args.batch_size,
                                             seed=args.seed, steps=args.steps),
                        )
                        print(f"forensics: last healthy state (step {snap[0]}) "
                              f"-> {path}; replay with python -m petr_tpu_torch.tools.nan_replay",
                              flush=True)
                    sys.exit(2)
                # healthy boundary: snapshot AFTER the check
                snap = (step, host_copy(state))
            if args.eval_every and step % args.eval_every == 0 and step < args.steps:
                r = evaluate(val_ds)
                print(json.dumps({"step": step, "val/mAP": round(r["mAP"], 4),
                                  "val/NDS": round(r["NDS"], 4),
                                  "val/mAVE": round(r.get("mAVE", float("nan")), 4),
                                  "val/mATE": round(r["mATE"], 4)}), flush=True)
                if vel_probe is not None:
                    state.model.eval()
                    try:
                        vel = vel_probe(state.model)
                    finally:
                        state.model.train()
                    print(json.dumps({"step": step, **{f"vel/{k}": round(v, 4) for k, v in vel.items()}}),
                          flush=True)
                if args.bn_refresh and args.bn_warmup:
                    from petr_tpu_torch.train.bn_warmup import estimate_bn_stats

                    estimate_bn_stats(cfg, state.model, loader_batches(args.bn_warmup))
                    print(f"bn-refresh: re-estimated BN stats at step {step}", flush=True)
                if args.save_ckpt:
                    # periodic save so a cut run keeps its progress
                    save_checkpoint(args.save_ckpt, step, state, meta={"config": args.config})
                    print(f"checkpointed at step {step}", flush=True)
            if step >= args.steps:
                break
    last = float(metrics["loss"])

    results = evaluate(val_ds)
    if args.eval_train:
        train_eval_ds = NuScenesDataset(splits["train"], cfg.data, training=False, src_hw=(H, W))
        tr = evaluate(train_eval_ds)
        print(json.dumps({f"train/{k}": round(float(v), 4) for k, v in sorted(tr.items())}), flush=True)
    if args.save_ckpt:
        path = save_checkpoint(args.save_ckpt, state.step, state, meta={"config": args.config})
        print(f"saved checkpoint: {path}", flush=True)

    rec = {"steps": args.steps, "train_loss_first": round(first, 3),
           "train_loss_last": round(last, 3),
           "wall_s": round(time.time() - t0, 1),
           **{f"val/{k}": round(float(v), 4) for k, v in sorted(results.items())}}
    print(json.dumps(rec), flush=True)
    if results["mAP"] < args.floor:
        print(f"FAIL: held-out mAP {results['mAP']:.3f} < floor {args.floor}")
        sys.exit(1)
    if args.mave_ceiling is not None and results["mAVE"] >= args.mave_ceiling:
        print(f"FAIL: held-out mAVE {results['mAVE']:.3f} >= ceiling "
              f"{args.mave_ceiling}")
        sys.exit(1)
    print(f"SYNTH TRAIN/EVAL OK: held-out mAP {results['mAP']:.3f} "
          f">= {args.floor}"
          + (f", mAVE {results['mAVE']:.3f} < {args.mave_ceiling}"
             if args.mave_ceiling is not None else ""))


if __name__ == "__main__":
    main()
