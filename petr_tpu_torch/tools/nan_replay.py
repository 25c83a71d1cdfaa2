"""Replay a divergence from a forensics snapshot and name the culprit.

    python -m petr_tpu_torch.tools.nan_replay \
        --snapshot /tmp/.../forensics/healthy_step_*.pkl --out-dir /tmp/... [--max-steps 300]

Counterpart of `tools/nan_replay.py`. It restores the last healthy state
(weights, AdamW state, step) that ``petr_tpu_torch.tools.synth_train_eval``
saved, rebuilds the loader at that position, and re-runs the steps one at a
time watching ``grad_nonfinite``; each step draws its randomness from the
run's seed and its step (``train.step_generator``), as the run did. At the
first bad step it reports the non-finite gradient entries per top-level
module, the loss components, and the modules whose FORWARD output on that
batch is already non-finite, first to finish first (forward hooks); then
it saves the batch and the pre-step weights to ``<snapshot dir>/bad_step.pkl``.
A step with non-finite gradients is skipped, so the model still holds the
pre-step weights when it is dissected. Runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import pickle


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--snapshot", required=True)
    p.add_argument("--out-dir", required=True,
                   help="the diverged run's --out-dir (the dataset's info .pkl lives there)")
    p.add_argument("--max-steps", type=int, default=300)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from petr_tpu_torch.data import Loader, NuScenesDataset
    from petr_tpu_torch.models.detector import draw_train_noise
    from petr_tpu_torch.serve import resolve_device
    from petr_tpu_torch.train import batch_keys, create_train_state, make_grad_fn, make_train_step, step_generator
    from petr_tpu_torch.train.forensics import first_nonfinite_intermediates, load_snapshot, nonfinite_by_subtree
    from petr_tpu_torch.train.train_step import _to_device

    device = resolve_device(args.device)
    snap = load_snapshot(args.snapshot)
    cfg, step0 = snap["cfg"], snap["step"]
    la = snap["loader_args"]
    bs, seed = la["batch_size"], la["seed"]
    H, W = cfg.data.image_size

    ds = NuScenesDataset.from_pkl(
        os.path.join(args.out_dir, "synth_infos_train.pkl"), cfg.data,
        training=True, src_hw=(H, W),
    )
    loader = Loader(ds, bs, seed=seed)
    state = create_train_state(cfg, seed, la.get("steps", 1000), device)
    state.model.load_state_dict(snap["model"])
    state.optimizer.load_state_dict(snap["optimizer"])
    state.step = step0
    step_fn = make_train_step(cfg)

    n_per_epoch = len(loader)
    step = step0
    print(f"replaying from healthy step {step0} "
          f"(epoch {step0 // n_per_epoch}, offset {step0 % n_per_epoch})", flush=True)

    def batches():
        e = step0 // n_per_epoch
        skip = step0 % n_per_epoch
        while True:
            for i, b in enumerate(loader.epoch(e)):
                if i < skip:
                    continue
                b.pop("tokens")
                yield b
            e += 1
            skip = 0

    for batch in batches():
        pre_step = state.step
        state, metrics = step_fn(state, batch, step_generator(seed + 1, pre_step))
        nf = metrics["grad_nonfinite"]
        step += 1
        if nf:
            print(f"FIRST BAD STEP: {step} (grad_nonfinite={nf}, "
                  f"loss={float(metrics['loss'])})", flush=True)
            # 1. per-module gradient damage (the skipped step left the weights as they were)
            total, losses, grads, _, _ = make_grad_fn(cfg)(state.model, batch, step_generator(seed + 1, pre_step))
            print("loss at bad step (recomputed):", float(total), flush=True)
            print("nonfinite grads by subtree:", nonfinite_by_subtree(grads), flush=True)
            print("loss components:", {k: float(v) for k, v in losses.items()}, flush=True)
            # 2. forward dissection (training mode: dropout and GridMask as the step drew them)
            b = _to_device(batch, batch_keys(cfg), device)
            noise = draw_train_noise(cfg.model, b["images"].shape[2], step_generator(seed + 1, pre_step),
                                     b["images"].shape[0])
            oracle = {}
            if cfg.model.head.kind == "depthr":
                oracle = dict(gt_boxes=b["gt_boxes"], gt_valid=b["gt_valid"], lidar2img=b["lidar2img"])
            _, bad = first_nonfinite_intermediates(
                state.model, b["images"], b["img2lidar"], b["img_hw"], noise=noise,
                timestamp=b.get("timestamp"), **oracle,
            )
            if bad:
                print("nonfinite FORWARD activations (module, n, size), first to finish first:", flush=True)
                for path, n, size in bad[:40]:
                    print(f"  {path}: {n}/{size}", flush=True)
            else:
                print("forward is finite -> NaN born in the BACKWARD pass", flush=True)
            # 3. save the evidence
            out = os.path.join(os.path.dirname(args.snapshot), "bad_step.pkl")
            with open(out, "wb") as f:
                pickle.dump({"batch": batch, "step": pre_step,
                             "model": {k: v.cpu() for k, v in state.model.state_dict().items()}}, f)
            print(f"saved bad batch + pre-step weights -> {out}", flush=True)
            return step
        if step % 20 == 0:
            print(f"  step {step}: loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f}", flush=True)
        if step - step0 >= args.max_steps:
            print(f"no divergence within {args.max_steps} replay steps "
                  "(nondeterministic trigger?); rerun with more", flush=True)
            return None


if __name__ == "__main__":
    main()
