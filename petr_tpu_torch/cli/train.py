"""Training CLI (reference `tools/train.py` capability).

    python -m petr_tpu_torch.cli.train --config petr_vov_p4_800x320 \
        --infos data/nuscenes_infos_train.pkl --data-root data/nuscenes \
        --work-dir work_dirs/petr_vov

Counterpart of `petr_tpu/cli/train.py`: config selection, seeding, the
epoch loop with the reference schedule, periodic JSON logging to
``<work-dir>/train_log.jsonl``, checkpoints with rotation under
``<work-dir>/ckpts``, resume, params-only init (``--load-from``),
evaluation every ``--eval-interval`` epochs, and a SIGTERM/SIGINT handler
that checkpoints at the next step boundary and exits 0. It runs on the card
unless ``--device cpu`` is given, and raises when the card is asked for and
absent.

Several processes, one per card (`cli/train.py:94-128, 188-230`):

    python -m petr_tpu_torch.cli.train ... --coordinator host:port \
        --num-processes 2 --process-id 0      # and --process-id 1

Each rank joins the process group (``--dist-backend``: nccl on cards, gloo
on the CPU or for ranks that share a card), reads its stride of each
epoch's shuffled order (``Loader(process_shard=...)``) at the global batch
over the ranks, and steps data-parallel (``parallel.make_pod_mesh``: a rank
owns one card, so the model axis is 1). Every rank starts from rank 0's
state (its ``--load-from`` and ``--resume`` reads, broadcast: ranks on
hosts that share no file system see only their own work directory). Rank
0 alone logs, writes ``train_log.jsonl`` and checkpoints; a signal on any
rank stops every rank at the same step (an all-reduce of the flag each
step); the eval hook runs ``evaluate_model_multiprocess`` on every rank.

A resumed run starts at epoch ``step // steps_per_epoch`` and replays that
epoch from its start, as petr_tpu's does; each step draws its randomness
from the run's seed and its step alone (``train.step_generator``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import time

import torch

def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--infos", required=True, help="train info .pkl")
    p.add_argument("--data-root", default="")
    p.add_argument("--work-dir", default="work_dirs/default")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None, help="global batch size")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--load-from", default=None, help="params-only checkpoint")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--max-steps", type=int, default=None, help="debug cap")
    p.add_argument(
        "--set", nargs="*", default=[], dest="overrides", metavar="KEY=VAL",
        help="dotted config overrides, e.g. model.remat=False train.optim.lr=1e-4",
    )
    p.add_argument(
        "--tensorboard", action="store_true",
        help="mirror scalar metrics to <work-dir>/tb (reference parity: the "
        "mmcv TensorboardLoggerHook, requirements.txt:10)",
    )
    # in-training evaluation (reference mmcv EvalHook: `evaluation =
    # dict(interval=N)`, petr_r50dcn_gridmask_p4.py:262)
    p.add_argument("--eval-infos", default=None, help="val info .pkl; evaluates "
                   "mAP/NDS every --eval-interval epochs")
    p.add_argument("--eval-interval", type=int, default=1, help="epochs between evals")
    p.add_argument("--coordinator", default=None, help="host:port of process 0 (multi-process runs)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="the process group's backend: nccl (default with --device cuda) or gloo "
                        "(the CPU, or ranks that share one card)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def ckpt_meta(cfg):
    """What a checkpoint carries beside the weights: the class names and the
    resolved config (reference `tools/train.py:233-243`)."""
    from petr_tpu_torch.configs.config import NUSCENES_CLASSES

    return {"classes": list(NUSCENES_CLASSES), "config": dataclasses.asdict(cfg)}


def _rounded(rec):
    return {k: round(v, 4) if isinstance(v, float) else v for k, v in rec.items()}


def main(argv=None):
    args = parse_args(argv)
    import torch.distributed as dist

    from petr_tpu_torch.parallel.distributed import init_distributed, make_pod_mesh, rank_device

    backend = args.dist_backend or ("gloo" if torch.device(args.device).type == "cpu" else "nccl")
    if init_distributed(args.coordinator, args.num_processes, args.process_id, backend):
        try:
            _main(args, rank_device(args.device), make_pod_mesh())
        finally:
            dist.destroy_process_group()
    else:
        _main(args, rank_device(args.device), None)


def _main(args, device, mesh):
    """The run on this rank's ``device``; ``mesh`` is None for one process
    without a process group."""
    import torch.distributed as dist

    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.data import Loader, NuScenesDataset
    from petr_tpu_torch.parallel.mesh import replicate_state
    from petr_tpu_torch.train import create_train_state, make_train_step, step_generator
    from petr_tpu_torch.train.checkpoint import latest_checkpoint, load_params, restore_checkpoint, save_checkpoint
    from petr_tpu_torch.train.evaluate import evaluate_model_multiprocess

    n_proc = mesh.data if mesh is not None else 1
    rank = mesh.rank if mesh is not None else 0
    is_main = rank == 0
    cfg = get_config(args.config, args.overrides)
    epochs = args.epochs or cfg.train.optim.epochs

    ds = NuScenesDataset.from_pkl(args.infos, cfg.data, training=True, data_root=args.data_root)
    batch_size = args.batch_size or cfg.train.optim.batch_size_per_device * n_proc
    if batch_size % n_proc:
        raise SystemExit(f"global batch {batch_size} not divisible by {n_proc} processes")
    loader = Loader(ds, batch_size // n_proc, seed=args.seed,
                    process_shard=(rank, n_proc) if n_proc > 1 else None)
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        raise SystemExit(
            f"global batch size {batch_size} exceeds dataset size {len(ds)} "
            f"(pass --batch-size <= {len(ds)})"
        )
    total_steps = steps_per_epoch * epochs
    state = create_train_state(cfg, args.seed, total_steps, device)

    if args.load_from:
        load_params(args.load_from, state.model)
    ckpt_base = os.path.join(args.work_dir, "ckpts")
    if args.resume:
        latest = latest_checkpoint(ckpt_base)
        if latest:
            state = restore_checkpoint(latest, state)
            if is_main:
                print(f"resumed from {latest} at step {state.step}", flush=True)
    if mesh is not None:  # rank 0's weights, AdamW state and step are the run's
        replicate_state(state, mesh)

    # env + resolved-config dump at startup (reference tools/train.py:190-202)
    if is_main:
        env = {
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": str(device),
            "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "devices": n_proc,
            "processes": n_proc,
            "backend": dist.get_backend() if mesh is not None else None,
            "global_batch": batch_size,
            "steps_per_epoch": steps_per_epoch,
        }
        print(json.dumps({"env": env}))
        print(json.dumps({"config": dataclasses.asdict(cfg)}, default=str), flush=True)

    os.makedirs(args.work_dir, exist_ok=True)
    logf = open(os.path.join(args.work_dir, "train_log.jsonl"), "a") if is_main else None
    tb_writer = None
    if args.tensorboard and is_main:
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(os.path.join(args.work_dir, "tb"))
        except ImportError:
            print("tensorboard unavailable; scalar logging stays JSON-only")

    def log_record(rec, step):
        if not is_main:
            return
        print(json.dumps(_rounded(rec)), flush=True)
        logf.write(json.dumps(rec) + "\n")
        logf.flush()
        if tb_writer is not None:
            for k, v in rec.items():
                if k != "step" and isinstance(v, (int, float)):
                    tb_writer.add_scalar(k, v, global_step=step)

    train_step = make_train_step(cfg, mesh)

    def stop_now(flag: bool) -> bool:
        """Whether any rank was signalled: every rank stops at one step."""
        if mesh is None:
            return flag
        t = torch.tensor([float(flag)], device=device)
        dist.all_reduce(t)
        return bool(t.item())

    # Preemption-safe shutdown: a scheduler's maintenance or preemption
    # delivers SIGTERM. The handler only sets a flag; the loop finishes the
    # step in flight, checkpoints and exits 0, so the scheduler restarts
    # with --resume. A second signal falls through to the default handler,
    # so that a stuck save can still be interrupted.
    preempted = []

    def _on_signal(signum, frame):
        preempted.append(signum)
        signal.signal(signum, signal.SIG_DFL)
        print(f"signal {signum} received; checkpointing at step boundary", flush=True)

    kept = {sig: signal.signal(sig, _on_signal) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        start_epoch = state.step // max(steps_per_epoch, 1)
        t_last = time.time()
        for epoch in range(start_epoch, epochs):
            for batch in loader.epoch(epoch):
                batch.pop("tokens", None)
                state, metrics = train_step(state, batch, step_generator(args.seed + 1, state.step))
                step = state.step
                if step % args.log_every == 0:
                    dt = time.time() - t_last
                    t_last = time.time()
                    log_record({"epoch": epoch, "step": step, "time_per_iter": dt / max(args.log_every, 1),
                                **{k: float(v) for k, v in metrics.items()}}, step)
                stop = stop_now(bool(preempted))
                if stop or (args.max_steps and step >= args.max_steps):
                    if is_main:
                        save_checkpoint(ckpt_base, step, state, cfg.train.max_keep_ckpts, meta=ckpt_meta(cfg))
                    if preempted:
                        print(f"checkpoint saved at step {step}; exiting on signal {preempted[0]} "
                              f"(resume with --resume)" if is_main else
                              f"rank {rank}: stopping at step {step} on signal {preempted[0]}", flush=True)
                    elif stop:
                        print(f"rank {rank}: stopping at step {step}: another rank was signalled", flush=True)
                    return
            if is_main:
                save_checkpoint(ckpt_base, state.step, state, cfg.train.max_keep_ckpts, meta=ckpt_meta(cfg))
                print(f"epoch {epoch} done; checkpoint saved", flush=True)
            if args.eval_infos and (epoch + 1) % max(args.eval_interval, 1) == 0:
                val_ds = NuScenesDataset.from_pkl(args.eval_infos, cfg.data, training=False,
                                                  data_root=args.data_root)
                state.model.eval()
                try:
                    results = {f"val/{k}": float(v)
                               for k, v in evaluate_model_multiprocess(cfg, state.model, val_ds).items()}
                finally:
                    state.model.train()
                log_record({"epoch": epoch, "step": state.step, **results}, state.step)
    finally:
        for sig, handler in kept.items():  # as they were, for a caller in the same process
            signal.signal(sig, handler)
        if logf is not None:
            logf.close()
        if tb_writer is not None:
            tb_writer.close()


if __name__ == "__main__":
    main()
