"""Train-step throughput at growing rank counts on a (data, model) mesh.

    python -m petr_tpu_torch.cli.scaling --config tiny_debug --devices 1,2 --device cpu
    python -m petr_tpu_torch.cli.scaling --config petr_vov_p4_800x320 --devices 1,2,4,8

Counterpart of `petr_tpu/cli/scaling.py`: for each count n it spawns n
ranks (``parallel.distributed.spawn``) on a mesh with a model axis of
``min(n, --model-parallel or n)`` (petr_tpu's default: the decoder's tokens
split over every rank), steps a global batch of ``--batch-per-device``
times the data axis for ``--warmup`` then ``--steps`` steps, and prints
one JSON record per count: ms per step (rank 0's host clock, the card
synchronised), samples/s, and t(1) / t(n), the weak-scaling efficiency.

The ranks take one card each, ``cuda:{rank % cards}``. On a machine with
fewer cards than ranks they share one (``--dist-backend gloo``: NCCL
refuses two ranks on one card), and then the "efficiency" measures ranks
contending for one card, not scaling; every record says how many cards the
ranks had.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np


def scaling_rank(rank: int, world: int, device, cfg_name: str, overrides, batch_per_device: int,
                 model_parallel, warmup: int, steps: int) -> Dict:
    import torch

    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.parallel.dryrun import random_batch
    from petr_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from petr_tpu_torch.train import create_train_state, make_train_step, step_generator

    if device.type == "cpu":
        torch.set_num_threads(2)
    cfg = get_config(cfg_name, overrides)
    mesh = make_mesh(world, model=min(world, model_parallel or world))
    B = batch_per_device * mesh.data
    H, W = cfg.data.image_size
    batches = [shard_batch(random_batch(B, cfg.data.num_views * cfg.data.num_frames, H, W, cfg.data.max_gt,
                                        seed=s), mesh) for s in range(2)]
    if cfg.data.num_frames > 1:
        for b in batches:
            b["timestamp"] = np.zeros(b["images"].shape[:2], np.float32)
    state = create_train_state(cfg, 0, 1000, device)
    replicate(state.model, mesh)
    step = make_train_step(cfg, mesh)

    def run(n):
        m = None
        for i in range(n):
            _, m = step(state, batches[i % 2], step_generator(1, state.step))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return float(m["loss"])

    run(warmup)
    t0 = time.perf_counter()
    loss = run(steps)
    dt = (time.perf_counter() - t0) / steps
    return {"mesh": list(mesh.shape), "global_batch": B, "ms_per_step": dt * 1e3, "loss": loss}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="tiny_debug")
    p.add_argument("--set", nargs="*", default=[], dest="overrides", metavar="KEY=VAL")
    p.add_argument("--batch-per-device", type=int, default=1)
    p.add_argument("--devices", default="1,2", help="comma-separated rank counts")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--model-parallel", type=int, default=None,
                   help="the model axis (default: every rank, i.e. pure token sharding)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="nccl (default with --device cuda) or gloo (the CPU, or ranks sharing a card)")
    p.add_argument("--out", default=None, metavar="JSON", help="write the records to this file too")
    args = p.parse_args(argv)

    import torch

    from petr_tpu_torch.parallel.distributed import spawn

    cpu = torch.device(args.device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for but torch.cuda.is_available() is False; "
                           "pass --device cpu to run on the CPU")
    backend = args.dist_backend or ("gloo" if cpu else "nccl")
    cards = 0 if cpu else torch.cuda.device_count()
    results, t1 = [], None
    for n in (int(c) for c in args.devices.split(",")):
        recs = spawn(scaling_rank, n, backend, args.device,
                     args=(args.config, args.overrides, args.batch_per_device, args.model_parallel,
                           args.warmup, args.steps))
        rec = recs[0]
        dt = rec["ms_per_step"] / 1e3
        t1 = dt if t1 is None else t1
        rec = {"devices": n, "cards": min(n, cards), "backend": backend, **rec,
               "samples_per_s": rec["global_batch"] / dt, "weak_scaling_efficiency": t1 / dt}
        if n > max(cards, 1) or cpu:
            rec["note"] = "ranks share the host's cores or one card: not a scaling figure"
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"config": args.config, "results": results}, f, indent=1)
    return results


if __name__ == "__main__":
    main()
