"""One sharded train step on n ranks at tiny shapes.

    python -m petr_tpu_torch.parallel.dryrun 4 [--model-parallel 2] [--device cpu] [--backend nccl]

Counterpart of `__graft_entry__.py::dryrun_multichip` (`:82-146`): the
flagship's architecture family (VoVNet-39 + CPFPN + PETR head, GridMask,
dropout 0.1, bf16) at 64x128 on a (data, model) mesh that exercises both
axes: model 4 when 4 divides n, else 2 when 2 does, else 1 (or the model
axis asked for); one full step
(matcher, loss, AdamW) on a global batch of max(2, data) with each rank on
its rows. Every rank runs on the card (all on one card when there is one,
through Gloo by default) unless ``--device cpu`` is given, and it raises
when the card is asked for and absent. It raises unless every rank's loss
is finite.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from petr_tpu_torch.parallel.distributed import spawn


def dryrun_config():
    """The dryrun's config: `__graft_entry__.py:105-121`."""
    from petr_tpu_torch.configs.config import (
        BackboneConfig,
        DataConfig,
        ExperimentConfig,
        HeadConfig,
        ModelConfig,
        OptimConfig,
        TrainConfig,
    )

    return ExperimentConfig(
        name="dryrun",
        model=ModelConfig(
            backbone=BackboneConfig(kind="vovnet", spec="V-39-eSE", out_indices=(2, 3)),
            head=HeadConfig(num_query=64, embed_dim=64, num_layers=2, num_heads=4, ffn_dim=128,
                            depth_num=8, dropout_rate=0.1),
            use_grid_mask=True,
            compute_dtype="bfloat16",
        ),
        data=DataConfig(image_size=(64, 128), max_gt=8),
        train=TrainConfig(optim=OptimConfig(warmup_iters=2)),
    )


def cams(B: int, N: int) -> np.ndarray:
    """Outward-facing pinhole cameras, (B, N, 4, 4) img2lidar (`__graft_entry__.py:16-33`)."""
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


def random_batch(B: int, N: int, H: int, W: int, G: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """A batch of random images and boxes (`__graft_entry__.py::_batch`)."""
    rng = np.random.RandomState(seed)
    return {
        "images": rng.randn(B, N, H, W, 3).astype(np.float32),
        "img2lidar": cams(B, N),
        "img_hw": np.tile(np.array([H, W], np.float32), (B, N, 1)),
        "gt_boxes": np.concatenate([
            rng.uniform(-40, 40, (B, G, 2)), rng.uniform(-3, 1, (B, G, 1)), rng.uniform(1, 4, (B, G, 3)),
            rng.uniform(-np.pi, np.pi, (B, G, 1)), rng.uniform(-2, 2, (B, G, 2)),
        ], -1).astype(np.float32),
        "gt_labels": rng.randint(0, 10, (B, G)).astype(np.int32),
        "gt_valid": np.ones((B, G), bool),
    }


def model_axis(n: int) -> int:
    return 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)


def dryrun_rank(rank: int, world: int, device: torch.device, model: int) -> Dict:
    from petr_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from petr_tpu_torch.train import create_train_state, make_train_step, step_generator

    if device.type == "cpu":
        torch.set_num_threads(2)
    mesh = make_mesh(world, model=model)
    cfg = dryrun_config()
    H, W = cfg.data.image_size
    batch = random_batch(max(2, mesh.data), 6, H, W, cfg.data.max_gt)
    state = create_train_state(cfg, 0, 100, device)
    replicate(state.model, mesh)
    state, metrics = make_train_step(cfg, mesh)(state, shard_batch(batch, mesh), step_generator(1, 0))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"rank {rank}: loss {loss}")
    return {"mesh": mesh.shape, "loss": loss, "grad_norm": float(metrics["grad_norm"]), "step": state.step}


def dryrun_multichip(n_devices: int, device: str = "cuda", backend: str = "gloo",
                     model: Optional[int] = None) -> Dict:
    """One sharded train step on ``n_devices`` spawned ranks on a mesh with
    a model axis of ``model`` (``model_axis(n_devices)`` by default);
    returns rank 0's record (every rank's loss is the same and finite)."""
    recs = spawn(dryrun_rank, n_devices, backend, device, args=(model or model_axis(n_devices),))
    losses = [r["loss"] for r in recs]
    if len(set(losses)) != 1:
        raise AssertionError(f"the ranks' losses differ: {losses}")
    rec = recs[0]
    print(f"dryrun_multichip({n_devices}) OK: mesh={rec['mesh']} loss={rec['loss']:.4f}", flush=True)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("n", type=int, nargs="?", default=8)
    p.add_argument("--device", default="cuda", help="cuda (default: rank r on card r %% cards) or cpu")
    p.add_argument("--backend", default="gloo", choices=("nccl", "gloo"))
    p.add_argument("--model-parallel", type=int, default=None)
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.backend, args.model_parallel)


if __name__ == "__main__":
    main()
