"""Rank functions for ``parallel.distributed.spawn`` in the parallel tests:
sharded attention, a sharded train step, the multi-process evaluation and
the agreement of a resumed state, each on inputs made from a seed with
numpy, returning numpy results to the launcher.

A spawned rank imports this module by name, so it imports the port and no
JAX: the ranks start in seconds, and the tests hold their results to the
port's one-process results and to petr_tpu's. It holds no tests itself.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from petr_tpu_torch.parallel.mesh import make_mesh, shard_batch


def _threads(device: torch.device) -> None:
    if device.type == "cpu":  # several ranks share the host's cores
        torch.set_num_threads(2)


def attention_inputs(B: int, H: int, Q: int, D: int, L: int, seed: int = 0, mask: Optional[str] = "random",
                     pad_from: Optional[int] = None) -> Dict[str, np.ndarray]:
    """q (B, H, Q, D), k, v (B, H, L, D), a cotangent t like q, and a (B, L)
    key-padding mask: ``random`` (a quarter padded), ``tail`` (keys from
    ``pad_from`` on padded) or None."""
    rng = np.random.RandomState(seed)
    out = {n: rng.standard_normal(s).astype(np.float32)
           for n, s in (("q", (B, H, Q, D)), ("k", (B, H, L, D)), ("v", (B, H, L, D)), ("t", (B, H, Q, D)))}
    if mask == "random":
        out["mask"] = rng.uniform(size=(B, L)) < 0.25
    elif mask == "tail":
        m = np.zeros((B, L), bool)
        m[:, pad_from:] = True
        out["mask"] = m
    else:
        out["mask"] = None
    return out


def mesh_facts(world: int) -> Dict:
    """This rank's view of the meshes ``make_mesh`` and ``make_pod_mesh``
    build over ``world`` ranks: their shapes and this rank's place, and the
    rows of a global batch of ``2 * world`` that ``shard_batch`` keeps."""
    from petr_tpu_torch.parallel.distributed import make_pod_mesh

    meshes = {"default": make_mesh(), "data1": make_mesh(data=1), "pod": make_pod_mesh()}
    if world % 2 == 0:
        meshes["model2"] = make_mesh(world, model=2)
        meshes["pod2"] = make_pod_mesh(2)
    batch = {"x": np.arange(2 * world), "scalar": np.float32(1.0)}
    return {name: {"shape": m.shape, "index": (m.data_index, m.model_index),
                   "rows": shard_batch(batch, m)["x"].tolist(), "token_range": m.token_range(10)}
            for name, m in meshes.items()}


def attention_case(rank: int, world: int, device: torch.device, cases) -> Dict:
    """Both sharded attentions over a (1, world) mesh on the replicated
    inputs of each case (``attention_inputs`` and its dropout rate and
    seed) -> {"attention": per case {"plain" | "flash": {"out", "dq", "dk",
    "dv"}} of the loss sum(out * t), the plain one at dropout 0 only;
    "mesh": ``mesh_facts``}."""
    from petr_tpu_torch.parallel.sharded_attention import sharded_cross_attention, sharded_flash_cross_attention

    _threads(device)
    facts = mesh_facts(world)
    mesh = make_mesh(world, model=world)
    results = []
    for inputs, rate, seed in cases:
        mask = None if inputs["mask"] is None else torch.from_numpy(inputs["mask"]).to(device)
        t = torch.from_numpy(inputs["t"]).to(device)
        res = {}
        for name in ("plain", "flash") if rate == 0.0 else ("flash",):
            q, k, v = (torch.from_numpy(inputs[n]).to(device).requires_grad_(True) for n in "qkv")
            if name == "plain":
                out = sharded_cross_attention(q, k, v, mask, mesh)
            else:
                out = sharded_flash_cross_attention(q, k, v, mask, mesh, rate, seed)
            (out.float() * t).sum().backward()
            res[name] = {"out": out.detach().cpu().numpy(), "dq": q.grad.cpu().numpy(),
                         "dk": k.grad.cpu().numpy(), "dv": v.grad.cpu().numpy()}
        results.append(res)
    return {"attention": results, "mesh": facts}


def train_case(rank: int, world: int, device: torch.device, cases) -> list:
    """For each case (cfg, weights ``state_dict``, global ``batch``, a
    (data, model) mesh shape, seed, with_grads): one step of cfg on that
    mesh from the weights, each rank on its rows of the batch, every rank
    with ``train.step_generator(seed, 0)`` -> per case the step's metrics,
    the parameters and buffers after it, and with ``with_grads`` the
    averaged gradients (``make_grad_fn`` and the data group's mean, as the
    step takes them; None without)."""
    from petr_tpu_torch.train import accumulate_grads, batch_keys, create_train_state, make_grad_fn, make_train_step
    from petr_tpu_torch.train import step_generator
    from petr_tpu_torch.train.train_step import data_mean_grads

    _threads(device)
    results = []
    for cfg, state_dict, batch, (data, model), seed, with_grads in cases:
        mesh = make_mesh(world, data=data, model=model)
        local = shard_batch(batch, mesh)

        def fresh():
            state = create_train_state(cfg, 0, 100, device)
            state.model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
            return state

        grads = None
        if with_grads:
            grad_fn = make_grad_fn(cfg, mesh)
            if cfg.train.grad_accum > 1:
                _, _, grads, _ = accumulate_grads(grad_fn, fresh().model, local, step_generator(seed, 0),
                                                  cfg.train.grad_accum, batch_keys(cfg))
            else:
                _, _, grads, _, _ = grad_fn(fresh().model, local, step_generator(seed, 0))
            grads = {n: g.cpu().numpy() for n, g in data_mean_grads(grads, mesh).items()}
        state = fresh()
        state, metrics = make_train_step(cfg, mesh)(state, local, step_generator(seed, 0))
        results.append({
            "grads": grads,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.cpu().numpy() for k, v in state.model.state_dict().items()},
        })
    return results


def eval_case(rank: int, world: int, device: torch.device, cfg, state_dict: Dict[str, np.ndarray],
              infos_pkl: str, batch_size: int = 1, classes=None) -> Dict[str, float]:
    """``evaluate_model_multiprocess`` of the weights ``state_dict`` over the
    test-mode dataset of ``infos_pkl``."""
    from petr_tpu_torch.data import NuScenesDataset
    from petr_tpu_torch.models import PETRDetector
    from petr_tpu_torch.train.evaluate import evaluate_model_multiprocess

    _threads(device)
    model = PETRDetector(cfg.model)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    model = model.to(device).eval()
    ds = NuScenesDataset.from_pkl(infos_pkl, cfg.data, training=False)
    return evaluate_model_multiprocess(cfg, model, ds, batch_size, classes=classes)


def resume_case(rank: int, world: int, device: torch.device, cfg, ckpt: str) -> Dict:
    """Each rank builds its own state from seed ``rank`` (their weights
    differ) and only rank 0 restores the checkpoint directory ``ckpt``, as
    on hosts that share no file system; then ``replicate_state`` -> the
    state this rank holds: weights, AdamW state and step."""
    from petr_tpu_torch.parallel.mesh import replicate_state
    from petr_tpu_torch.train import create_train_state
    from petr_tpu_torch.train.checkpoint import restore_checkpoint

    _threads(device)
    state = create_train_state(cfg, rank, 100, device)
    if rank == 0:
        restore_checkpoint(ckpt, state)
    replicate_state(state, make_mesh(world))
    opt = state.optimizer.state_dict()
    return {"step": state.step, "model": {k: v.cpu().numpy() for k, v in state.model.state_dict().items()},
            "adam": {f"{i}.{k}": v.cpu().numpy() for i, s in opt["state"].items() for k, v in s.items()},
            "groups": opt["param_groups"]}
