"""Everything a run feeds the program, drawn from ``--seed`` by the benchmark.

Samples (6 views each): standard-normal images drawn on the device by a
``torch.Generator`` and copied to the host once, since the program takes
host arrays; cameras from ``synthetic_cams``; for training, GT boxes. The
weights: one uniform and one normal draw on the device for the whole model,
sliced into its tensors by the rules of ``weight_rules``, and the BN
statistics set by the plain reference (``reference.model.
normalize_bn_statistics``) on the pool's first sample. The port and the
reference load the same weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

FOCAL_PRIOR_BIAS = -4.59511985013459  # -log((1 - 0.01) / 0.01), the cls branch's last bias


def synthetic_cams(B: int, N: int, H: int = 320, W: int = 800, yaws=None) -> np.ndarray:
    """img2lidar (B, N, 4, 4) of N outward-facing pinhole cameras 1.5 m up.

    Frozen copy of ``petr_tpu_torch/cli/quantize.py::synthetic_cams``, with
    the intrinsics scaled to the image (focal W / 2, principal point at the
    centre: the copy's 400 and (400, 160) at 800 x 320) and the rig of
    sample b turned by ``yaws[b]`` radians about the vertical."""
    mats = np.zeros((B, N, 4, 4), np.float64)
    for b in range(B):
        turn = 0.0 if yaws is None else float(yaws[b])
        for i in range(N):
            yaw = 2 * np.pi * i / max(N, 1) + turn
            R = np.array([[-np.sin(yaw), np.cos(yaw), 0], [0, 0, -1], [np.cos(yaw), np.sin(yaw), 0]])
            E = np.eye(4)
            E[:3, :3] = R
            E[:3, 3] = -R @ np.array([np.cos(yaw), np.sin(yaw), 1.5])
            K = np.eye(4)
            K[0, 0] = K[1, 1] = W / 2.0
            K[0, 2], K[1, 2] = W / 2.0, H / 2.0
            mats[b, i] = K @ E
    return np.linalg.inv(mats).astype(np.float32)


def seed_stream(seed: int, *tags: int) -> int:
    """A 63-bit seed for one named stream of a run, from the run's seed."""
    return int(np.random.SeedSequence([int(seed) & (2**64 - 1), *tags]).generate_state(1, np.uint64)[0] >> 1)


def device_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def draw_samples(seed: int, n: int, views: int, hw: Tuple[int, int], device) -> Dict[str, np.ndarray]:
    """``n`` samples on the host: images (n, V, H, W, 3) float32 drawn on
    ``device``, img2lidar (n, V, 4, 4), img_hw (n, V, 2)."""
    H, W = hw
    g = device_generator(seed_stream(seed, 1), device)
    rng = np.random.default_rng(seed_stream(seed, 2))
    images = torch.randn((n, views, H, W, 3), generator=g, device=device).cpu().numpy()
    return {
        "images": images,
        "img2lidar": synthetic_cams(n, views, H, W, yaws=rng.uniform(-np.pi, np.pi, n)),
        "img_hw": np.tile(np.array([H, W], np.float32), (n, views, 1)),
    }


def draw_gt(seed: int, n: int, max_gt: int, counts: Tuple[int, int], pc_range, num_classes: int):
    """GT of ``n`` samples: per sample a count uniform on ``counts`` (both
    ends included) of boxes with centres inside pc_range, sizes 0.5-5 m, any
    yaw, velocities within 1 m/s; padded to ``max_gt`` rows."""
    rng = np.random.default_rng(seed_stream(seed, 3))
    pc = pc_range
    boxes = np.zeros((n, max_gt, 9), np.float32)
    labels = np.zeros((n, max_gt), np.int64)
    valid = np.zeros((n, max_gt), bool)
    for b in range(n):
        k = int(rng.integers(counts[0], counts[1] + 1))
        boxes[b, :k] = np.concatenate([
            rng.uniform(pc[0], pc[3], (k, 1)), rng.uniform(pc[1], pc[4], (k, 1)), rng.uniform(pc[2], pc[5], (k, 1)),
            rng.uniform(0.5, 5.0, (k, 3)), rng.uniform(-np.pi, np.pi, (k, 1)), rng.uniform(-1.0, 1.0, (k, 2)),
        ], -1)
        labels[b, :k] = rng.integers(0, num_classes, k)
        valid[b, :k] = True
    return {"gt_boxes": boxes, "gt_labels": labels, "gt_valid": valid}


# --------------------------------------------------------------- weights
def weight_rules(names_shapes: List[Tuple[str, Tuple[int, ...]]], weights_cfg: Dict) -> List[Tuple[str, str, float]]:
    """(name, kind, scale) for each tensor, by its name and shape: kinds
    "zero", "one", "uniform" (U(-scale, scale)), "unit" (U(0, 1)),
    "normal" (N(0, scale)), "focal" (the focal prior), "offset_bias"."""
    shapes = dict(names_shapes)
    rules = []
    for name, shape in names_shapes:
        stem = name.rsplit(".", 1)[0]
        sibling = shapes.get(stem + ".weight")
        if name.endswith("running_mean"):
            rules.append((name, "zero", 0.0))
        elif name.endswith("running_var"):
            rules.append((name, "one", 0.0))
        elif name.endswith("in_proj_weight"):
            rules.append((name, "uniform", math.sqrt(6.0 / (shape[0] + shape[1]))))
        elif name.endswith("in_proj_bias"):
            rules.append((name, "zero", 0.0))
        elif name.endswith("reference_points.weight"):
            rules.append((name, "unit", 0.0))
        elif name.endswith("conv_offset.weight"):
            fan = math.prod(shape[1:])
            rules.append((name, "normal", weights_cfg["offset_weight_std"] / math.sqrt(fan)))
        elif name.endswith("conv_offset.bias"):
            rules.append((name, "offset_bias", weights_cfg["offset_bias_px"]))
        elif name.endswith(".weight") and len(shape) == 1:  # a norm's scale
            rules.append((name, "one", 0.0))
        elif name.endswith(".bias") and sibling is not None and len(sibling) == 1:
            rules.append((name, "zero", 0.0))
        elif name.endswith(".weight"):
            fan = math.prod(shape[1:])
            conv = len(shape) == 4 and not name.startswith("pts_bbox_head.")  # the head's 1x1 convs are linear maps
            rules.append((name, "uniform", math.sqrt(6.0 / fan) if conv else 1.0 / math.sqrt(fan)))
        elif name.endswith(".bias"):
            fan = math.prod(sibling[1:])
            last_cls = ".cls_branches." in name and shape[0] == weights_cfg["num_classes"]
            rules.append((name, "focal" if last_cls else "uniform", 1.0 / math.sqrt(fan)))
        else:
            raise ValueError(f"no weight rule for {name} {shape}")
    return rules


def draw_weights(seed: int, state: Dict[str, torch.Tensor], weights_cfg: Dict, device) -> Dict[str, torch.Tensor]:
    """fp32 weights for every tensor of ``state`` (a state_dict, whose
    aliases share one draw), in two draws on ``device``."""
    unique, alias = [], {}
    seen = {}
    for name, t in state.items():
        key = (t.data_ptr(), tuple(t.shape)) if t.numel() else (name,)
        if key in seen:
            alias[name] = seen[key]
        else:
            seen[key] = name
            unique.append((name, tuple(t.shape)))
    rules = weight_rules(unique, weights_cfg)
    sizes = {n: math.prod(s) for n, s in unique}
    n_uniform = sum(sizes[n] for n, k, _ in rules if k in ("uniform", "unit", "offset_bias"))
    n_normal = sum(sizes[n] for n, k, _ in rules if k in ("normal", "offset_bias"))
    g = device_generator(seed_stream(seed, 4), device)
    u = torch.rand(n_uniform, generator=g, device=device)
    z = torch.randn(n_normal, generator=g, device=device)
    out, iu, iz = {}, 0, 0
    shapes = dict(unique)
    for name, kind, scale in rules:
        n, shape = sizes[name], shapes[name]
        if kind == "zero":
            t = torch.zeros(shape, device=device)
        elif kind == "one":
            t = torch.ones(shape, device=device)
        elif kind == "focal":
            t = torch.full(shape, FOCAL_PRIOR_BIAS, device=device)
        elif kind == "unit":
            t = u[iu:iu + n].view(shape).clone()
            iu += n
        elif kind == "uniform":
            t = (u[iu:iu + n] * (2 * scale) - scale).view(shape)
            iu += n
        elif kind == "normal":
            t = (z[iz:iz + n] * scale).view(shape)
            iz += n
        else:  # offset_bias: (dy, dx) of each tap U(-px, px), then the mask logits N(0, 1)
            taps = shape[0] // 3
            t = torch.cat([u[iu:iu + 2 * taps] * (2 * scale) - scale, z[iz:iz + taps]])
            iu += n
            iz += n
        out[name] = t
    for name, src in alias.items():
        out[name] = out[src]
    return {name: out[name] for name in state}
