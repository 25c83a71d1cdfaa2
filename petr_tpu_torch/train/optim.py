"""Optimizer and LR schedule of the reference recipe (PyTorch).

Counterpart of `petr_tpu/train/optim.py` (reference
`projects/configs/petr/petr_vovnet_gridmask_p4_800x320.py:241-260`): AdamW,
lr 2e-4 with the backbone at x0.1, b1 0.9, b2 0.999, eps 1e-8, weight
decay 0.01 on every trainable parameter (as ``optax.adamw`` decays them,
norms and biases included), a global-norm clip at 35 over the trainable
parameters only, and mmcv's cosine annealing with linear warmup.

Frozen BN statistics are buffers here, so they take no update by
construction; the backbone's BN affine is frozen (``requires_grad=False``)
only when the config says ``train_bn_affine=False``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
from torch import nn

from petr_tpu_torch.configs.config import OptimConfig
from petr_tpu_torch.models.layers import FrozenBatchNorm


def make_lr_schedule(cfg: OptimConfig, total_steps: int) -> Callable[[int], float]:
    """mmcv CosineAnnealing with linear warmup, in fp32 arithmetic as
    petr_tpu computes it. The update of step ``t`` (from 0) uses ``lr(t)``.

    warmup (t < warmup_iters): lr * (1 - (1 - t / T_w) * (1 - ratio)),
    capped by the cosine; after: cosine from lr to lr * min_lr_ratio over
    ``total_steps``, progress measured from step 0.
    """

    def schedule(step: int) -> float:
        step = torch.tensor(step, dtype=torch.float32)
        t = torch.clamp(step / max(cfg.warmup_iters, 1), max=1.0)
        warm = cfg.lr * (1.0 - (1.0 - t) * (1.0 - cfg.warmup_ratio))
        progress = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        target = cfg.lr * cfg.min_lr_ratio
        cos = target + 0.5 * (cfg.lr - target) * (1.0 + torch.cos(math.pi * progress))
        lr = torch.minimum(warm, cos) if bool(step < cfg.warmup_iters) else cos
        return float(lr)

    return schedule


def _backbone_bn_affine(model: nn.Module) -> List[nn.Parameter]:
    bb = getattr(model, "img_backbone", None)
    if bb is None:
        return []
    return [p for m in bb.modules() if isinstance(m, FrozenBatchNorm) for p in (m.weight, m.bias)]


def param_labels(model: nn.Module, freeze_backbone_bn_affine: bool = False) -> Dict[str, str]:
    """Parameter name -> 'frozen' (backbone BN affine of the r50 configs),
    'backbone' (lr x backbone_lr_mult) or 'main'."""
    frozen = {id(p) for p in _backbone_bn_affine(model)} if freeze_backbone_bn_affine else set()
    labels = {}
    for name, p in model.named_parameters():
        if id(p) in frozen:
            labels[name] = "frozen"
        elif name.startswith("img_backbone."):
            labels[name] = "backbone"
        else:
            labels[name] = "main"
    return labels


def build_optimizer(cfg: OptimConfig, model: nn.Module,
                    freeze_backbone_bn_affine: bool = False) -> torch.optim.AdamW:
    """AdamW over ``model``'s parameters in two groups, 'main' and
    'backbone', each carrying its ``lr_mult``; the train step sets each
    group's lr to schedule(step) * lr_mult before the update. Frozen
    parameters get ``requires_grad=False`` and stay out of both groups."""
    labels = param_labels(model, freeze_backbone_bn_affine)
    groups: Dict[str, list] = {"main": [], "backbone": []}
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(False)
        else:
            groups[labels[name]].append(p)
    mults = {"main": 1.0, "backbone": cfg.backbone_lr_mult}
    return torch.optim.AdamW(
        [{"params": ps, "lr_mult": mults[g], "name": g} for g, ps in groups.items() if ps],
        lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay,
    )


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient, in fp32, finite
    wherever the gradients are.

    The sum runs over the gradients divided by a power of two near their
    largest entry, and the root is multiplied back. Dividing by a power of
    two is exact, so where the plain sum does not overflow the result is
    the same bit for bit (optax's ``global_norm``, petr_tpu's). Where it
    would overflow (entries past ~1e19, which a backbone under frozen BN at
    its identity statistics can reach in a run from random weights) the
    plain norm is inf, and the clip divides every gradient by it: every
    update after that is zero and the run stops learning while it looks
    healthy. A non-finite gradient still gives a non-finite norm.
    """
    grads = [g.float() for g in grads]
    largest = torch.stack([g.abs().max() for g in grads]).max()
    _, exponent = torch.frexp(largest)
    scale = torch.where(torch.isfinite(largest) & (largest > 0), torch.ldexp(torch.ones_like(largest), exponent),
                        torch.ones_like(largest))
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g / scale) for g in grads])) * scale


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float, norm: torch.Tensor) -> List[torch.Tensor]:
    """optax's clip: unchanged when ``norm < max_norm``, else g / norm * max_norm."""
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm) for g in grads]
