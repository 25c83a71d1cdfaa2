"""The plain reference of the PETR train step: set loss, matching, AdamW.

A frozen copy of the port's ``train/{train_step,losses,optim}.py`` and
``ops/{losses,matcher}.py`` as of the benchmark's first version, in fp32, on
``reference.model.Detector``: per decoder layer and sample a Hungarian
assignment (scipy) on the focal and L1 costs, the focal loss normalised by
each sample's positive count and averaged over the batch, the L1 by the
batch's count, a global-norm clip at the recipe's 35 and AdamW with the
backbone at 0.1 of the learning rate, the schedule mmcv's cosine with
linear warmup. A batch is stepped one sample at a time: each sample's share
of the loss is its focal term over the batch size and its L1 term over the
batch's positive count, so the summed gradients are the batch's.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from h100_bench.reference.model import Detector, FrozenBatchNorm, draw_train_noise, encode_bbox


def focal_loss(logits, labels, num_classes, gamma=2.0, alpha=0.25):
    p = torch.sigmoid(logits)
    t = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes].float()
    pt = (1.0 - p) * t + p * (1.0 - t)
    w = (alpha * t + (1.0 - alpha) * (1.0 - t)) * pt.pow(gamma)
    bce = -(t * F.logsigmoid(logits) + (1.0 - t) * F.logsigmoid(-logits))
    return (bce * w).sum()


def match_cost(logits, codes, gt_codes, gt_labels, cls_weight, bbox_weight, gamma=2.0, alpha=0.25, eps=1e-12):
    """(Q, G) FocalLossCost + L1 cost over the first 8 code dims."""
    p = torch.sigmoid(logits)
    neg = -torch.log(1.0 - p + eps) * (1.0 - alpha) * p.pow(gamma)
    pos = -torch.log(p + eps) * alpha * (1.0 - p).pow(gamma)
    cls = (pos - neg)[:, gt_labels.long()] * cls_weight
    l1 = (codes[:, None, :8] - gt_codes[None, :, :8]).abs().sum(-1) * bbox_weight
    return cls + l1


def assign(cost: torch.Tensor, valid: np.ndarray) -> np.ndarray:
    """The query of each valid GT (G,), 0 for padding rows."""
    c = np.nan_to_num(cost.detach().float().T.cpu().numpy(), nan=100.0, posinf=100.0, neginf=-100.0)
    out = np.zeros(c.shape[0], np.int64)
    rows = np.flatnonzero(valid)
    if rows.size:
        r, col = linear_sum_assignment(c[rows])
        out[rows[r]] = col
    return out


def lr_at(step: int, optim: Dict, total_steps: int) -> float:
    """mmcv cosine annealing with linear warmup, in fp32 as the port."""
    s = torch.tensor(step, dtype=torch.float32)
    t = torch.clamp(s / max(optim["warmup_iters"], 1), max=1.0)
    warm = optim["lr"] * (1.0 - (1.0 - t) * (1.0 - optim["warmup_ratio"]))
    prog = torch.clamp(s / max(total_steps, 1), 0.0, 1.0)
    target = optim["lr"] * optim["min_lr_ratio"]
    cos = target + 0.5 * (optim["lr"] - target) * (1.0 + torch.cos(math.pi * prog))
    return float(torch.minimum(warm, cos) if step < optim["warmup_iters"] else cos)


class ReferenceTrainer:
    """The reference's model and AdamW, stepped on the benchmark's batches."""

    def __init__(self, spec: Dict, state: Dict[str, torch.Tensor], device, total_steps: int):
        self.spec = spec
        self.optim = spec["optim"]
        self.total_steps = total_steps
        self.model = Detector(spec["model"]).to(device)
        self.model.load_state_dict(state)
        self.model.train()
        frozen = set()
        if not spec["model"]["backbone"]["train_bn_affine"]:
            frozen = {id(p) for m in self.model.img_backbone.modules() if isinstance(m, FrozenBatchNorm)
                      for p in (m.weight, m.bias)}
        groups = {"main": [], "backbone": []}
        for name, p in self.model.named_parameters():
            if id(p) in frozen:
                p.requires_grad_(False)
            else:
                groups["backbone" if name.startswith("img_backbone.") else "main"].append(p)
        mult = {"main": 1.0, "backbone": self.optim["backbone_lr_mult"]}
        self.optimizer = torch.optim.AdamW(
            [{"params": ps, "lr_mult": mult[g]} for g, ps in groups.items() if ps],
            lr=self.optim["lr"], betas=(0.9, 0.999), eps=1e-8, weight_decay=self.optim["weight_decay"])
        self.step_count = 0

    def trainable(self) -> Dict[str, torch.nn.Parameter]:
        return {n: p for n, p in self.model.named_parameters() if p.requires_grad}

    def loss_and_grads(self, batch: Dict[str, torch.Tensor], generator: torch.Generator, rows=None):
        """The batch's loss, and its gradients summed into ``.grad``, one
        sample at a time; ``rows`` restricts the batch to those samples (the
        same share each takes of the whole batch's loss)."""
        m, o = self.spec["model"], self.optim
        hc = m["head"]
        B = batch["images"].shape[0]
        noise = draw_train_noise(generator, batch["images"].shape[2], hc["num_layers"], m["use_grid_mask"], B)
        valid = batch["gt_valid"].bool()
        num_pos = valid.sum(-1).float()
        n_pos = num_pos.sum().clamp(min=1.0)
        code_w = torch.tensor(o["code_weights"], dtype=torch.float32, device=batch["images"].device)
        total = 0.0
        for b in (range(B) if rows is None else rows):
            noise.row = b
            sl = slice(b, b + 1)
            out = self.model(batch["images"][sl], batch["img2lidar"][sl], batch["img_hw"][sl], noise)
            cls, codes = out["cls_logits"][:, 0], out["bbox_codes"][:, 0]  # (L, Q, .)
            gt_codes = torch.where(valid[b][:, None], torch.nan_to_num(encode_bbox(batch["gt_boxes"][b].float())), 0.0)
            labels_gt = batch["gt_labels"][b]
            loss = torch.zeros((), device=cls.device)
            Q = cls.shape[1]
            for lvl in range(cls.shape[0]):
                with torch.no_grad():
                    cost = match_cost(cls[lvl], codes[lvl], gt_codes, labels_gt, o["cls_weight"], o["bbox_weight"])
                q_of_g = torch.as_tensor(assign(cost, valid[b].cpu().numpy()), device=cls.device)
                q_idx = torch.where(valid[b], q_of_g, Q)
                labels = torch.full((Q + 1,), hc["num_classes"], dtype=torch.int64, device=cls.device)
                labels.scatter_(0, q_idx, labels_gt.long())
                targets = torch.zeros((Q + 1, 10), device=cls.device)
                targets.scatter_(0, q_idx[:, None].expand(-1, 10), gt_codes)
                weights = torch.zeros((Q + 1,), device=cls.device)
                weights.scatter_(0, q_idx, 1.0)
                lc = focal_loss(cls[lvl], labels[:Q], hc["num_classes"]) / num_pos[b].clamp(min=1.0)
                lb = ((codes[lvl] - targets[:Q]).abs() * (weights[:Q, None] * code_w)).sum() / n_pos
                loss = loss + lc * o["cls_weight"] / B + lb * o["bbox_weight"]
            loss.backward()
            total += float(loss.detach())
            del out, loss
        return total

    def step(self, batch, generator, rows=None) -> Dict:
        """One train step; returns the loss, the gradients' global norm, the
        per-leaf norms of the gradient and of the clipped gradient, and
        whether it was skipped (a non-finite gradient)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_and_grads(batch, generator, rows)
        params = self.trainable()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in params.items()}
        gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        finite = bool(torch.isfinite(gnorm))
        raw = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
        scale = 1.0 if float(gnorm) < self.optim["grad_clip_norm"] else self.optim["grad_clip_norm"] / float(gnorm)
        clipped = {n: v * scale for n, v in raw.items()}
        if finite:
            lr = lr_at(self.step_count, self.optim, self.total_steps)
            for g in self.optimizer.param_groups:
                g["lr"] = lr * g["lr_mult"]
            for n, p in params.items():
                p.grad = grads[n] * scale
            self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step_count += 1
        return {"loss": loss, "grad_norm": float(gnorm), "raw": raw, "clipped": clipped, "skipped": not finite}
