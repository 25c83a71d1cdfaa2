"""Detection losses and matching costs (PyTorch), all in fp32.

Counterpart of `petr_tpu/ops/losses.py`. Behavioral references
(sty61010/PETR): mmdet ``FocalLoss(use_sigmoid=True, gamma=2, alpha=.25)``
at `petr_head.py:623`, ``L1Loss`` at `petr_head.py:638`, and
``FocalLossCost`` / ``BBox3DL1Cost`` (`hungarian_assigner_3d.py:117-123`).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    num_classes: int,
    gamma: float = 2.0,
    alpha: float = 0.25,
    avg_factor: Union[torch.Tensor, float] = 1.0,
) -> torch.Tensor:
    """Sigmoid focal loss, summed and divided by ``avg_factor``.

    logits (..., num_classes); labels (...,) int, where ``num_classes``
    means background (an all-zero target); weights: optional (...,).
    """
    logits = logits.float()
    p = torch.sigmoid(logits)
    t = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes].float()
    pt = (1.0 - p) * t + p * (1.0 - t)
    focal_weight = (alpha * t + (1.0 - alpha) * (1.0 - t)) * torch.pow(pt, gamma)
    bce = -(t * F.logsigmoid(logits) + (1.0 - t) * F.logsigmoid(-logits))
    loss = bce * focal_weight
    if weights is not None:
        loss = loss * weights[..., None].float()
    return loss.sum() / avg_factor


def weighted_l1_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    weights: torch.Tensor,
    *,
    avg_factor: Union[torch.Tensor, float] = 1.0,
) -> torch.Tensor:
    """Element-wise weighted L1, summed and divided by ``avg_factor``."""
    diff = (pred.float() - target.float()).abs()
    return (diff * weights.float()).sum() / avg_factor


def focal_loss_cost(
    logits: torch.Tensor,  # (..., Q, C)
    gt_labels: torch.Tensor,  # (..., G)
    *,
    weight: float = 2.0,
    gamma: float = 2.0,
    alpha: float = 0.25,
    eps: float = 1e-12,
) -> torch.Tensor:
    """mmdet FocalLossCost: cost[..., q, g] (..., Q, G) for matching. Leading
    axes of ``gt_labels`` broadcast against those of ``logits``."""
    p = torch.sigmoid(logits.float())
    neg_cost = -torch.log(1.0 - p + eps) * (1.0 - alpha) * torch.pow(p, gamma)
    pos_cost = -torch.log(p + eps) * alpha * torch.pow(1.0 - p, gamma)
    cls_cost = pos_cost - neg_cost  # (..., Q, C)
    lead = torch.broadcast_shapes(cls_cost.shape[:-2], gt_labels.shape[:-1])
    Q, G = cls_cost.shape[-2], gt_labels.shape[-1]
    index = gt_labels.long()[..., None, :].expand(*lead, Q, G)
    return torch.gather(cls_cost.expand(*lead, *cls_cost.shape[-2:]), -1, index) * weight


def bbox_l1_cost(bbox_pred: torch.Tensor, gt_codes: torch.Tensor, *, weight: float = 0.25) -> torch.Tensor:
    """L1 cdist (..., Q, G) between predicted codes (..., Q, K) and GT codes
    (..., G, K). The reference matches over the first 8 dims only
    (`hungarian_assigner_3d.py:122`): slice before calling."""
    diff = (bbox_pred.float()[..., :, None, :] - gt_codes.float()[..., None, :, :]).abs()
    return diff.sum(-1) * weight
