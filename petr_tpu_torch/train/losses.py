"""PETR set-prediction loss: per-decoder-layer Hungarian matching + focal/L1.

Counterpart of `petr_tpu/train/losses.py` (reference
`models/dense_heads/petr_head.py:470-728` and
`core/bbox/assigners/hungarian_assigner_3d.py`, sty61010/PETR):
  * per layer and sample: cost = FocalLossCost (w 2) + L1 cost (w 0.25)
    over the first 8 normalised code dims; Hungarian assignment; matched
    queries take the GT label and code, the rest are background;
  * the focal loss is normalised per sample by its own positive count
    (``sync_cls_avg_factor=False``, the reference's per-GPU normaliser), or
    by the batch's; the L1 by the batch's positive count clamped at 1, and
    weighted by ``code_weights``;
  * all in fp32; no gradient flows through the matching costs;
  * under data parallelism (a mesh in context) the batch's positive count
    is the mean of the ranks' counts (`petr_tpu/train/losses.py:133-134`),
    so that the ranks' mean loss is the global batch's.

The costs of all layers and samples cross to the host in one copy for the
LAP (`ops/matcher.py`). The assignment may also come in precomputed
(``indices``), so that a comparison can hold two runs to one matching.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from petr_tpu_torch.ops.boxes import encode_bbox
from petr_tpu_torch.ops.losses import bbox_l1_cost, focal_loss_cost, sigmoid_focal_loss, weighted_l1_loss
from petr_tpu_torch.ops.matcher import match_layers
from petr_tpu_torch.parallel.mesh import data_mean, data_parallel


def target_codes(gt_boxes: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """(..., G, 10) normalised GT codes; padded rows are finite zeros, so
    that the cost and target math stays clean."""
    gt_codes = encode_bbox(gt_boxes.float())
    return torch.where(gt_valid.to(torch.bool)[..., None], torch.nan_to_num(gt_codes), 0.0)


def match_cost(
    cls_logits: torch.Tensor,  # (..., Q, C)
    codes: torch.Tensor,  # (..., Q, 10)
    gt_codes: torch.Tensor,  # (..., G, 10)
    gt_labels: torch.Tensor,  # (..., G)
    *,
    cls_weight: float,
    bbox_weight: float,
) -> torch.Tensor:
    """The matching cost (..., Q, G), without gradient."""
    with torch.no_grad():
        return focal_loss_cost(cls_logits, gt_labels, weight=cls_weight) + bbox_l1_cost(
            codes[..., :8], gt_codes[..., :8], weight=bbox_weight
        )


def _targets(
    indices: torch.Tensor,  # (..., G) query of each GT
    gt_codes: torch.Tensor,  # (..., G, K)
    gt_labels: torch.Tensor,  # (..., G)
    gt_valid: torch.Tensor,  # (..., G)
    Q: int,
    num_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-query labels (..., Q), targets (..., Q, K) and weights (..., Q).
    Invalid GT rows scatter into a dump slot past Q, so that their arbitrary
    index can never clobber a real match."""
    q_idx = torch.where(gt_valid, indices, Q)
    lead = q_idx.shape[:-1]
    K = gt_codes.shape[-1]
    labels = torch.full((*lead, Q + 1), num_classes, dtype=torch.int64, device=q_idx.device)
    labels.scatter_(-1, q_idx, gt_labels.long().expand_as(q_idx))
    targets = torch.zeros((*lead, Q + 1, K), dtype=torch.float32, device=q_idx.device)
    targets.scatter_(-2, q_idx[..., None].expand(*q_idx.shape, K), gt_codes.float().expand(*q_idx.shape, K))
    weights = torch.zeros((*lead, Q + 1), dtype=torch.float32, device=q_idx.device)
    weights.scatter_(-1, q_idx, 1.0)
    return labels[..., :Q], targets[..., :Q, :], weights[..., :Q]


def _match_single(
    cls_logits: torch.Tensor,  # (Q, C)
    codes: torch.Tensor,  # (Q, 10)
    gt_codes: torch.Tensor,  # (G, 10)
    gt_labels: torch.Tensor,  # (G,)
    gt_valid: torch.Tensor,  # (G,)
    *,
    num_classes: int,
    cls_weight: float,
    bbox_weight: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One (layer, sample): (labels (Q,), targets (Q, 10), weights (Q,), num_pos)."""
    Q = cls_logits.shape[0]
    cost = match_cost(cls_logits, codes, gt_codes, gt_labels, cls_weight=cls_weight, bbox_weight=bbox_weight)
    q_of_g = torch.from_numpy(match_layers(cost[None, None], gt_valid[None])[0, 0]).to(cls_logits.device)
    labels, targets, weights = _targets(q_of_g, gt_codes, gt_labels, gt_valid, Q, num_classes)
    return labels, targets, weights, gt_valid.sum().float()


def petr_set_loss(
    outputs: Dict[str, torch.Tensor],
    gt_boxes: torch.Tensor,  # (B, G, 9) raw gravity-center boxes (padded)
    gt_labels: torch.Tensor,  # (B, G) int
    gt_valid: torch.Tensor,  # (B, G) bool
    *,
    num_classes: int = 10,
    cls_weight: float = 2.0,
    bbox_weight: float = 0.25,
    code_weights: Sequence[float] = (1.0,) * 8 + (0.2, 0.2),
    sync_cls_avg_factor: bool = False,
    indices: Optional[np.ndarray] = None,  # (L, B, G) query of each GT
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], np.ndarray]:
    """(total, per-layer losses named as petr_tpu's, the (L, B, G) assignment)."""
    all_cls = outputs["cls_logits"].float()  # (L, B, Q, C)
    all_codes = outputs["bbox_codes"].float()  # (L, B, Q, 10)
    L, B, Q, _ = all_cls.shape
    dev = all_cls.device
    gt_valid = gt_valid.to(torch.bool)
    code_w = torch.tensor(code_weights, dtype=torch.float32, device=dev)

    gt_codes = target_codes(gt_boxes, gt_valid)  # (B, G, 10)

    if indices is None:
        cost = match_cost(all_cls, all_codes, gt_codes, gt_labels, cls_weight=cls_weight, bbox_weight=bbox_weight)
        indices = match_layers(cost, gt_valid)  # the step's one device->host sync
    idx = torch.as_tensor(np.asarray(indices), dtype=torch.int64, device=dev)
    labels, targets, weights = _targets(idx, gt_codes, gt_labels, gt_valid, Q, num_classes)
    num_pos = gt_valid.sum(-1).float()  # (B,), the same at every layer

    losses: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=dev)
    # the positive count the normalisers take: the mean of the data group's
    n_pos = data_mean(num_pos.sum(), data_parallel())
    for lvl in range(L):
        if sync_cls_avg_factor:
            loss_cls = sigmoid_focal_loss(
                all_cls[lvl].reshape(B * Q, -1), labels[lvl].reshape(B * Q),
                num_classes=num_classes, avg_factor=n_pos.clamp(min=1.0),
            ) * cls_weight
        else:
            # each sample normalised by its OWN positive count, as each rank
            # of the reference's 1-sample-per-GPU recipe does
            per_sample = torch.stack([
                sigmoid_focal_loss(all_cls[lvl, b], labels[lvl, b], num_classes=num_classes,
                                   avg_factor=num_pos[b].clamp(min=1.0))
                for b in range(B)
            ])
            loss_cls = per_sample.mean() * cls_weight

        tgt = targets[lvl]
        finite = torch.isfinite(tgt).all(-1)
        w = weights[lvl] * finite.float()
        loss_bbox = weighted_l1_loss(
            all_codes[lvl], torch.nan_to_num(tgt), w[..., None] * code_w, avg_factor=n_pos.clamp(min=1.0),
        ) * bbox_weight

        loss_cls = torch.nan_to_num(loss_cls)
        loss_bbox = torch.nan_to_num(loss_bbox)
        prefix = "" if lvl == L - 1 else f"d{lvl}."
        losses[f"{prefix}loss_cls"] = loss_cls
        losses[f"{prefix}loss_bbox"] = loss_bbox
        total = total + loss_cls + loss_bbox

    losses["num_pos"] = num_pos.sum()
    return total, losses, np.asarray(indices)
