"""NMS-free top-k box decoding with a fixed output size.

Counterpart of `petr_tpu/ops/nms_free.py` (reference
`core/bbox/coders/nms_free_coder.py:48-120`, sty61010/PETR), batched over B.
The reference drops boxes outside ``post_center_range`` by boolean indexing;
here the output keeps ``max_num`` rows with a ``valid`` mask, as in petr_tpu.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from petr_tpu_torch.ops.boxes import decode_bbox


def nms_free_decode(
    cls_logits: torch.Tensor,
    bbox_codes: torch.Tensor,
    *,
    max_num: int = 300,
    num_classes: int = 10,
    post_center_range: Sequence[float] | None = None,
    score_threshold: float | None = None,
) -> Dict[str, torch.Tensor]:
    """Decode the final-layer head outputs of a batch.

    Args:
        cls_logits: (B, Q, num_classes).
        bbox_codes: (B, Q, 10) normalized codes, centers already in metric
            pc_range.
    Returns:
        dict of boxes (B, max_num, 9), scores (B, max_num), labels
        (B, max_num) int32 and valid (B, max_num) bool.
    """
    B = cls_logits.shape[0]
    scores_all = torch.sigmoid(cls_logits.float()).reshape(B, -1)
    max_num = min(max_num, scores_all.shape[1])
    # a stable descending sort ranks equal scores by index, as lax.top_k does
    scores, idx = torch.sort(scores_all, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :max_num], idx[:, :max_num]
    labels = (idx % num_classes).to(torch.int32)
    box_idx = idx // num_classes
    codes = torch.gather(
        bbox_codes.float(), 1, box_idx[..., None].expand(-1, -1, bbox_codes.shape[-1])
    )
    boxes = decode_bbox(codes)

    valid = torch.ones_like(scores, dtype=torch.bool)
    if score_threshold is not None:
        valid &= scores > score_threshold
    if post_center_range is not None:
        pcr = torch.tensor(post_center_range, dtype=torch.float32, device=boxes.device)
        centers = boxes[..., :3]
        valid &= (centers >= pcr[:3]).all(-1) & (centers <= pcr[3:]).all(-1)
    return {"boxes": boxes, "scores": scores, "labels": labels, "valid": valid}
