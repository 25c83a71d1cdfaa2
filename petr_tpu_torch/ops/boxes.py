"""3D box codec — the 10-dim normalized layout used for regression/decoding.

Counterpart of `petr_tpu/ops/boxes.py` (reference
`projects/mmdet3d_plugin/core/bbox/util.py:38-87`, sty61010/PETR):

    raw box   : (cx, cy, cz, w, l, h, yaw[, vx, vy])          (9-dim)
    normalized: (cx, cy, log w, log l, cz, log h, sin yaw, cos yaw[, vx, vy])

cz sits at index 4 of the normalized code, not index 2.
"""

from __future__ import annotations

import torch


def encode_bbox(boxes: torch.Tensor) -> torch.Tensor:
    """Raw 7/9-dim boxes -> 8/10-dim normalized regression targets."""
    yaw = boxes[..., 6:7]
    parts = [
        boxes[..., 0:1], boxes[..., 1:2],
        boxes[..., 3:4].log(), boxes[..., 4:5].log(),
        boxes[..., 2:3], boxes[..., 5:6].log(),
        yaw.sin(), yaw.cos(),
    ]
    if boxes.shape[-1] > 7:
        parts += [boxes[..., 7:8], boxes[..., 8:9]]
    return torch.cat(parts, dim=-1)


def decode_bbox(codes: torch.Tensor) -> torch.Tensor:
    """8/10-dim normalized codes -> raw 7/9-dim boxes."""
    parts = [
        codes[..., 0:1], codes[..., 1:2], codes[..., 4:5],
        codes[..., 2:3].exp(), codes[..., 3:4].exp(), codes[..., 5:6].exp(),
        torch.atan2(codes[..., 6:7], codes[..., 7:8]),
    ]
    if codes.shape[-1] > 8:
        parts += [codes[..., 8:9], codes[..., 9:10]]
    return torch.cat(parts, dim=-1)
