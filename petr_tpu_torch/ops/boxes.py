"""3D box codec — the 10-dim normalized layout used for regression/decoding.

Counterpart of `petr_tpu/ops/boxes.py` (reference
`projects/mmdet3d_plugin/core/bbox/util.py:38-87`, sty61010/PETR):

    raw box   : (cx, cy, cz, w, l, h, yaw[, vx, vy])          (9-dim)
    normalized: (cx, cy, log w, log l, cz, log h, sin yaw, cos yaw[, vx, vy])

cz sits at index 4 of the normalized code, not index 2. ``box_corners``
gives the 8 corners of gravity-centre boxes (Depthr's GT depth maps).
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


def box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """8 corners of gravity-center boxes, (..., 8, 3); petr_tpu's
    ``box_corners`` (`petr_tpu/ops/boxes.py:85-105`).

    mmdet3d 0.17 LiDAR boxes: at yaw=0 dim w spans x and l spans y; yaw
    rotates about +z. Corner order is the (x, y, z) sign lattice (---, --+,
    -+-, ..., +++) in the box-local frame.
    """
    signs = torch.tensor(
        [[sx, sy, sz] for sx in (-0.5, 0.5) for sy in (-0.5, 0.5) for sz in (-0.5, 0.5)],
        dtype=boxes.dtype, device=boxes.device,
    )  # (8, 3)
    local = signs * boxes[..., None, 3:6]  # (..., 8, 3)
    yaw = boxes[..., 6:7]
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = local[..., 0] * c - local[..., 1] * s
    y = local[..., 0] * s + local[..., 1] * c
    return torch.stack([x, y, local[..., 2]], dim=-1) + boxes[..., None, :3]
