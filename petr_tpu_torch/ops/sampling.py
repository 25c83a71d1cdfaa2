"""Bilinear sampling with zeros outside the plane (PyTorch).

Counterpart of `petr_tpu/ops/sampling.py`: the same signatures, feat
(H, W, C) channels-last and points (..., 2) as (x, y) in pixels, where
(0, 0) is the centre of the top-left pixel. Each of the four corners is read
where it lies inside the plane and counts as 0 where it does not
(`sampling.py:32-38`), so a point half a pixel outside an edge gets half of
the edge pixel. ``bilinear_sample_batched`` is the same over a leading batch
axis, as ``jax.vmap(bilinear_sample)``; the DCN's plain version uses it.
"""

from __future__ import annotations

import torch


def bilinear_sample_batched(feat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W, C), xy (B, ..., 2) -> (B, ..., C), in feat's dtype
    promoted with fp32 (the weights are fp32)."""
    B, H, W, C = feat.shape
    pts = xy.shape[1:-1]
    x = xy[..., 0].float().reshape(B, -1)
    y = xy[..., 1].float().reshape(B, -1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    flat = feat.reshape(B, H * W, C)

    def gather(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()  # (B, P)
        v = torch.gather(flat, 1, idx[..., None].expand(B, idx.shape[1], C))
        return torch.where(inb[..., None], v, 0.0)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    out = (
        v00 * (1 - wx) * (1 - wy)
        + v01 * wx * (1 - wy)
        + v10 * (1 - wx) * wy
        + v11 * wx * wy
    )
    return out.reshape(B, *pts, C)


def bilinear_sample(feat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample ``feat`` (H, W, C) at fractional pixel locations ``xy``
    (..., 2) as (x, y) -> (..., C); out-of-bounds corners read 0."""
    return bilinear_sample_batched(feat[None], xy[None])[0]


def grid_sample_normalized(feat: torch.Tensor, grid: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """torch-style grid_sample with coords in [-1, 1]: feat (H, W, C), grid
    (..., 2) normalized (x, y)."""
    H, W, _ = feat.shape
    gx = grid[..., 0]
    gy = grid[..., 1]
    if align_corners:
        x = (gx + 1.0) * 0.5 * (W - 1)
        y = (gy + 1.0) * 0.5 * (H - 1)
    else:
        x = ((gx + 1.0) * W - 1.0) * 0.5
        y = ((gy + 1.0) * H - 1.0) * 0.5
    return bilinear_sample(feat, torch.stack([x, y], dim=-1))
