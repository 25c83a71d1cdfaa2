"""Camera-frustum geometry and positional-embedding primitives (PyTorch).

Counterpart of `petr_tpu/ops/geometry.py`: the same math of the reference
PETR head (`projects/mmdet3d_plugin/models/dense_heads/petr_head.py:31-43,
286-334` and `models/utils/positional_encoding.py:15-110` in sty61010/PETR),
channels-last, fp32 throughout.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

TWO_PI = 2.0 * math.pi


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Numerically-clamped logit; matches mmdet's ``inverse_sigmoid``."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def _dim_t(num_feats: int, temperature: float, device) -> torch.Tensor:
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=device)
    return temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)


def _sincos_interleave(pos: torch.Tensor, num_feats: int, temperature: float) -> torch.Tensor:
    """out[..., 2k] = sin(pos / t^(2k/F)), out[..., 2k+1] = cos(pos / t^(2k/F))."""
    ang = pos[..., None] / _dim_t(num_feats, temperature, pos.device)
    return torch.stack([ang[..., 0::2].sin(), ang[..., 1::2].cos()], dim=-1).flatten(-2)


def _sincos_block(pos: torch.Tensor, num_feats: int, temperature: float) -> torch.Tensor:
    """BLOCK order [sin(pos/t_k) for k | cos(pos/t_k) for k], which is what the
    reference's ``SinePositionalEncoding3D`` emits (`positional_encoding.py:90-99`)."""
    ang = pos[..., None] / _dim_t(num_feats, temperature, pos.device)
    return torch.cat([ang[..., 0::2].sin(), ang[..., 1::2].cos()], dim=-1)


def pos2posemb3d(
    pos: torch.Tensor, num_pos_feats: int = 128, temperature: float = 10000.0
) -> torch.Tensor:
    """Sinusoidal embedding of normalized 3D points (..., 3) in [0, 1].

    Returns (..., 3*num_pos_feats), ordered (y, x, z) with sin/cos
    interleaved — the reference's channel order (`petr_head.py:42`).
    """
    pos = pos.float() * TWO_PI
    emb_x = _sincos_interleave(pos[..., 0], num_pos_feats, temperature)
    emb_y = _sincos_interleave(pos[..., 1], num_pos_feats, temperature)
    emb_z = _sincos_interleave(pos[..., 2], num_pos_feats, temperature)
    return torch.cat([emb_y, emb_x, emb_z], dim=-1)


def depth_bins(
    depth_num: int,
    depth_start: float,
    depth_max: float,
    mode: str = "LID",
    device=None,
) -> torch.Tensor:
    """Depth-bin centers along the camera ray.

    LID: d_i = start + bin * i * (i+1),  bin = (max-start) / (D*(D+1))
    UD:  d_i = start + i * (max-start)/D
    """
    index = torch.arange(depth_num, dtype=torch.float32, device=device)
    if mode == "LID":
        bin_size = (depth_max - depth_start) / (depth_num * (1 + depth_num))
        return depth_start + bin_size * index * (index + 1.0)
    if mode == "UD":
        bin_size = (depth_max - depth_start) / depth_num
        return depth_start + bin_size * index
    raise ValueError(f"unknown depth mode {mode!r}")


def frustum_coords(
    feat_h: int,
    feat_w: int,
    pad_h: float,
    pad_w: float,
    coords_d: torch.Tensor,
) -> torch.Tensor:
    """Per-pixel homogeneous frustum points, shape (H, W, D, 4).

    Pixel (h, w) maps to image coords (w * pad_w / W, h * pad_h / H): the
    reference samples at index*stride, not at pixel centers
    (`petr_head.py:290-291`). The point is (u*d, v*d, d, 1), d clamped below
    by eps where it multiplies into uv.
    """
    eps = 1e-5
    dev = coords_d.device
    coords_h = torch.arange(feat_h, dtype=torch.float32, device=dev) * (pad_h / feat_h)
    coords_w = torch.arange(feat_w, dtype=torch.float32, device=dev) * (pad_w / feat_w)
    d = coords_d.float()
    D = d.shape[0]
    u = coords_w[None, :, None]
    v = coords_h[:, None, None]
    dmul = d.clamp(min=eps)[None, None, :]
    shape = (feat_h, feat_w, D)
    uu = (u * dmul).expand(shape)
    vv = (v * dmul).expand(shape)
    dd = d[None, None, :].expand(shape)
    return torch.stack([uu, vv, dd, torch.ones(shape, device=dev)], dim=-1)


def backproject_frustum(coords: torch.Tensor, img2lidar: torch.Tensor) -> torch.Tensor:
    """(H, W, D, 4) frustum points through (..., 4, 4) img2lidar -> (..., H, W, D, 3)."""
    pts = torch.einsum("...ij,hwdj->...hwdi", img2lidar.float(), coords)
    return pts[..., :3]


def position_coords_3d(
    feat_h: int,
    feat_w: int,
    pad_h: float,
    pad_w: float,
    img2lidar: torch.Tensor,
    position_range: Tuple[float, float, float, float, float, float],
    depth_num: int = 64,
    depth_start: float = 1.0,
    depth_mode: str = "LID",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized 3D coords per feature pixel + out-of-range mask.

    Args:
        img2lidar: (B, N, 4, 4).
    Returns:
        coords3d: (B, N, H, W, D*3) fp32, depth outermost and axis fastest
            (the reference's ``permute(0,1,4,5,3,2)`` flatten).
        oob_mask: (B, N, H, W) bool, True where more than half of the D*3
            values fall outside [0, 1].
    """
    dev = img2lidar.device
    pr = torch.tensor(position_range, dtype=torch.float32, device=dev)
    coords_d = depth_bins(depth_num, depth_start, float(position_range[3]), depth_mode, dev)
    coords = frustum_coords(feat_h, feat_w, pad_h, pad_w, coords_d)
    pts = backproject_frustum(coords, img2lidar)  # (B, N, H, W, D, 3)
    pts = (pts - pr[0:3]) / (pr[3:6] - pr[0:3])
    out = (pts > 1.0) | (pts < 0.0)
    D = coords_d.shape[0]
    oob_mask = out.flatten(-2).sum(-1) > (D * 0.5)
    return pts.flatten(-2), oob_mask


def sine_posemb_2d_multiview(
    masks: torch.Tensor,
    num_feats: int = 128,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float = TWO_PI,
    eps: float = 1e-6,
    offset: float = 0.0,
) -> torch.Tensor:
    """Camera-aware 2D sine positional encoding (SinePositionalEncoding3D).

    Args:
        masks: (B, N, H, W) bool/int; nonzero = padded/ignored position.
    Returns:
        (B, N, H, W, 3*num_feats) fp32, channel order (n, y, x), each axis in
        the reference's block order [sins | coss].
    """
    not_mask = 1.0 - masks.float()
    n_embed = not_mask.cumsum(1)
    y_embed = not_mask.cumsum(2)
    x_embed = not_mask.cumsum(3)
    if normalize:
        n_embed = (n_embed + offset) / (n_embed[:, -1:, :, :] + eps) * scale
        y_embed = (y_embed + offset) / (y_embed[:, :, -1:, :] + eps) * scale
        x_embed = (x_embed + offset) / (x_embed[:, :, :, -1:] + eps) * scale
    return torch.cat(
        [_sincos_block(e, num_feats, temperature) for e in (n_embed, y_embed, x_embed)],
        dim=-1,
    )
