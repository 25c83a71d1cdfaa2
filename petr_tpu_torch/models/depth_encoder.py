"""Depth maps and the GT-depth encoder of the Depthr head (PyTorch).

Counterpart of `petr_tpu/models/depth_encoder.py` (reference, the
sty61010/PETR fork: `models/utils/depth_utils.py`,
`models/necks/depth_gt_encoder.py`, the painter of
`models/dense_heads/depthr_head.py:560-718`):
  * ``bin_depth_indices`` / ``lid_bin_values``: LID, UD or SID binning of
    metric depth, with an overflow bin at index ``num_bins`` for depths out
    of range or not finite; fp32 whatever the compute dtype.
  * ``gt_depth_maps``: per-camera GT depth maps at 1/``down_scale`` of the
    image. A pixel takes the centre depth of the nearest GT box whose
    projected 2D bbox covers it (petr_tpu's vectorised min-depth over
    covering boxes, equal to the reference's far-to-near painter). fp32,
    and the same bits on every device: the projections are elementwise
    products summed as ``(t0 + t1) + (t2 + t3)``, XLA's order on the CPU,
    rather than a matmul whose order depends on the library.
  * ``DepthGTEncoder``: one-hot depth maps -> depth tokens, a stack of
    stride-2 Conv2d(3x3) + GroupNorm(32) + ReLU in NCHW, plus a learned 1D
    depth embedding interpolated at the bin-weighted metric depth. Names
    follow the reference module: ``depth_head.{i}.0`` (conv), ``.1``
    (GroupNorm), ``depth_pos_embed.weight``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from petr_tpu_torch.models.layers import Conv2d
from petr_tpu_torch.ops.boxes import box_corners

BIG_DEPTH = 1e9  # "no box covers this pixel" while the nearest is taken


def bin_depth_indices(
    depth: torch.Tensor,
    mode: str = "LID",
    depth_min: float = 1e-3,
    depth_max: float = 60.0,
    num_bins: int = 80,
) -> torch.Tensor:
    """Metric depth -> int32 bin index; out of range or not finite ->
    ``num_bins``. The range test runs on the fractional index, before the
    truncation toward zero, as in petr_tpu. Every constant is a tensor on
    the input's device: CUDA turns a division by a CPU scalar into a
    product with its reciprocal, which rounds otherwise."""
    d = depth.float()

    def const(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=d.device)

    if mode == "UD":
        idx = (d - depth_min) / const((depth_max - depth_min) / num_bins)
    elif mode == "LID":
        bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        idx = -0.5 + 0.5 * torch.sqrt(1 + 8 * (d - depth_min) / const(bin_size))
    elif mode == "SID":
        span = math.log(1 + depth_max) - math.log(1 + depth_min)
        idx = num_bins * (torch.log(1 + d) - math.log(1 + depth_min)) / const(span)
    else:
        raise ValueError(f"depth binning mode must be UD, LID or SID, got {mode!r}")
    bad = (idx < 0) | (idx > num_bins) | ~torch.isfinite(idx)
    return torch.where(bad, num_bins, idx.to(torch.int32))


def lid_bin_values(num_bins: int, depth_min: float, depth_max: float,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """The LID bins' centre depths and the overflow bin's value, depth_max:
    (num_bins + 1,) fp32 (`depth_gt_encoder.py:44-48`)."""
    bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
    idx = torch.arange(num_bins, dtype=torch.float32, device=device)
    centers = (idx + 0.5) ** 2 * bin_size / 2 - bin_size / 8 + depth_min
    return torch.cat([centers, torch.tensor([depth_max], dtype=torch.float32, device=device)])


def _project(rows: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """rows (..., 4) . (x, y, z, 1) of points (..., 3), broadcast, summed as
    (t0 + t1) + (t2 + t3)."""
    t = [rows[..., j] * points[..., j] for j in range(3)]
    return (t[0] + t[1]) + (t[2] + rows[..., 3])


def gt_depth_maps(
    gt_boxes: torch.Tensor,  # (B, G, 9) gravity-center
    gt_valid: torch.Tensor,  # (B, G) bool
    lidar2img: torch.Tensor,  # (B, N, 4, 4)
    img_hw: Tuple[int, int],
    down_scale: int = 8,
) -> torch.Tensor:
    """Per-camera GT depth maps (B, N, img_h // down_scale, img_w //
    down_scale), fp32; 0 where no box covers a pixel.

    A box counts in a camera when one of its corners projects inside the
    image at a depth above 1 and all of them lie in front (depth above
    0.1); it covers the pixels of the floored bbox of its projected
    corners, clipped to the map."""
    img_h, img_w = img_hw
    h, w = img_h // down_scale, img_w // down_scale
    boxes = gt_boxes.float()
    P = lidar2img.float()[:, :, None, None, :3]  # (B, N, 1, 1, 3, 4)
    corners = box_corners(boxes)[:, None, :, :, None]  # (B, 1, G, 8, 1, 3)
    uvd = _project(P, corners)  # (B, N, G, 8, 3)
    cdepth = _project(P[:, :, :, 0, 2], boxes[:, None, :, :3])  # (B, N, G)

    depth_c = uvd[..., 2]
    uv = uvd[..., :2] / (uvd[..., 2:3] + 1e-8)
    visible = ((uv[..., 0] > 0) & (uv[..., 0] < img_w) & (uv[..., 1] > 0) & (uv[..., 1] < img_h)
               & (depth_c > 1.0))
    keep = visible.any(-1) & (depth_c > 0.1).all(-1) & gt_valid.bool()[:, None, :]  # (B, N, G)

    uv = uv / down_scale  # a power of two: exact
    u = uv[..., 0].clamp(0, w)
    v = uv[..., 1].clamp(0, h)
    x0, x1 = u.amin(-1).floor(), u.amax(-1).floor()
    y0, y1 = v.amin(-1).floor(), v.amax(-1).floor()
    xs = torch.arange(w, dtype=torch.float32, device=u.device)
    ys = torch.arange(h, dtype=torch.float32, device=u.device)
    cov_x = (xs >= x0[..., None]) & (xs < x1[..., None])  # (B, N, G, w)
    cov_y = (ys >= y0[..., None]) & (ys < y1[..., None])  # (B, N, G, h)
    covered = cov_y[..., :, None] & cov_x[..., None, :] & keep[..., None, None]  # (B, N, G, h, w)

    depth_per_box = torch.where(keep, cdepth, BIG_DEPTH)[..., None, None]
    depth_map = torch.where(covered, depth_per_box, BIG_DEPTH).amin(2)  # (B, N, h, w)
    return torch.where(depth_map >= BIG_DEPTH, 0.0, depth_map)


class GroupNorm(nn.GroupNorm):
    """GroupNorm with statistics in fp32 and the output in the input's dtype
    (flax's ``nn.GroupNorm(dtype=...)``); eps 1e-5 as torch's, which
    petr_tpu sets to match."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)


class DepthGTEncoder(nn.Module):
    """One-hot depth maps (B, N, h, w, D + 1) in the compute dtype ->
    (depth tokens (B, N, h', w', C) in that dtype, the weighted metric depth (B, N, h', w') fp32),
    h' = h / down_scale (petr_tpu's ``DepthGTEncoder``,
    `depth_encoder.py:118-170`)."""

    def __init__(self, num_bins: int = 80, depth_min: float = 1e-3, depth_max: float = 60.0,
                 embed_dim: int = 256, down_scale: int = 4):
        super().__init__()
        self.num_bins, self.depth_min, self.depth_max = num_bins, depth_min, depth_max
        self.down_scale = down_scale
        n_layers = 1 + int(math.log2(down_scale) - 1)
        cin = num_bins + 1
        self.depth_head = nn.ModuleList()
        for _ in range(n_layers):
            self.depth_head.append(nn.Sequential(
                Conv2d(cin, embed_dim, 3, 2, 1), GroupNorm(32, embed_dim, eps=1e-5), nn.ReLU(),
            ))
            cin = embed_dim
        self.depth_pos_embed = nn.Embedding(int(depth_max) + 1, embed_dim)

    def forward(self, depth_onehot: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, N, h, w, D1 = depth_onehot.shape
        x = depth_onehot.reshape(B * N, h, w, D1).permute(0, 3, 1, 2)
        for stage in self.depth_head:
            x = stage(x)
        C, hp, wp = x.shape[1:]

        # the bin-weighted metric depth at the nearest-downsampled positions
        bins = lid_bin_values(self.num_bins, self.depth_min, self.depth_max, depth_onehot.device)
        stride = self.down_scale
        probs = depth_onehot.float()[:, :, ::stride, ::stride, :]
        weighted = (probs * bins).sum(-1)  # (B, N, h', w')

        # the depth embedding, linear between floor and floor + 1; its
        # backward is advanced indexing's sorted index_put_ (a fixed order
        # on CUDA, no atomics)
        emb = self.depth_pos_embed.weight
        d = weighted.clamp(0.0, self.depth_max)
        lo = d.floor()
        delta = (d - lo)[..., None]
        lo_i = lo.long()
        hi_i = (lo_i + 1).clamp(max=emb.shape[0] - 1)
        pe = emb[lo_i] * (1 - delta) + emb[hi_i] * delta  # (B, N, h', w', C)

        tokens = x.permute(0, 2, 3, 1).reshape(B, N, hp, wp, C) + pe.to(x.dtype)
        return tokens, weighted
