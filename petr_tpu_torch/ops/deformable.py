"""Multi-scale deformable attention (PyTorch).

Counterpart of `petr_tpu/ops/deformable.py` (mmcv's
``MultiScaleDeformableAttention``, as the reference's deformable-DETR
decoder, `models/utils/detr.py:34-115`, and the DGCNN3D configs use it).
Each query predicts, per (head, level, point), a sampling offset around its
reference location, in pixels of that level, and an attention weight,
softmax-normalised in fp32 over levels x points; the output is the
weighted sum of bilinear samples of the projected values. The base point is
``ref * [W, H] - 0.5`` (align_corners False).

The samples are the port's ``bilinear_sample_batched`` over (batch, head)
pairs, whose backward sums each pixel's gradient in a fixed order on CUDA
(``ops.sampling.gather_rows``), so two identical backward passes give the
same bits. No TPU kernel computes this (petr_tpu's are XLA gathers), and
none is written here: plain PyTorch on every device.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from petr_tpu_torch.models.layers import Linear, dense
from petr_tpu_torch.ops.sampling import bilinear_sample_batched


def ms_deformable_attention(
    value_levels: Sequence[torch.Tensor],  # per level (B, H_l, W_l, nh, dh)
    ref_points: torch.Tensor,  # (B, Q, 2) normalized [0, 1] (x, y)
    offsets: torch.Tensor,  # (B, Q, nh, L, P, 2) in pixels of each level
    weights: torch.Tensor,  # (B, Q, nh, L, P) softmax-normalized over (L, P)
) -> torch.Tensor:
    """-> (B, Q, nh, dh)."""
    B, Q, nh, L, P, _ = offsets.shape
    out = 0
    for lvl, val in enumerate(value_levels):
        _, H, W, _, dh = val.shape
        scale = torch.tensor([W, H], dtype=torch.float32, device=ref_points.device)
        base = ref_points * scale - 0.5  # align_corners=False
        xy = base[:, :, None, None, :] + offsets[:, :, :, lvl]  # (B, Q, nh, P, 2)
        feat = val.permute(0, 3, 1, 2, 4).reshape(B * nh, H, W, dh)
        pts = xy.permute(0, 2, 1, 3, 4).reshape(B * nh, Q * P, 2)
        s = bilinear_sample_batched(feat, pts).reshape(B, nh, Q, P, dh).permute(0, 2, 1, 3, 4)
        out = out + torch.einsum("bqhpd,bqhp->bqhd", s, weights[:, :, :, lvl])
    return out


def deformable_attention_module_forward(
    query: torch.Tensor,  # (B, Q, C)
    value_levels: Sequence[torch.Tensor],  # per level (B, H_l, W_l, C)
    ref_points: torch.Tensor,  # (B, Q, 2)
    *,
    sampling_offsets_w: torch.Tensor,  # (C, nh*L*P*2)
    sampling_offsets_b: torch.Tensor,
    attn_weights_w: torch.Tensor,  # (C, nh*L*P)
    attn_weights_b: torch.Tensor,
    value_proj_w: torch.Tensor,  # (C, C)
    value_proj_b: torch.Tensor,
    out_proj_w: torch.Tensor,
    out_proj_b: torch.Tensor,
    num_heads: int,
    num_points: int,
) -> torch.Tensor:
    """mmcv's module wiring (value projection, offset and weight heads,
    output projection) as a function of explicit parameters, in
    petr_tpu's layout: kernels (in, out), as ``x @ w + b``."""
    B, Q, C = query.shape
    L, nh, P = len(value_levels), num_heads, num_points
    dh = C // nh
    off = (query @ sampling_offsets_w + sampling_offsets_b).reshape(B, Q, nh, L, P, 2)
    w = (query @ attn_weights_w + attn_weights_b).reshape(B, Q, nh, L * P)
    w = torch.softmax(w.float(), -1).reshape(B, Q, nh, L, P)
    vals = []
    for v in value_levels:
        _, H, W, _ = v.shape
        vals.append((v.reshape(B, H * W, C) @ value_proj_w + value_proj_b).reshape(B, H, W, nh, dh))
    out = ms_deformable_attention(vals, ref_points, off.float(), w)
    return out.reshape(B, Q, C) @ out_proj_w + out_proj_b


def _grid_offset_bias_init(num_heads: int, num_levels: int, num_points: int) -> torch.Tensor:
    """mmcv's offset-bias init: each head's unit direction on a ring
    (scaled so its larger coordinate is 1), times point index + 1 ->
    (num_heads * num_levels * num_points * 2,) fp32."""
    thetas = torch.arange(num_heads, dtype=torch.float32) * (2.0 * math.pi / num_heads)
    grid = torch.stack([torch.cos(thetas), torch.sin(thetas)], -1)  # (nh, 2)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, num_levels, num_points, 1)
    scale = torch.arange(1, num_points + 1, dtype=torch.float32)[None, None, :, None]
    return (grid * scale).reshape(-1)


class MSDeformableAttention(nn.Module):
    """mmcv's ``MultiScaleDeformableAttention`` as petr_tpu's module
    (`deformable.py:105-154`): ``sampling_offsets`` and
    ``attention_weights`` with zero kernels (the offsets' bias the ring
    init) computing in fp32, ``value_proj`` and ``out_proj`` in the
    input's dtype. Call with per-level channels-last value maps
    (B, H_l, W_l, C) and normalized (x, y) reference points."""

    def __init__(self, embed_dim: int, num_heads: int = 8, num_points: int = 4, num_levels: int = 1):
        super().__init__()
        self.embed_dim, self.num_heads, self.num_points, self.num_levels = embed_dim, num_heads, num_points, num_levels
        self.sampling_offsets = dense(embed_dim, num_heads * num_levels * num_points * 2, kernel="zeros")
        self.attention_weights = dense(embed_dim, num_heads * num_levels * num_points, kernel="zeros")
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(_grid_offset_bias_init(num_heads, num_levels, num_points))
        self.value_proj: Linear = dense(embed_dim, embed_dim)
        self.out_proj: Linear = dense(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, value_levels: Sequence[torch.Tensor],
                ref_points: torch.Tensor) -> torch.Tensor:
        B, Q, C = query.shape
        nh, P, L = self.num_heads, self.num_points, len(value_levels)
        if L != self.num_levels:
            raise ValueError(f"{L} value levels given, the module was built for {self.num_levels}")
        qf = query.float()
        off = self.sampling_offsets(qf).reshape(B, Q, nh, L, P, 2)
        w = torch.softmax(self.attention_weights(qf).reshape(B, Q, nh, L * P), -1).reshape(B, Q, nh, L, P)
        vals = []
        for v in value_levels:
            _, H, W, _ = v.shape
            vals.append(self.value_proj(v.reshape(B, H * W, C)).float().reshape(B, H, W, nh, C // nh))
        out = ms_deformable_attention(vals, ref_points.float(), off, w)
        return self.out_proj(out.reshape(B, Q, C).to(query.dtype))
