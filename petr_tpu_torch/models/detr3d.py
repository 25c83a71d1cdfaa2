"""DETR3D: the projective point-sampling decoder (PyTorch).

Counterpart of `petr_tpu/models/detr3d.py` (reference
`models/utils/detr3d_transformer.py` and `models/dense_heads/
detr3d_head.py`, sty61010/PETR). Each query's 3D reference point is
denormalised into ``pc_range``, projected into every camera by
``lidar2img`` and bilinearly sampled once per (camera, level); the samples
are weighted by sigmoid weights predicted from the query, masked where the
point is behind the camera or off the image, summed over cameras and
levels, output-projected, and a reference-point embedding is added. Boxes
are refined layer by layer: each layer's xy and z offsets move the
references, which enter the next layer detached.

Module and parameter names are petr_tpu's (``query_embedding``,
``reference_points``, ``input_proj{i}``, ``layer{l}``, ``cls_branch_{l}``,
...), so that ``utils.convert.state_dict_from_jax`` carries its params
across; the initial draws are petr_tpu's. Features come channels-last per
level, (B, N, H, W, C_l); the decoder computes in ``dtype``, the sampling
and the reference points in fp32. In train mode the dropouts draw from the
``generator`` the caller passes.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from petr_tpu_torch.models.dgcnn import _denormalize_codes, _drop
from petr_tpu_torch.models.layers import LayerNorm, Linear, dense, xavier_attention, xavier_ffn
from petr_tpu_torch.models.petr_head import ClsBranch, RegBranch
from petr_tpu_torch.ops.geometry import inverse_sigmoid
from petr_tpu_torch.ops.sampling import grid_sample_normalized_batched

PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


def project_reference_points(
    ref: torch.Tensor,  # (B, Q, 3) in [0, 1]
    lidar2img: torch.Tensor,  # (B, N, 4, 4)
    pc_range: Sequence[float],
    img_hw: Tuple[float, float],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The references in every camera -> (uv (B, N, Q, 2) normalized to
    [-1, 1], visible (B, N, Q)): in front of the camera (depth above 1e-5,
    the divisor clamped there) and inside the image
    (`detr3d_transformer.py:389-430`)."""
    pc = torch.tensor(pc_range, dtype=torch.float32, device=ref.device)
    pts = ref * (pc[3:6] - pc[0:3]) + pc[0:3]
    hom = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)  # (B, Q, 4)
    cam = torch.einsum("bnij,bqj->bnqi", lidar2img.float(), hom)
    eps = 1e-5
    depth = cam[..., 2:3]
    visible = depth[..., 0] > eps
    uv = cam[..., :2] / depth.clamp(min=eps)
    h, w = img_hw
    uv = uv / torch.tensor([w, h], dtype=torch.float32, device=ref.device)
    uv = (uv - 0.5) * 2.0
    inb = (uv > -1.0).all(-1) & (uv < 1.0).all(-1)
    return uv, visible & inb


class Detr3DCrossAtten(nn.Module):
    """`detr3d_transformer.py:226-386`: one sample per (camera, level) at
    each query's projected reference point."""

    def __init__(self, embed_dim: int = 256, num_cams: int = 6, num_levels: int = 4,
                 pc_range: Sequence[float] = PC_RANGE, dropout_rate: float = 0.1):
        super().__init__()
        self.num_cams, self.num_levels = num_cams, num_levels
        self.pc_range = tuple(pc_range)
        self.dropout_rate = dropout_rate
        # the reference zero-inits the weight predictor (`:306-308`) and
        # Xavier-inits output_proj with a zero bias
        self.attention_weights = dense(embed_dim, num_cams * num_levels, kernel="zeros")
        self.output_proj = dense(embed_dim, embed_dim, kernel="xavier")
        # Detr3DTransformer's per-parameter Xavier pass (`:73-77`) covers
        # these kernels; their biases keep torch's defaults
        for i, fan_in in enumerate((3, embed_dim)):
            fc = Linear(fan_in, embed_dim)
            nn.init.xavier_uniform_(fc.weight)
            self.add_module(f"pos_fc{i}", fc)
            self.add_module(f"pos_ln{i}", LayerNorm(embed_dim))

    def forward(
        self,
        query: torch.Tensor,  # (B, Q, C)
        query_pos: torch.Tensor,  # (B, Q, C)
        feats: Sequence[torch.Tensor],  # per level (B, N, H, W, C)
        reference_points: torch.Tensor,  # (B, Q, 3)
        lidar2img: torch.Tensor,  # (B, N, 4, 4)
        img_hw: Tuple[float, float],
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        B, Q, C = query.shape
        N, L = feats[0].shape[1], len(feats)
        weights = torch.sigmoid(self.attention_weights(query + query_pos).float()).reshape(B, Q, N, L)
        uv, mask = project_reference_points(reference_points, lidar2img, self.pc_range, img_hw)
        grid = uv.reshape(B * N, Q, 2)
        samp = torch.stack([
            grid_sample_normalized_batched(f.float().reshape(B * N, *f.shape[2:]), grid).reshape(B, N, Q, C)
            for f in feats
        ], dim=3)  # (B, N, Q, L, C)
        w = weights.permute(0, 2, 1, 3)[..., None] * mask[..., None, None].float()
        out = (samp * w).sum(dim=(1, 3))  # (B, Q, C)
        rate = self.dropout_rate if self.training else 0.0
        out = _drop(self.output_proj(out.to(query.dtype)), rate, generator)
        pe = inverse_sigmoid(reference_points).to(query.dtype)
        for i in range(2):
            pe = torch.relu(getattr(self, f"pos_ln{i}")(getattr(self, f"pos_fc{i}")(pe)))
        return out + query + pe


class Detr3DDecoderLayer(nn.Module):
    """self_attn -> norm1 -> cross_attn (with its residual) -> norm2 ->
    ffn -> norm3 (`petr_tpu/models/detr3d.py:125-157`)."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8, ffn_dim: int = 512, num_cams: int = 6,
                 num_levels: int = 4, pc_range: Sequence[float] = PC_RANGE, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = xavier_attention(embed_dim, num_heads, dropout_rate)
        self.norm1 = LayerNorm(embed_dim)
        self.cross_attn = Detr3DCrossAtten(embed_dim, num_cams, num_levels, pc_range, dropout_rate)
        self.norm2 = LayerNorm(embed_dim)
        self.ffn = xavier_ffn(embed_dim, ffn_dim, dropout_rate)
        self.norm3 = LayerNorm(embed_dim)

    def forward(self, query, query_pos, feats, reference_points, lidar2img, img_hw,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.dropout_rate if self.training else 0.0
        q_in = query + query_pos
        sa = self.self_attn(q_in, q_in, query, generator=generator)
        query = self.norm1(query + _drop(sa, rate, generator))
        query = self.norm2(self.cross_attn(query, query_pos, feats, reference_points, lidar2img, img_hw, generator))
        return self.norm3(query + self.ffn(query, generator=generator))


class Detr3DHead(nn.Module):
    """DETR3D's head with iterative box refinement
    (`petr_tpu/models/detr3d.py:160-237`): 900 learned query embeddings of
    2C split into (query_pos, query), references sigmoid(Linear(query_pos)),
    a Linear input projection per level, ``num_layers`` decoder layers, and
    per layer its own cls/reg branches (``with_box_refine``; petr_tpu's
    False would name one branch per layer alike, which flax refuses, so
    only the refining head exists). Returns
    ``cls_logits`` (L, B, Q, classes) and ``bbox_codes`` (L, B, Q, code),
    centres in metric ``pc_range``, both fp32."""

    def __init__(
        self,
        num_classes: int = 10,
        in_channels: Sequence[int] = (256, 256, 256, 256),
        embed_dim: int = 256,
        num_query: int = 900,
        num_layers: int = 6,
        num_heads: int = 8,
        ffn_dim: int = 512,
        num_reg_fcs: int = 2,
        code_size: int = 10,
        num_cams: int = 6,
        pc_range: Sequence[float] = PC_RANGE,
        dropout_rate: float = 0.1,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        C = embed_dim
        self.num_layers = num_layers
        self.pc_range = tuple(pc_range)
        self.dtype = dtype
        self.query_embedding = nn.Parameter(torch.randn(num_query, 2 * C))
        self.reference_points = dense(C, 3, kernel="xavier")  # Detr3DTransformer.init_weights (`:117-124`)
        for i, cin in enumerate(in_channels):
            self.add_module(f"input_proj{i}", Linear(cin, C))
        for lvl in range(num_layers):
            self.add_module(f"layer{lvl}", Detr3DDecoderLayer(C, num_heads, ffn_dim, num_cams, len(in_channels),
                                                               pc_range, dropout_rate))
        for lvl in range(num_layers):
            self.add_module(f"cls_branch_{lvl}", ClsBranch(C, num_reg_fcs, num_classes))
            self.add_module(f"reg_branch_{lvl}", RegBranch(C, num_reg_fcs, code_size))

    def forward(
        self,
        feats: Sequence[torch.Tensor],  # per level (B, N, H, W, C_l)
        lidar2img: torch.Tensor,  # (B, N, 4, 4)
        pad_hw: Tuple[int, int],
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        B = feats[0].shape[0]
        query_pos, query = self.query_embedding.to(self.dtype).chunk(2, dim=-1)
        Q, C = query.shape
        query_pos = query_pos[None].expand(B, Q, C)
        query = query[None].expand(B, Q, C)
        ref = torch.sigmoid(self.reference_points(query_pos.float()))  # (B, Q, 3)
        proj = [getattr(self, f"input_proj{i}")(f.to(self.dtype)) for i, f in enumerate(feats)]

        cls_list, reg_list = [], []
        for lvl in range(self.num_layers):
            query = getattr(self, f"layer{lvl}")(query, query_pos, proj, ref.detach(), lidar2img, pad_hw, generator)
            cls_out = getattr(self, f"cls_branch_{lvl}")(query)
            reg_out = getattr(self, f"reg_branch_{lvl}")(query).float()
            ref_is = inverse_sigmoid(ref)
            xy = torch.sigmoid(reg_out[..., 0:2] + ref_is[..., 0:2])
            z = torch.sigmoid(reg_out[..., 4:5] + ref_is[..., 2:3])
            cls_list.append(cls_out.float())
            reg_list.append(torch.cat([xy, reg_out[..., 2:4], z, reg_out[..., 5:]], -1))
            # the next layer's references: this layer's centres (detached
            # where the next layer reads them, as petr_tpu's stop_gradient)
            ref = torch.cat([xy, z], -1)
        return {"cls_logits": torch.stack(cls_list),
                "bbox_codes": _denormalize_codes(torch.stack(reg_list), self.pc_range)}
