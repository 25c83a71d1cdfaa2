"""PETR detection head: 3D position embedding + query decoder + branches.

Counterpart of `petr_tpu/models/petr_head.py` (reference
`models/dense_heads/petr_head.py:286-334,366-468`, sty61010/PETR), with the
reference's module names (``input_proj``, ``position_encoder``,
``adapt_pos3d``, ``query_embedding``, ``reference_points``,
``cls_branches``, ``reg_branches``, ``transformer``). Channels-last
(B, N, H, W, C) features; padding masks come from an ``img_hw`` array. The
3D PE stays fp32 up to ``position_encoder``; the decoder computes in
``dtype``. The cls/reg branches are one module applied at every decoder
layer (``shared_branches``, PETR's reference) or one per layer (PETRv2's
deep copies). The head has no dropout of its own: a training forward passes
the decoder layers' seeds through to the transformer. ``PETRv2Head``
(`models/petrv2_head.py`) extends it through ``_guide_pos_embed`` and
``_scale_velocity``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from petr_tpu_torch.models.layers import MLP, LayerNorm, Linear, PointwiseConv2d
from petr_tpu_torch.models.transformer import LayerSeeds, PETRTransformer
from petr_tpu_torch.ops.geometry import (
    inverse_sigmoid,
    pos2posemb3d,
    position_coords_3d,
    sine_posemb_2d_multiview,
)

FOCAL_PRIOR_BIAS = -4.59511985013459  # -log((1 - 0.01) / 0.01)
QUERY_POS_FEATS = 128  # pos2posemb3d's default: 3 * 128 query-embedding inputs


class PositionEncoder(MLP):
    """conv-MLP 3*D -> 4*C -> C over the frustum coordinate channels (1x1
    convs, applied per pixel on channels-last input)."""

    def __init__(self, in_channels: int, embed_dim: int = 256):
        super().__init__(in_channels, (embed_dim * 4, embed_dim), pointwise=True)


class NormedLinear(Linear):
    """mmdet's NormedLinear (petr_tpu `petr_head.py:56-81`), a cosine-style
    classifier: each output's weight row divided by its norm^power + eps,
    the features by theirs, (xn * tempearture) @ w + bias, all in fp32, the
    result in the input's dtype. The attribute keeps mmdet's spelling."""

    def __init__(self, in_features: int, out_features: int, tempearture: float = 20.0,
                 power: float = 1.0, eps: float = 1e-6):
        super().__init__(in_features, out_features)
        self.tempearture = tempearture
        self.power = power
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight / (self.weight.norm(dim=1, keepdim=True) ** self.power + self.eps)
        xf = x.float()
        xn = xf / (xf.norm(dim=-1, keepdim=True) ** self.power + self.eps)
        return F.linear(xn * self.tempearture, w, self.bias).to(x.dtype)


class ClsBranch(nn.Sequential):
    """(Linear+LN+ReLU) x num_reg_fcs + Linear(num_classes); children indexed
    as the reference's nn.Sequential (0, 1, 3, 4, 6 for two fcs). The last
    bias starts at the focal prior. ``normed`` makes the last layer a
    ``NormedLinear`` (the reference's ``normedlinear``), its bias at the
    focal prior too (`petr_head.py:282-284`)."""

    def __init__(self, embed_dim: int, num_reg_fcs: int, out: int, normed: bool = False):
        layers = []
        for _ in range(num_reg_fcs):
            layers += [Linear(embed_dim, embed_dim), LayerNorm(embed_dim), nn.ReLU()]
        layers.append((NormedLinear if normed else Linear)(embed_dim, out))
        super().__init__(*layers)
        with torch.no_grad():
            self[-1].bias.fill_(FOCAL_PRIOR_BIAS)


class RegBranch(nn.Sequential):
    """(Linear+ReLU) x num_reg_fcs + Linear(code_size)."""

    def __init__(self, embed_dim: int, num_reg_fcs: int, out: int):
        layers = []
        for _ in range(num_reg_fcs):
            layers += [Linear(embed_dim, embed_dim), nn.ReLU()]
        layers.append(Linear(embed_dim, out))
        super().__init__(*layers)


def branch_list(make: Callable[[], nn.Module], num_layers: int, shared: bool) -> nn.ModuleList:
    """One branch per decoder layer: the same module ``num_layers`` times
    (the reference PETR applies ONE branch at every layer,
    `petr_head.py:244-247`, and its state_dict lists it once per layer), or
    ``num_layers`` modules of their own (PETRv2's deep copies)."""
    if shared:
        return nn.ModuleList([make()] * num_layers)
    return nn.ModuleList(make() for _ in range(num_layers))


class PETRHead(nn.Module):
    def __init__(
        self,
        num_classes: int = 10,
        in_channels: int = 256,
        embed_dim: int = 256,
        num_query: int = 900,
        num_layers: int = 6,
        num_heads: int = 8,
        ffn_dim: int = 2048,
        num_reg_fcs: int = 2,
        code_size: int = 10,
        depth_num: int = 64,
        depth_start: float = 1.0,
        depth_mode: str = "LID",
        with_multiview: bool = True,
        position_range: Sequence[float] = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0),
        pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
        use_flash: bool = False,
        dtype: torch.dtype = torch.float32,
        dropout_rate: float = 0.0,
        remat: bool = False,
        shared_branches: bool = True,
        make_layer: Optional[Callable[[], nn.Module]] = None,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.depth_num = depth_num
        self.depth_start = depth_start
        self.depth_mode = depth_mode
        self.with_multiview = with_multiview
        self.position_range = tuple(position_range)
        self.pc_range = tuple(pc_range)
        self.dtype = dtype

        self.input_proj = PointwiseConv2d(in_channels, embed_dim)
        self.position_encoder = PositionEncoder(depth_num * 3, embed_dim)
        if with_multiview:
            self.adapt_pos3d = MLP(embed_dim * 3 // 2, (embed_dim * 4, embed_dim), pointwise=True)
        self.reference_points = nn.Embedding(num_query, 3)
        self.query_embedding = MLP(3 * QUERY_POS_FEATS, (embed_dim, embed_dim))
        self.transformer = PETRTransformer(
            num_layers, embed_dim, num_heads, ffn_dim, use_flash, dtype, dropout_rate, remat, make_layer
        )
        self.shared_branches = shared_branches
        self.cls_branches = branch_list(lambda: ClsBranch(embed_dim, num_reg_fcs, num_classes),
                                        num_layers, shared_branches)
        self.reg_branches = branch_list(lambda: RegBranch(embed_dim, num_reg_fcs, code_size),
                                        num_layers, shared_branches)

    def forward(
        self,
        feats: torch.Tensor,  # (B, N, H, W, Cin) — selected FPN level
        img2lidar: torch.Tensor,  # (B, N, 4, 4) fp32
        img_hw: torch.Tensor,  # (B, N, 2) valid (h, w) per view before padding
        pad_hw: Tuple[int, int],  # padded input (H, W)
        layer_seeds: Optional[Sequence[LayerSeeds]] = None,  # training only
        timestamp: Optional[torch.Tensor] = None,  # (B, N); read by PETRv2Head only
    ) -> Dict[str, torch.Tensor]:
        x, masks, pos_embed, query_embed = self._embed(feats, img2lidar, img_hw, pad_hw)
        outs_dec = self.transformer(x, masks, query_embed, pos_embed, layer_seeds)  # (L, B, Q, C)
        return self._predict(outs_dec, timestamp)

    def _embed(self, feats: torch.Tensor, img2lidar: torch.Tensor, img_hw: torch.Tensor,
               pad_hw: Tuple[int, int]) -> Tuple[torch.Tensor, ...]:
        """What the decoder reads: the projected features x (B, N, H, W, C),
        the padding masks (B, N, H, W), the keys' positional embedding
        (B, N, H, W, C) and the query embedding (Q, C)."""
        B, N, H, W, _ = feats.shape
        pad_h, pad_w = pad_hw
        dev = feats.device

        # padding masks at feature resolution (True = padded)
        ys = torch.arange(H, dtype=torch.float32, device=dev) * (pad_h / H)
        xs = torch.arange(W, dtype=torch.float32, device=dev) * (pad_w / W)
        img_hw = img_hw.float()
        valid_y = ys[None, None, :] < img_hw[..., 0:1]  # (B, N, H)
        valid_x = xs[None, None, :] < img_hw[..., 1:2]  # (B, N, W)
        masks = ~(valid_y[..., :, None] & valid_x[..., None, :])  # (B, N, H, W)

        x = self.input_proj(feats.to(self.dtype))

        # 3D position embedding, fp32 up to the encoder
        coords3d, _ = position_coords_3d(
            H, W, float(pad_h), float(pad_w), img2lidar, self.position_range,
            depth_num=self.depth_num, depth_start=self.depth_start,
            depth_mode=self.depth_mode,
        )
        pos_embed = self.position_encoder(inverse_sigmoid(coords3d).to(self.dtype))
        pos_embed = self._guide_pos_embed(pos_embed, x)
        if self.with_multiview:
            sin_embed = sine_posemb_2d_multiview(masks, num_feats=self.embed_dim // 2)
            pos_embed = pos_embed + self.adapt_pos3d(sin_embed.to(self.dtype))

        reference_points = self.reference_points.weight  # (Q, 3) fp32
        query_embed = self.query_embedding(
            pos2posemb3d(reference_points, QUERY_POS_FEATS).to(self.dtype)
        )
        return x, masks, pos_embed, query_embed

    def _predict(self, outs_dec: torch.Tensor, timestamp: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The decoder's (L, B, Q, C) outputs -> per-layer ``cls_logits`` and
        ``bbox_codes``, centres in metric pc_range."""
        outs_dec = torch.nan_to_num(outs_dec)
        ref = inverse_sigmoid(self.reference_points.weight)  # (Q, 3) fp32
        if self.shared_branches:  # one application over the stacked (L, B, Q, C) outputs
            all_cls = self.cls_branches[0](outs_dec).float()
            reg_out = self.reg_branches[0](outs_dec).float()
        else:  # layer l's own branches on layer l's output
            all_cls = torch.stack([b(o).float() for b, o in zip(self.cls_branches, outs_dec)])
            reg_out = torch.stack([b(o).float() for b, o in zip(self.reg_branches, outs_dec)])
        reg_out = self._scale_velocity(reg_out, timestamp)
        xy = torch.sigmoid(reg_out[..., 0:2] + ref[:, 0:2])
        z = torch.sigmoid(reg_out[..., 4:5] + ref[:, 2:3])

        # centers: de-normalize into metric pc_range
        pc = self.pc_range
        cx = xy[..., 0:1] * (pc[3] - pc[0]) + pc[0]
        cy = xy[..., 1:2] * (pc[4] - pc[1]) + pc[1]
        cz = z * (pc[5] - pc[2]) + pc[2]
        all_reg = torch.cat([cx, cy, reg_out[..., 2:4], cz, reg_out[..., 5:]], dim=-1)
        return {"cls_logits": all_cls, "bbox_codes": all_reg}

    def _guide_pos_embed(self, pos_embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The 3D PE as the decoder sees it: unchanged in PETR; PETRv2's
        feature-guided PE gates it by the projected features ``x``."""
        return pos_embed

    def _scale_velocity(self, reg_out: torch.Tensor, timestamp: Optional[torch.Tensor]) -> torch.Tensor:
        """The (L, B, Q, code_size) fp32 regression output before the centres
        are decoded: unchanged in PETR; PETRv2's ``with_time`` divides the
        velocity codes by the frames' time step."""
        return reg_out
