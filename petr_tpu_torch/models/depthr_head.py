"""Depthr head: PETR with depth-map-guided cross-attention (PyTorch).

Counterpart of `petr_tpu/models/depthr_head.py` (reference, the
sty61010/PETR fork's research extension: `models/dense_heads/depthr_head.py`,
`models/utils/multi_atten_decoder_layer.py`), built on the port's
``PETRHead``: the same input projection, 3D and sine PEs, queries, branches
and centre decoding, with a decoder of ``DepthrDecoderLayer`` and a depth
branch. GT boxes are painted into per-camera depth maps at stride
``depth_map_down_scale`` (``gt_depth_maps``), LID-binned into one-hot maps
and encoded into depth tokens (``DepthGTEncoder``, stride
``depth_encoder_down_scale``) on the feature grid, so the image padding
mask applies to them too. The GT boxes are inputs at test time as well (an
oracle experiment), so the head has no serving path.

Each decoder layer runs self-attention, ``cross_depth_attn``,
``cross_view_attn`` and the FFN, each followed by a post-norm. With
``attend_memory=False`` (the reference's graph and every preset's) both
cross-attentions attend over the depth tokens: the reference's
``cross_depth_attn`` rebinds key = value = depth tokens, and the
``cross_view_attn`` after it keeps them, with the image PE as its key PE
(`tests/test_torch_parity_depthr.py:137-180`). The image features then
reach no output. The attention is the plain branch, as in petr_tpu, whose
Depthr layers never set ``use_flash``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from petr_tpu_torch.models.depth_encoder import DepthGTEncoder, bin_depth_indices, gt_depth_maps
from petr_tpu_torch.models.layers import FFN, LayerNorm, MultiheadAttention, dropout
from petr_tpu_torch.models.petr_head import PETRHead
from petr_tpu_torch.models.transformer import LayerSeeds, layer_noise
from petr_tpu_torch.parallel.sharded_attention import KeyShard


class DepthrDecoderLayer(nn.Module):
    """self_attn -> norm -> cross_depth_attn -> norm -> cross_view_attn ->
    norm -> ffn -> norm (`petr_tpu/models/depthr_head.py:40-117`). Names
    follow mmdet3d's decoder layer: ``attentions.{0,1,2}`` (self, depth,
    view), ``norms.{0..3}``, ``ffns.0``. In train mode each attention drops
    its probabilities and its output, and the FFN its two, all drawn from
    the layer's generator (``layer_noise``)."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8, ffn_dim: int = 2048,
                 dropout_rate: float = 0.0, attend_memory: bool = False):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.attend_memory = attend_memory
        self.attentions = nn.ModuleList(
            MultiheadAttention(embed_dim, num_heads, dropout_rate=dropout_rate) for _ in range(3)
        )
        self.ffns = nn.ModuleList([FFN(embed_dim, ffn_dim, dropout_rate)])
        self.norms = nn.ModuleList(LayerNorm(embed_dim) for _ in range(4))

    def forward(
        self,
        query: torch.Tensor,  # (B, Q, C)
        memory: torch.Tensor,  # (B, L, C) image tokens, read only with attend_memory
        query_pos: torch.Tensor,  # (B, Q, C)
        key_pos: torch.Tensor,  # (B, L, C) the image PE
        key_padding_mask: Optional[torch.Tensor],  # (B, L) True = pad
        seeds: Optional[LayerSeeds],
        depth: torch.Tensor,  # (B, L, C) depth tokens
        key_shard: Optional[KeyShard] = None,  # memory and depth are this rank's slice of the keys
    ) -> torch.Tensor:
        rate, _, gen = layer_noise(self, seeds, query.device)

        def residual(i: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
            return self.norms[i](x + (dropout(y, rate, gen) if rate > 0.0 else y))

        q_in = query + query_pos
        query = residual(0, query, self.attentions[0](q_in, q_in, query, generator=gen))
        # the depth tokens are the keys, the values and the keys' PE
        da = self.attentions[1](query + query_pos, depth + depth, depth,
                                key_padding_mask=key_padding_mask, generator=gen, key_shard=key_shard)
        query = residual(1, query, da)
        kv = memory if self.attend_memory else depth
        ca = self.attentions[2](query + query_pos, kv + key_pos, kv,
                                key_padding_mask=key_padding_mask, generator=gen, key_shard=key_shard)
        query = residual(2, query, ca)
        return self.norms[3](query + self.ffns[0](query, generator=gen))


class DepthrHead(PETRHead):
    """``PETRHead`` with the Depthr decoder and its depth branch
    (`petr_tpu/models/depthr_head.py:120-283`). The forward takes the
    oracle inputs ``gt_boxes`` (B, G, 9, gravity centre), ``gt_valid``
    (B, G) and ``lidar2img`` (B, N, 4, 4) as keywords, and raises without
    them. ``use_flash`` is accepted and unused."""

    def __init__(
        self,
        embed_dim: int = 256,
        num_heads: int = 8,
        ffn_dim: int = 2048,
        dropout_rate: float = 0.0,
        depth_bins: int = 80,
        depth_map_min: float = 1e-3,
        depth_map_max: float = 60.0,
        depth_map_down_scale: int = 8,
        depth_encoder_down_scale: int = 4,
        attend_memory: bool = False,
        **kwargs,
    ):
        def make_layer() -> DepthrDecoderLayer:
            return DepthrDecoderLayer(embed_dim, num_heads, ffn_dim, dropout_rate, attend_memory)

        super().__init__(embed_dim=embed_dim, num_heads=num_heads, ffn_dim=ffn_dim,
                         dropout_rate=dropout_rate, make_layer=make_layer, **kwargs)
        self.depth_bins = depth_bins
        self.depth_map_min, self.depth_map_max = depth_map_min, depth_map_max
        self.depth_map_down_scale = depth_map_down_scale
        self.depth_gt_encoder = DepthGTEncoder(depth_bins, depth_map_min, depth_map_max, embed_dim,
                                               depth_encoder_down_scale)

    def forward(
        self,
        feats: torch.Tensor,  # (B, N, H, W, Cin)
        img2lidar: torch.Tensor,  # (B, N, 4, 4)
        img_hw: torch.Tensor,  # (B, N, 2)
        pad_hw: Tuple[int, int],
        layer_seeds: Optional[Sequence[LayerSeeds]] = None,
        timestamp: Optional[torch.Tensor] = None,
        *,
        gt_boxes: Optional[torch.Tensor] = None,
        gt_valid: Optional[torch.Tensor] = None,
        lidar2img: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        if gt_boxes is None or gt_valid is None or lidar2img is None:
            raise ValueError("the Depthr head (a GT-depth oracle) needs gt_boxes, gt_valid and lidar2img")
        x, masks, pos_embed, query_embed = self._embed(feats, img2lidar, img_hw, pad_hw)
        depth = self.depth_tokens(gt_boxes, gt_valid, lidar2img, pad_hw)
        if depth.shape[1:4] != masks.shape[1:]:
            raise ValueError(f"the depth token grid {tuple(depth.shape[1:4])} must be the feature grid "
                             f"{tuple(masks.shape[1:])}")
        outs_dec = self.transformer(x, masks, query_embed, pos_embed, layer_seeds, depth=depth)
        return self._predict(outs_dec, timestamp)

    def depth_tokens(self, gt_boxes: torch.Tensor, gt_valid: torch.Tensor, lidar2img: torch.Tensor,
                     pad_hw: Tuple[int, int]) -> torch.Tensor:
        """GT boxes -> depth maps -> LID one-hot -> depth tokens (B, N, h', w', C)."""
        maps = gt_depth_maps(gt_boxes, gt_valid, lidar2img, pad_hw, self.depth_map_down_scale)
        idx = bin_depth_indices(maps, "LID", self.depth_map_min, self.depth_map_max, self.depth_bins)
        onehot = F.one_hot(idx.long(), self.depth_bins + 1).to(self.dtype)
        return self.depth_gt_encoder(onehot)[0]
