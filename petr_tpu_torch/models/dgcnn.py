"""Object-DGCNN: pillars, a SECOND backbone and neck, and a BEV DETR head
with k-NN graph query attention (PyTorch).

Counterpart of `petr_tpu/models/dgcnn.py` (references, sty61010/PETR:
`models/utils/dgcnn_attn.py:10-96`, `models/dense_heads/dgcnn3d_head.py`,
`models/utils/detr.py:34-115`, `configs/obj_dgcnn.py:34-48`):
  * ``DGCNNAttn``: each query's K neighbours by euclidean distance in query
    space, the K LARGEST distances as the reference takes them; edge
    features cat(neighbour, query) -> Linear -> LN -> ReLU -> max over the
    neighbours, twice, the two summed onto the residual.
  * ``DGCNN3DHead``: a DETR decoder over the projected BEV map, its
    cross-attention ``attn_kind`` "dense" (masked attention over the BEV
    tokens) or "deformable" (``ops.deformable.MSDeformableAttention``
    around each query's BEV reference), its layers ``decoder_kind``
    "inline" (3-coordinate references) or "deformable_detr"
    (``Deformable3DDetrDecoder``: 2-coordinate references refined against
    the regression's first two codes, z decoded without a reference).
  * ``PillarFeatureNet``: PointPillars' decoration (raw features, offsets
    from the pillar's point mean and from its centre), one Linear-LN-ReLU
    over all (padded) points, and a scatter-max into the BEV canvas, empty
    pillars 0. ``SECONDBackbone`` and ``SECONDFPN`` (LayerNorm over
    channels, not BN), and ``ObjDGCNN`` chaining them.

The pillar means are sums in a fixed order (``ops.sampling.sum_rows``,
their read-back ``gather_rows``) and the neighbours are read by
``gather_rows``: on CUDA none of them sums with atomics, so two identical
backward passes give the same bits. ``pillar_scatter`` truncates its grid
index toward zero and ``pillar_decorate`` floors it, each as petr_tpu's.

Module and parameter names are petr_tpu's, so that
``utils.convert.state_dict_from_jax`` carries its params across, and the
initial draws are petr_tpu's (flax's lecun-normal Dense and Conv kernels,
zero biases). Points are (B, P, 3 + F) with (B, P) validity; the BEV
stages are NCHW; the head takes its BEV map channels-last (B, H, W, C), as
petr_tpu's. In train mode the dropouts draw from the ``generator`` the
caller passes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from petr_tpu_torch.models.layers import (Conv2d, LayerNorm, dense, dropout,
                                          lecun_normal_, xavier_attention, xavier_ffn)
from petr_tpu_torch.models.petr_head import ClsBranch, RegBranch
from petr_tpu_torch.ops.deformable import MSDeformableAttention
from petr_tpu_torch.ops.geometry import inverse_sigmoid
from petr_tpu_torch.ops.sampling import gather_rows, sum_rows

PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


def _batched(points: torch.Tensor, point_valid: torch.Tensor):
    return (points, point_valid, False) if points.dim() == 3 else (points[None], point_valid[None], True)


def pillar_scatter(
    points: torch.Tensor,  # ([B,] P, 3+F) xyz + features, padded
    point_valid: torch.Tensor,  # ([B,] P)
    pc_range: Sequence[float],
    grid_hw: Tuple[int, int],
) -> torch.Tensor:
    """The points' mean per BEV pillar plus an occupancy channel ->
    ([B,] H, W, 3+F+1); the grid index truncated toward zero (petr_tpu
    `dgcnn.py:36-57`)."""
    points, point_valid, single = _batched(points, point_valid)
    H, W = grid_hw
    B, P, D = points.shape
    pr = torch.tensor(pc_range, dtype=torch.float32, device=points.device)
    gx = ((points[..., 0] - pr[0]) / (pr[3] - pr[0]) * W).to(torch.int32)
    gy = ((points[..., 1] - pr[1]) / (pr[4] - pr[1]) * H).to(torch.int32)
    inb = (gx >= 0) & (gx < W) & (gy >= 0) & (gy < H) & point_valid
    flat = torch.where(inb, gy * W + gx, H * W).long()  # the last row is a dump slot
    feats = torch.where(inb[..., None], points, 0.0)
    summed = sum_rows(torch.cat([feats, inb[..., None].float()], -1), flat, H * W + 1)
    counts = summed[..., D]
    mean = summed[..., :D] / counts[..., None].clamp(min=1.0)
    grid = torch.cat([mean, (counts > 0).float()[..., None]], -1)[:, :H * W].reshape(B, H, W, D + 1)
    return grid[0] if single else grid


def _denormalize_codes(all_reg: torch.Tensor, pc_range: Sequence[float]) -> torch.Tensor:
    """sigmoid-space centres (cx, cy, and cz at code 4) -> metric pc_range."""
    pc = torch.tensor(pc_range, dtype=torch.float32, device=all_reg.device)
    cx = all_reg[..., 0:1] * (pc[3] - pc[0]) + pc[0]
    cy = all_reg[..., 1:2] * (pc[4] - pc[1]) + pc[1]
    cz = all_reg[..., 4:5] * (pc[5] - pc[2]) + pc[2]
    return torch.cat([cx, cy, all_reg[..., 2:4], cz, all_reg[..., 5:]], -1)


def _drop(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout at ``rate`` from ``generator``; nothing at rate 0 (eval mode)."""
    return dropout(x, rate, generator) if rate > 0.0 else x


class DGCNNAttn(nn.Module):
    """k-NN graph 'attention' over the queries: two edge convs, max over
    the neighbours, summed onto the residual (petr_tpu `dgcnn.py:69-104`)."""

    def __init__(self, embed_dim: int, K: int = 16, dropout_rate: float = 0.1):
        super().__init__()
        self.K, self.dropout_rate = K, dropout_rate
        for name in ("conv1", "conv2"):
            self.add_module(f"{name}_fc", dense(2 * embed_dim, embed_dim, bias=False))
            self.add_module(f"{name}_norm", LayerNorm(embed_dim))

    def _edge_feats(self, q: torch.Tensor) -> torch.Tensor:
        """q (B, N, C) -> cat(neighbour, centre) (B, N, K, 2C) over each
        query's K largest distances."""
        B, N, C = q.shape
        K = min(self.K, N)
        d2 = ((q[:, :, None, :] - q[:, None, :, :]) ** 2).sum(-1)
        topk = torch.topk(torch.sqrt(d2.clamp(min=0.0)), K, dim=-1).indices  # (B, N, K)
        neigh = gather_rows(q, topk.reshape(B, N * K)).reshape(B, N, K, C)
        return torch.cat([neigh, q[:, :, None, :].expand(B, N, K, C)], -1)

    def _edge_conv(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = getattr(self, f"{name}_norm")(getattr(self, f"{name}_fc")(x))
        return torch.relu(y).amax(dim=2)

    def forward(self, query: torch.Tensor, query_pos: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        residual = query
        if query_pos is not None:
            query = query + query_pos
        e1 = self._edge_conv(self._edge_feats(query), "conv1")
        e2 = self._edge_conv(self._edge_feats(e1), "conv2")
        rate = self.dropout_rate if self.training else 0.0
        return residual + _drop(e1 + e2, rate, generator)


class DeformableDetrDecoderLayer(nn.Module):
    """mmcv's ``DetrTransformerDecoderLayer`` with deformable cross-attention:
    self_attn -> norm1 -> cross_attn -> norm2 -> ffn -> norm3 (petr_tpu
    `dgcnn.py:107-143`)."""

    def __init__(self, embed_dim: int, num_heads: int = 8, ffn_dim: int = 512, num_points: int = 4,
                 num_levels: int = 1, dropout_rate: float = 0.1):
        super().__init__()
        self.self_attn = xavier_attention(embed_dim, num_heads, dropout_rate)
        self.norm1 = LayerNorm(embed_dim)
        self.cross_attn = MSDeformableAttention(embed_dim, num_heads, num_points, num_levels)
        self.norm2 = LayerNorm(embed_dim)
        self.ffn = xavier_ffn(embed_dim, ffn_dim, dropout_rate)
        self.norm3 = LayerNorm(embed_dim)

    def forward(self, query, query_pos, value_levels, ref_2d,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        qp = query + query_pos
        x = self.norm1(query + self.self_attn(qp, qp, query, generator=generator))
        x = self.norm2(x + self.cross_attn(x + query_pos, value_levels, ref_2d))
        return self.norm3(x + self.ffn(x, generator=generator))


class Deformable3DDetrDecoder(nn.Module):
    """The reference's ``Deformable3DDetrTransformerDecoder``
    (`models/utils/detr.py:34-115`; petr_tpu `dgcnn.py:146-200`): per layer
    a ``DeformableDetrDecoderLayer`` and its own reg branch; the
    2-coordinate references become sigmoid(reg[..., :2] +
    inverse_sigmoid(ref)), detached. Returns (states (L, B, Q, C),
    refs_in (L, B, Q, 2): each layer's input references, regs
    (L, B, Q, code) fp32)."""

    def __init__(self, embed_dim: int, num_layers: int = 6, num_heads: int = 8, ffn_dim: int = 512,
                 num_points: int = 4, code_size: int = 10, num_reg_fcs: int = 2, dropout_rate: float = 0.1,
                 num_levels: int = 1):
        super().__init__()
        self.num_layers = num_layers
        for lid in range(num_layers):
            self.add_module(f"layer{lid}", DeformableDetrDecoderLayer(embed_dim, num_heads, ffn_dim, num_points,
                                                                       num_levels, dropout_rate))
            self.add_module(f"reg_branch_{lid}", RegBranch(embed_dim, num_reg_fcs, code_size))

    def forward(self, query, query_pos, value_levels, reference_points,
                generator: Optional[torch.Generator] = None):
        ref = reference_points.float()
        states, refs_in, regs = [], [], []
        for lid in range(self.num_layers):
            query = getattr(self, f"layer{lid}")(query, query_pos, value_levels, ref, generator)
            reg = getattr(self, f"reg_branch_{lid}")(query).float()
            states.append(query)
            refs_in.append(ref)
            regs.append(reg)
            ref = torch.sigmoid(reg[..., :2] + inverse_sigmoid(ref)).detach()  # detr.py:99-104
        return torch.stack(states), torch.stack(refs_in), torch.stack(regs)


class DGCNN3DHead(nn.Module):
    """A DETR head over BEV tokens with DGCNN query self-attention
    (petr_tpu `dgcnn.py:203-322`). ``bev_feats`` (B, H, W, in_channels)
    -> ``cls_logits`` (L, B, Q, classes), ``bbox_codes`` (L, B, Q, code)
    with metric centres, both fp32."""

    def __init__(
        self,
        num_classes: int = 10,
        in_channels: int = 256,
        embed_dim: int = 256,
        num_query: int = 300,
        num_layers: int = 6,
        num_heads: int = 8,
        ffn_dim: int = 512,
        num_reg_fcs: int = 2,
        code_size: int = 10,
        knn: int = 16,
        pc_range: Sequence[float] = PC_RANGE,
        dropout_rate: float = 0.1,
        attn_kind: str = "dense",
        decoder_kind: str = "inline",
        num_points: int = 4,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if attn_kind not in ("dense", "deformable"):
            raise ValueError(f"attn_kind must be dense|deformable, got {attn_kind!r}")
        if decoder_kind not in ("inline", "deformable_detr"):
            raise ValueError(f"decoder_kind must be inline|deformable_detr, got {decoder_kind!r}")
        C = embed_dim
        self.num_layers, self.attn_kind, self.decoder_kind = num_layers, attn_kind, decoder_kind
        self.dropout_rate = dropout_rate
        self.pc_range = tuple(pc_range)
        self.dtype = dtype
        self.input_proj = dense(in_channels, C)
        self.query_embedding = nn.Parameter(torch.randn(num_query, 2 * C))
        if decoder_kind == "deformable_detr":
            self.reference_points = dense(C, 2)
            self.decoder = Deformable3DDetrDecoder(C, num_layers, num_heads, ffn_dim, num_points, code_size,
                                                   num_reg_fcs, dropout_rate)
            for lvl in range(num_layers):
                self.add_module(f"cls_branch_{lvl}", ClsBranch(C, num_reg_fcs, num_classes))
            return
        self.reference_points = dense(C, 3)
        for lvl in range(num_layers):
            self.add_module(f"layer{lvl}_dgcnn", DGCNNAttn(C, knn, dropout_rate))
            self.add_module(f"layer{lvl}_norm1", LayerNorm(C))
            self.add_module(f"layer{lvl}_cross", MSDeformableAttention(C, num_heads, num_points)
                            if attn_kind == "deformable" else xavier_attention(C, num_heads, dropout_rate))
            self.add_module(f"layer{lvl}_norm2", LayerNorm(C))
            self.add_module(f"layer{lvl}_ffn", xavier_ffn(C, ffn_dim, dropout_rate))
            self.add_module(f"layer{lvl}_norm3", LayerNorm(C))
            self.add_module(f"cls_branch_{lvl}", ClsBranch(C, num_reg_fcs, num_classes))
            self.add_module(f"reg_branch_{lvl}", RegBranch(C, num_reg_fcs, code_size))

    def forward(self, bev_feats: torch.Tensor, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        B, H, W, _ = bev_feats.shape
        bev = self.input_proj(bev_feats.to(self.dtype))
        C = bev.shape[-1]
        tokens = bev.reshape(B, H * W, C)
        query_pos, query = self.query_embedding.to(self.dtype).chunk(2, dim=-1)
        Q = query.shape[0]
        query_pos = query_pos[None].expand(B, Q, C)
        query = query[None].expand(B, Q, C)
        if self.decoder_kind == "deformable_detr":
            return self._deformable_detr_decode(query, query_pos, bev, generator)

        ref = torch.sigmoid(self.reference_points(query_pos.float()))
        cls_list, reg_list = [], []
        for lvl in range(self.num_layers):
            dgcnn, norm1, cross, norm2, ffn, norm3 = (getattr(self, f"layer{lvl}_{n}") for n in
                                                      ("dgcnn", "norm1", "cross", "norm2", "ffn", "norm3"))
            query = norm1(dgcnn(query, query_pos, generator))
            if self.attn_kind == "deformable":
                ca = cross(query + query_pos, [bev], ref[..., :2])
            else:
                ca = cross(query + query_pos, tokens, tokens, generator=generator)
            query = norm2(query + ca)
            query = norm3(query + ffn(query, generator=generator))
            cls_out = getattr(self, f"cls_branch_{lvl}")(query)
            reg_out = getattr(self, f"reg_branch_{lvl}")(query).float()
            ref_is = inverse_sigmoid(ref)
            xy = torch.sigmoid(reg_out[..., 0:2] + ref_is[..., 0:2])
            z = torch.sigmoid(reg_out[..., 4:5] + ref_is[..., 2:3])
            cls_list.append(cls_out.float())
            reg_list.append(torch.cat([xy, reg_out[..., 2:4], z, reg_out[..., 5:]], -1))
            ref = torch.cat([xy, z], -1).detach()
        return {"cls_logits": torch.stack(cls_list),
                "bbox_codes": _denormalize_codes(torch.stack(reg_list), self.pc_range)}

    def _deformable_detr_decode(self, query, query_pos, bev, generator) -> Dict[str, torch.Tensor]:
        ref2 = torch.sigmoid(self.reference_points(query_pos.float()))
        states, refs_in, regs = self.decoder(query, query_pos, [bev], ref2, generator)
        cls_list, reg_list = [], []
        for lvl in range(self.num_layers):
            cls_list.append(getattr(self, f"cls_branch_{lvl}")(states[lvl]).float())
            xy = torch.sigmoid(regs[lvl][..., 0:2] + inverse_sigmoid(refs_in[lvl]))
            z = torch.sigmoid(regs[lvl][..., 4:5])
            reg_list.append(torch.cat([xy, regs[lvl][..., 2:4], z, regs[lvl][..., 5:]], -1))
        return {"cls_logits": torch.stack(cls_list),
                "bbox_codes": _denormalize_codes(torch.stack(reg_list), self.pc_range)}


def pillar_decorate(
    points: torch.Tensor,  # ([B,] P, 3+F)
    point_valid: torch.Tensor,  # ([B,] P)
    pc_range: Sequence[float],
    grid_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each point's pillar and PointPillars' decoration (petr_tpu
    `dgcnn.py:325-363`) -> (decorated ([B,] P, 3+F+5): the point, xyz minus
    its pillar's point mean, xy minus the pillar's centre, 0 for points
    out of the grid or invalid; the flat pillar id ([B,] P), H*W for those;
    the in-grid mask). The grid index is floored."""
    points, point_valid, single = _batched(points, point_valid)
    H, W = grid_hw
    pr = torch.tensor(pc_range, dtype=torch.float32, device=points.device)
    vx = (pr[3] - pr[0]) / W
    vy = (pr[4] - pr[1]) / H
    gx = torch.floor((points[..., 0] - pr[0]) / vx).to(torch.int32)
    gy = torch.floor((points[..., 1] - pr[1]) / vy).to(torch.int32)
    inb = (gx >= 0) & (gx < W) & (gy >= 0) & (gy < H) & point_valid
    flat = torch.where(inb, gy * W + gx, H * W).long()

    # per-pillar cluster mean of xyz: a fixed-order sum, read back by gather_rows
    xyz = torch.where(inb[..., None], points[..., :3], 0.0)
    sums = sum_rows(torch.cat([xyz, inb[..., None].float()], -1), flat, H * W + 1)
    mean = sums[..., :3] / sums[..., 3:4].clamp(min=1.0)
    cluster_off = points[..., :3] - gather_rows(mean, flat)

    cx = pr[0] + (gx.float() + 0.5) * vx
    cy = pr[1] + (gy.float() + 0.5) * vy
    center_off = torch.stack([points[..., 0] - cx, points[..., 1] - cy], -1)
    dec = torch.where(inb[..., None], torch.cat([points, cluster_off, center_off], -1), 0.0)
    return (dec[0], flat[0], inb[0]) if single else (dec, flat, inb)


class ChannelLayerNorm(LayerNorm):
    """LayerNorm over the channels of an NCHW map (flax's ``nn.LayerNorm``
    on the channels-last map)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.movedim(1, -1)).movedim(-1, 1)


class SameConv2d(Conv2d):
    """A bias-free conv with flax's "SAME" padding: ceil(in / stride)
    outputs, the padding's odd pixel at the bottom and right."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1):
        super().__init__(in_channels, out_channels, kernel, stride, 0, bias=False)
        lecun_normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s in zip(reversed(x.shape[2:]), reversed(self.kernel_size), reversed(self.stride)):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


class ConvTranspose2d(nn.ConvTranspose2d):
    """A bias-free transposed conv with kernel = stride (``SECONDFPN``'s
    upsampling), computing in its input's dtype. flax's ``ConvTranspose``
    does not flip its kernel, torch's does: the converter flips it."""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__(in_channels, out_channels, stride, stride, bias=False)
        lecun_normal_(self.weight, fan_in=in_channels * stride * stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), None, self.stride)


class PillarFeatureNet(nn.Module):
    """PointPillars' voxel encoder and scatter (petr_tpu `dgcnn.py:366-405`):
    the decoration in fp32, one Linear-LN-ReLU in ``dtype`` over all
    decorated (padded) points, then a scatter-max into the BEV canvas,
    empty pillars 0 -> (B, C, H, W) in ``dtype``."""

    def __init__(self, in_channels: int = 5, out_channels: int = 64,
                 pc_range: Sequence[float] = PC_RANGE, grid_hw: Tuple[int, int] = (128, 128),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_channels, self.dtype = out_channels, dtype
        self.pc_range, self.grid_hw = tuple(pc_range), tuple(grid_hw)
        self.pfn_fc = dense(in_channels + 5, out_channels, bias=False)
        self.pfn_norm = LayerNorm(out_channels)

    def forward(self, points: torch.Tensor, point_valid: torch.Tensor) -> torch.Tensor:
        H, W = self.grid_hw
        B, P, _ = points.shape
        dec, flat, inb = pillar_decorate(points.float(), point_valid, self.pc_range, self.grid_hw)
        f = torch.relu(self.pfn_norm(self.pfn_fc(dec.to(self.dtype)))).float()
        neg = torch.finfo(torch.float32).min
        f = torch.where(inb[..., None], f, neg)
        canvas = f.new_full((B, H * W + 1, self.out_channels), neg)
        canvas = canvas.scatter_reduce(1, flat[..., None].expand(B, P, self.out_channels), f, "amax")
        canvas = torch.where(canvas <= neg / 2, 0.0, canvas)  # empty pillars
        return canvas[:, :H * W].reshape(B, H, W, -1).permute(0, 3, 1, 2).to(self.dtype)


class SECONDBackbone(nn.Module):
    """SECOND's strided BEV backbone (petr_tpu `dgcnn.py:408-432`): per
    stage a stride-s 3x3 conv then ``layer_nums`` 3x3 convs, each conv ->
    LayerNorm over channels -> ReLU; returns every stage's map (NCHW)."""

    def __init__(self, in_channels: int = 64, channels: Sequence[int] = (64, 128, 256),
                 layer_nums: Sequence[int] = (3, 5, 5), strides: Sequence[int] = (2, 2, 2)):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        for s, (ch, n, st) in enumerate(zip(channels, layer_nums, strides)):
            for i in range(n + 1):
                self.add_module(f"stage{s}_conv{i}", SameConv2d(in_channels if i == 0 else ch, ch, 3,
                                                                st if i == 0 else 1))
                self.add_module(f"stage{s}_norm{i}", ChannelLayerNorm(ch))
            in_channels = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for s, n in enumerate(self.layer_nums):
            for i in range(n + 1):
                x = torch.relu(getattr(self, f"stage{s}_norm{i}")(getattr(self, f"stage{s}_conv{i}")(x)))
            outs.append(x)
        return outs


class SECONDFPN(nn.Module):
    """SECOND's neck (petr_tpu `dgcnn.py:435-455`): each stage upsampled to
    a common stride (a transposed conv of kernel = stride, or a 1x1 conv
    at stride 1), LayerNorm over channels, ReLU, concatenated (NCHW)."""

    def __init__(self, in_channels: Sequence[int] = (64, 128, 256), out_channels: Sequence[int] = (128, 128, 128),
                 upsample_strides: Sequence[int] = (1, 2, 4)):
        super().__init__()
        self.num_outs = len(out_channels)
        for i, (cin, ch, st) in enumerate(zip(in_channels, out_channels, upsample_strides)):
            self.add_module(f"deblock{i}", ConvTranspose2d(cin, ch, st) if st > 1 else SameConv2d(cin, ch, 1))
            self.add_module(f"deblock{i}_norm", ChannelLayerNorm(ch))

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([torch.relu(getattr(self, f"deblock{i}_norm")(getattr(self, f"deblock{i}")(f)))
                          for i, f in enumerate(feats)], dim=1)


class ObjDGCNN(nn.Module):
    """The LiDAR detector (petr_tpu `dgcnn.py:458-501`, `obj_dgcnn.py:34-48`):
    ``pts_voxel_encoder`` (PillarFeatureNet) -> ``pts_backbone`` (SECOND)
    -> ``pts_neck`` (SECONDFPN) -> ``head`` (DGCNN3DHead, dense attention,
    inline decoder). ``forward(points (B, P, 3+F), point_valid (B, P))``."""

    def __init__(
        self,
        num_classes: int = 10,
        embed_dim: int = 128,
        grid_hw: Tuple[int, int] = (128, 128),
        pc_range: Sequence[float] = PC_RANGE,
        num_query: int = 300,
        num_layers: int = 3,
        point_features: int = 5,
        pillar_channels: int = 64,
        backbone_channels: Sequence[int] = (64, 128, 256),
        backbone_layer_nums: Sequence[int] = (3, 5, 5),
        neck_channels: Sequence[int] = (128, 128, 128),
        dropout_rate: float = 0.1,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.pts_voxel_encoder = PillarFeatureNet(point_features, pillar_channels, pc_range, grid_hw, dtype)
        self.pts_backbone = SECONDBackbone(pillar_channels, backbone_channels, backbone_layer_nums)
        self.pts_neck = SECONDFPN(backbone_channels, neck_channels,
                                  tuple(2 ** i for i in range(len(backbone_channels))))
        self.head = DGCNN3DHead(num_classes=num_classes, in_channels=sum(neck_channels), embed_dim=embed_dim,
                                num_query=num_query, num_layers=num_layers, pc_range=pc_range,
                                dropout_rate=dropout_rate, dtype=dtype)

    def forward(self, points: torch.Tensor, point_valid: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        canvas = self.pts_voxel_encoder(points, point_valid)
        bev = self.pts_neck(self.pts_backbone(canvas))
        return self.head(bev.permute(0, 2, 3, 1), generator)
