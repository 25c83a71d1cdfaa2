"""PETR3D detector assembly: backbone -> neck -> head (PyTorch).

Counterpart of `petr_tpu/models/detector.py` (reference
`models/detectors/petr3d.py:68-99`, sty61010/PETR): views fold into the
batch for the backbone and unfold after the neck; the head consumes one FPN
level, or, without the neck (``with_fpn=False``, the c5 presets), one
backbone stage. The backbone is VoVNet or the r50dcn family's ResNet; the
head is ``PETRHead``, or ``PETRv2Head`` for the PETRv2 family (two frames as
12 views, with ``timestamp`` (B, N)). Inputs keep petr_tpu's layout: images
(B, N, H, W, 3), img2lidar (B, N, 4, 4), img_hw (B, N, 2). Submodules carry
the reference checkpoint's names: ``img_backbone``, ``img_neck``,
``pts_bbox_head``. The Depthr head (``kind="depthr"``) also reads the GT
boxes and cameras, ``gt_boxes``, ``gt_valid`` and ``lidar2img``, at test
time too (an oracle). The detector's two halves, ``extract_feats`` and
``forward_head``, are petr_tpu's ``PETRFeatureNet`` and ``PETRHeadNet``
over one ``state_dict``: the streaming runtime caches the first's output.

In eval mode the forward is deterministic. In train mode it takes a
``TrainNoise``, all the randomness of one training forward drawn up front
from the train step's generator (``draw_train_noise``): the GridMask
parameters, applied to the images before the backbone when
``use_grid_mask`` holds (`petr_tpu/models/detector.py:187-188`), and the
decoder layers' dropout seeds. The remat regions (OSA blocks or
bottlenecks, decoder layers) then recompute from their arguments alone.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from petr_tpu_torch.configs.config import ModelConfig
from petr_tpu_torch.models.fpn import CPFPN
from petr_tpu_torch.models.depth_encoder import DepthGTEncoder, GroupNorm
from petr_tpu_torch.models.depthr_head import DepthrHead
from petr_tpu_torch.models.grid_mask import FloatGridParams, GridParams, draw_grid_params, grid_mask
from petr_tpu_torch.models.layers import (
    AttentionProjections,
    Conv2d,
    FFN,
    FrozenBatchNorm,
    LayerNorm,
    Linear,
    PointwiseConv2d,
)
from petr_tpu_torch.models.petr_head import FOCAL_PRIOR_BIAS, PETRHead
from petr_tpu_torch.models.petrv2_head import PETRv2Head
from petr_tpu_torch.models.resnet import STAGE_OUT, ModulatedDeformConv2dPack, ResNet
from petr_tpu_torch.models.transformer import LayerSeeds
from petr_tpu_torch.models.vovnet import SPECS, VoVNet


@dataclasses.dataclass(frozen=True)
class TrainNoise:
    """The randomness of one training forward."""

    grid: Optional[Union[GridParams, FloatGridParams]]  # None: no GridMask
    layer_seeds: Tuple[LayerSeeds, ...]  # (flash seed, dropout seed) per decoder layer


def draw_train_noise(config: ModelConfig, image_h: int, generator: torch.Generator, batch: int = 1) -> TrainNoise:
    """Draw a training forward's randomness from ``generator`` (a CPU
    generator: nothing here touches the device). The flash seeds are int32
    in [0, 2^31 - 1), as petr_tpu draws them. ``batch``: the global batch,
    whose per-sample GridMask draws ``grid_mask_exact=False`` takes."""
    grid = None
    if config.use_grid_mask:
        grid = draw_grid_params(generator, image_h, exact=config.grid_mask_exact, batch=batch)
    n = config.head.num_layers
    flash = torch.randint(0, 2**31 - 1, (n,), generator=generator).tolist()
    other = torch.randint(0, 2**62, (n,), generator=generator).tolist()
    return TrainNoise(grid, tuple(zip(flash, other)))


def _remat_scope(cfg: ModelConfig) -> str:
    if cfg.remat_scope not in ("all", "backbone", "decoder"):
        raise ValueError(f"remat_scope must be all|backbone|decoder, got {cfg.remat_scope!r}")
    return cfg.remat_scope


def _backbone(cfg: ModelConfig) -> Tuple[nn.Module, Tuple[int, ...]]:
    """The backbone of ``cfg`` and the channels of each of its outputs."""
    bb = cfg.backbone
    remat = cfg.remat and _remat_scope(cfg) in ("all", "backbone")
    if bb.kind == "vovnet":
        stage_out = SPECS[bb.spec]["stage_out_ch"]
        return (VoVNet(bb.spec, bb.out_indices, remat=remat, bn_mode=bb.bn_mode, quant=bb.quant),
                tuple(stage_out[i] for i in bb.out_indices))
    if bb.kind == "resnet":
        if bb.quant != "none":  # as petr_tpu (`detector.py:57-60`)
            raise NotImplementedError("backbone.quant is only supported for the VoVNet backbone")
        model = ResNet(int(bb.spec[1:]), bb.out_indices, bb.dcn_stages, remat=remat, bn_mode=bb.bn_mode)
        return model, tuple(STAGE_OUT[i] for i in bb.out_indices)
    raise ValueError(f"backbone kind must be vovnet or resnet, got {bb.kind!r}")


class PETRDetector(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        if config.backbone.bn_mode not in ("frozen", "batch"):
            raise ValueError(f"bn_mode must be frozen|batch, got {config.backbone.bn_mode!r}")
        self.config = config
        self.dtype = getattr(torch, config.compute_dtype)
        bb, hc = config.backbone, config.head
        scope = _remat_scope(config)
        self.img_backbone, channels = _backbone(config)
        # without the neck the head reads a backbone stage (C5 for the c5 presets)
        self.img_neck = CPFPN(channels, bb.fpn_out_channels, bb.fpn_num_outs) if bb.with_fpn else None
        head_kwargs = dict(
            num_classes=hc.num_classes,
            in_channels=bb.fpn_out_channels if bb.with_fpn else channels[config.head_feat_level],
            embed_dim=hc.embed_dim,
            num_query=hc.num_query,
            num_layers=hc.num_layers,
            num_heads=hc.num_heads,
            ffn_dim=hc.ffn_dim,
            code_size=hc.code_size,
            depth_num=hc.depth_num,
            depth_start=hc.depth_start,
            depth_mode=hc.depth_mode,
            with_multiview=hc.with_multiview,
            position_range=hc.position_range,
            pc_range=hc.pc_range,
            use_flash=config.use_flash_attention,
            dtype=self.dtype,
            dropout_rate=hc.dropout_rate,
            remat=config.remat and scope in ("all", "decoder"),
            shared_branches=hc.shared_branches,
        )
        # the dispatch of petr_tpu's `_apply_head` (`detector.py:130-154`)
        if hc.kind == "petrv2" or hc.with_fpe or hc.with_time or hc.with_multi_reg:
            self.pts_bbox_head = PETRv2Head(with_fpe=hc.with_fpe, with_time=hc.with_time,
                                            with_multi_reg=hc.with_multi_reg, **head_kwargs)
        elif hc.kind == "depthr":
            self.pts_bbox_head = DepthrHead(
                depth_bins=hc.depth_bins, depth_map_min=hc.depth_map_min, depth_map_max=hc.depth_map_max,
                depth_map_down_scale=hc.depth_map_down_scale,
                depth_encoder_down_scale=hc.depth_encoder_down_scale, **head_kwargs)
        else:
            self.pts_bbox_head = PETRHead(**head_kwargs)

    def forward(
        self,
        images: torch.Tensor,  # (B, N, H, W, 3) normalized, or (B, A, N, H, W, 3) for TTA
        img2lidar: torch.Tensor,  # (B, N, 4, 4)
        img_hw: torch.Tensor,  # (B, N, 2)
        noise: Optional[TrainNoise] = None,  # train mode only
        timestamp: Optional[torch.Tensor] = None,  # (B, N), for PETRv2's with_time
        gt_boxes: Optional[torch.Tensor] = None,  # (B, G, 9), Depthr's oracle inputs
        gt_valid: Optional[torch.Tensor] = None,  # (B, G)
        lidar2img: Optional[torch.Tensor] = None,  # (B, N, 4, 4)
    ) -> Dict[str, torch.Tensor]:
        """petr_tpu's ``PETRDetector.__call__``: GridMask in training, then
        ``extract_feats`` and ``forward_head``. 6-d images stack A test-time
        augmentations of each sample: their features are averaged (in
        fp32, one rounding to the compute dtype, as jnp.mean) before the
        head, which reads the first variant's geometry, ``img2lidar`` and
        ``img_hw`` (petr_tpu `detector.py:181-196`, the reference's
        ``aug_test``)."""
        num_aug = 1
        if images.dim() == 6:
            B, num_aug = images.shape[:2]
            images = images.reshape(B * num_aug, *images.shape[2:])
        H, W = images.shape[2:4]
        layer_seeds = None
        if self.training:
            if noise is None:
                if self.config.use_grid_mask or self.config.head.dropout_rate > 0.0:
                    raise ValueError("a training forward needs its TrainNoise (draw_train_noise)")
            else:
                layer_seeds = noise.layer_seeds
                if self.config.use_grid_mask:
                    images = grid_mask(images, noise.grid)
        elif noise is not None:
            raise ValueError("TrainNoise is for train mode; call model.train() first")
        feats = self.extract_feats(images)
        if num_aug > 1:
            feats = feats.reshape(B, num_aug, *feats.shape[1:]).float().mean(dim=1).to(feats.dtype)
        return self.forward_head(feats, img2lidar, img_hw, (H, W),
                                 timestamp=timestamp, layer_seeds=layer_seeds,
                                 gt_boxes=gt_boxes, gt_valid=gt_valid, lidar2img=lidar2img)

    def extract_feats(self, images: torch.Tensor) -> torch.Tensor:
        """Backbone and neck: images (B, N, H, W, 3) -> the head's feature
        level (B, N, fh, fw, fc) in the compute dtype; petr_tpu's
        ``PETRFeatureNet`` (`detector.py:205-223`). Each view is computed on
        its own, so a frame's features can be cached and reused."""
        B, N, H, W, C = images.shape
        x = images.reshape(B * N, H, W, C).permute(0, 3, 1, 2).contiguous().to(self.dtype)
        feats = self.img_backbone(x)
        if self.img_neck is not None:
            feats = self.img_neck(feats)
        f = feats[self.config.head_feat_level]  # (B*N, fc, fh, fw)
        fc, fh, fw = f.shape[1:]
        return f.permute(0, 2, 3, 1).reshape(B, N, fh, fw, fc)

    def forward_head(
        self,
        feats: torch.Tensor,  # (B, N, fh, fw, fc) from extract_feats
        img2lidar: torch.Tensor,  # (B, N, 4, 4)
        img_hw: torch.Tensor,  # (B, N, 2)
        input_hw: Tuple[int, int],  # the (H, W) of the images the features came from
        timestamp: Optional[torch.Tensor] = None,  # (B, N), for PETRv2's with_time
        layer_seeds: Optional[Tuple[LayerSeeds, ...]] = None,  # training only
        gt_boxes: Optional[torch.Tensor] = None,  # (B, G, 9), Depthr's oracle inputs
        gt_valid: Optional[torch.Tensor] = None,  # (B, G)
        lidar2img: Optional[torch.Tensor] = None,  # (B, N, 4, 4)
    ) -> Dict[str, torch.Tensor]:
        """The head over precomputed features -> per-layer ``cls_logits`` and
        ``bbox_codes``; petr_tpu's ``PETRHeadNet`` (`detector.py:226-255`).
        The oracle inputs reach the Depthr head, which needs them, and no
        other."""
        oracle = {}
        if isinstance(self.pts_bbox_head, DepthrHead):
            oracle = dict(gt_boxes=gt_boxes, gt_valid=gt_valid, lidar2img=lidar2img)
        return self.pts_bbox_head(feats, img2lidar, img_hw, input_hw, layer_seeds, timestamp=timestamp, **oracle)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int, petr_tpu_scales: bool = False) -> nn.Module:
    """Re-draw every parameter of ``model`` from ``seed`` (random weights for
    runs without a checkpoint), with one torch.Generator in module order.

    Convs: He-uniform (variance 2 / fan_in), which keeps a random model's
    activations at scale through the deep ReLU backbones; the serving
    paths' random weights (``serve.build_detector``) and the parity tests
    are drawn so. With ``petr_tpu_scales`` (``train.create_train_state``)
    each parameter is drawn at the scale petr_tpu's ``model.init`` draws
    it, so that a run from random weights starts where petr_tpu's does:
    convs (flax's ``nn.Conv`` default) variance 1 / fan_in and a zero bias,
    the DCN convs' weight He's (`resnet.py:55`), the decoder's attention
    output projections and FFN linears Xavier-uniform with a zero bias.
    Under frozen BN at its identity statistics nothing renormalises a
    backbone, so the scale carries: He's variance on every conv made the
    r50dcn features far larger than petr_tpu's, and a bf16 synth_small_r50dcn run's
    gradient norm overflowed by step 900.

    Either way: linears, the head's pointwise convs and their biases
    otherwise torch's U(+-1/sqrt(fan_in)) (petr_tpu's
    ``torch_kernel_init``); norms: identity; reference points: U(0, 1); the
    final cls bias: the focal prior; DCN offset convs: zeros, as in mmcv and
    petr_tpu (`resnet.py:52`); Depthr's depth embedding: N(0, 1), as
    petr_tpu's (`depth_encoder.py:157-162`). BN running statistics stay 0 /
    1. Unshared branches are drawn one by one, each layer's final cls bias
    set.
    """
    gen = torch.Generator().manual_seed(seed)

    def uniform_(t: torch.Tensor, bound: float) -> None:
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)

    def xavier_(linear: Linear) -> None:
        uniform_(linear.weight, (6.0 / sum(linear.weight.shape)) ** 0.5)
        linear.bias.zero_()

    for module in model.modules():
        if isinstance(module, (Conv2d, Linear, PointwiseConv2d)):
            fan_in = module.weight[0].numel()
            if isinstance(module, Conv2d) and petr_tpu_scales:
                gain = 2.0 if isinstance(module, ModulatedDeformConv2dPack) else 1.0
                uniform_(module.weight, (3.0 * gain / fan_in) ** 0.5)
                if module.bias is not None:
                    module.bias.zero_()
                continue
            if isinstance(module, Conv2d):
                uniform_(module.weight, (6.0 / fan_in) ** 0.5)
            else:
                uniform_(module.weight, fan_in ** -0.5)
            if module.bias is not None:
                uniform_(module.bias, fan_in ** -0.5)
        elif isinstance(module, (FrozenBatchNorm, LayerNorm, GroupNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
    for module in model.modules():
        if isinstance(module, PETRHead):
            module.reference_points.weight.copy_(
                torch.rand(module.reference_points.weight.shape, generator=gen)
            )
            for branch in module.cls_branches:
                branch[-1].bias.fill_(FOCAL_PRIOR_BIAS)
        elif isinstance(module, AttentionProjections):
            fan = module.in_proj_weight.shape[1] + module.in_proj_weight.shape[0]
            uniform_(module.in_proj_weight, (6.0 / fan) ** 0.5)
            module.in_proj_bias.zero_()
            if petr_tpu_scales:
                xavier_(module.out_proj)
        elif isinstance(module, FFN) and petr_tpu_scales:
            xavier_(module.layers[0][0])
            xavier_(module.layers[1])
        elif isinstance(module, ModulatedDeformConv2dPack):
            module.conv_offset.weight.zero_()
            module.conv_offset.bias.zero_()
        elif isinstance(module, DepthGTEncoder):
            emb = module.depth_pos_embed.weight
            emb.copy_(torch.randn(emb.shape, generator=gen))
    return model

