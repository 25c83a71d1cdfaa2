"""ResNet backbone (NCHW, frozen or batch-moments BN), caffe-style bottlenecks, DCNv2 stages.

Counterpart of `petr_tpu/models/resnet.py` (the reference's r50dcn configs
use mmdet's ResNet, 'caffe' style, BN eval, DCNv2 in stages 3 and 4:
`petr_r50dcn_gridmask_p4.py:31-44`). Caffe style puts a bottleneck's stride
on its first 1x1 conv, so every DCN conv runs at stride 1. Module names are
mmdet's (``conv1``, ``bn1``, ``layer{s}.{b}.conv{1,2,3}``, ``bn{1,2,3}``,
``downsample.{0,1}``), and a DCN conv2 is named like mmcv's
``ModulatedDeformConv2dPack`` (``conv2.weight``, ``conv2.conv_offset.*``),
so that a reference checkpoint, and petr_tpu's converter, map as they are.
With ``remat`` each bottleneck is a ``torch.utils.checkpoint`` region in
training, as ``nn.remat(Bottleneck)`` is (`resnet.py:112`).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from petr_tpu_torch.models.layers import Conv2d, FrozenBatchNorm
from petr_tpu_torch.ops.dcn import modulated_deform_conv

BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
STAGE_OUT = (256, 512, 1024, 2048)
# redraw_offset_convs' scales: see its docstring
OFFSET_WEIGHT_STD = 0.025
OFFSET_BIAS_PX = 3.0


class ModulatedDeformConv2dPack(Conv2d):
    """A 3x3 DCNv2 conv (OIHW ``weight``, no bias) with its own predictor of
    offsets and mask logits, ``conv_offset`` (27 channels, 3x3, padding 1,
    the same stride). The predictor runs in fp32 on ``x.float()`` even in a
    bf16 model, and the weight enters the kernel in fp32, as in petr_tpu
    (`resnet.py:50-61`)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__(in_channels, out_channels, 3, stride, 1, bias=False)
        self.conv_offset = Conv2d(in_channels, 27, 3, stride, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        off_mask = self.conv_offset(x.float())
        return modulated_deform_conv(x, off_mask, self.weight, self.stride[0], self.dilation[0])


class Bottleneck(nn.Module):
    """1x1 (stride) -> 3x3 (plain or DCN) -> 1x1, frozen BN after each, ReLU,
    projected identity where the shape changes."""

    def __init__(self, in_channels: int, mid: int, out: int, stride: int = 1, use_dcn: bool = False,
                 bn_mode: str = "frozen"):
        super().__init__()
        batch = bn_mode == "batch"
        self.conv1 = Conv2d(in_channels, mid, 1, stride, bias=False)
        self.bn1 = FrozenBatchNorm(mid, use_batch_stats=batch)
        self.conv2 = ModulatedDeformConv2dPack(mid, mid) if use_dcn else Conv2d(mid, mid, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(mid, use_batch_stats=batch)
        self.conv3 = Conv2d(mid, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out, use_batch_stats=batch)
        self.downsample = None
        if in_channels != out or stride != 1:
            self.downsample = nn.Sequential(Conv2d(in_channels, out, 1, stride, bias=False),
                                            FrozenBatchNorm(out, use_batch_stats=batch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    """ResNet-50/101 with bottleneck blocks; returns the stage outputs named
    by ``out_indices`` (0..3 = C2..C5, strides 4/8/16/32). ``bn_mode`` is
    "frozen" or "batch" (see ``FrozenBatchNorm``)."""

    def __init__(self, depth: int = 50, out_indices: Sequence[int] = (2, 3),
                 dcn_stages: Sequence[int] = (), remat: bool = False, bn_mode: str = "frozen"):
        super().__init__()
        if depth not in BLOCKS:
            raise ValueError(f"ResNet depth {depth} not in {sorted(BLOCKS)}")
        self.out_indices = tuple(out_indices)
        self.remat = remat
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64, use_batch_stats=bn_mode == "batch")
        in_ch, mid = 64, 64
        for stage, n in enumerate(BLOCKS[depth]):
            blocks = []
            for b in range(n):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(Bottleneck(in_ch, mid, 4 * mid, stride, stage in dcn_stages, bn_mode))
                in_ch = 4 * mid
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            mid *= 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        remat = self.remat and self.training and torch.is_grad_enabled()
        outs = []
        for stage in range(4):
            for block in getattr(self, f"layer{stage + 1}"):
                x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            if stage in self.out_indices:
                outs.append(x)
        return outs


@torch.no_grad()
def redraw_offset_convs(model: nn.Module, seed: int, weight_std: float = OFFSET_WEIGHT_STD) -> int:
    """Re-draw every ``conv_offset`` of ``model`` from a numpy ``seed``, for
    runs with random weights; returns how many it drew.

    ``init_weights`` zeroes the offset convs, as mmcv does, and then every
    offset is 0 and every mask 0.5: all bilinear weights are 0 or 1 and the
    sampling goes untested. Here the biases of the (dy, dx) channels are
    drawn from U(-OFFSET_BIAS_PX, OFFSET_BIAS_PX) and those of the mask logits from
    N(0, 1), and the weights from N(0, weight_std / sqrt(fan_in)), which
    adds a per-pixel part of std weight_std x the rms of the conv's input.
    Under ``init_weights`` the activations entering every DCN conv of r50
    have an rms near 40 (measured on random images at 128x352), so the
    default weight_std adds about 1 pixel (std 0.9 to 1.1) to a per-tap
    shift of up to 3; with BN statistics set from the data (as
    ``chip_smoke.py`` does) that rms is near 0.7, and weight_std = 1.5
    gives the same. So offsets are a few pixels,
    with fractional parts everywhere, and the taps of pixels near an edge
    reach past the plane.
    """
    rng = np.random.RandomState(seed)
    count = 0
    for module in model.modules():
        if isinstance(module, ModulatedDeformConv2dPack):
            conv = module.conv_offset
            fan_in = conv.weight[0].numel()
            w = rng.normal(0.0, weight_std / np.sqrt(fan_in), conv.weight.shape)
            b = np.concatenate([rng.uniform(-OFFSET_BIAS_PX, OFFSET_BIAS_PX, 18), rng.normal(0.0, 1.0, 9)])
            conv.weight.copy_(torch.from_numpy(w))
            conv.bias.copy_(torch.from_numpy(b))
            count += 1
    return count
