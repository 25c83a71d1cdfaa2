"""CPFPN — FPN whose 3x3 fusion conv exists only on level 0.

Counterpart of `petr_tpu/models/fpn.py` (reference `models/necks/cp_fpn.py`,
sty61010/PETR): 1x1 lateral convs on every input level, top-down nearest
upsample + add, a 3x3 fpn conv on level 0 only. Module names follow mmcv's
ConvModule (``lateral_convs.{i}.conv``, ``fpn_convs.0.conv``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from petr_tpu_torch.models.layers import Conv2d


def upsample_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize of NCHW ``x`` to ``size`` (H, W) with half-pixel
    centres, as `jax.image.resize(..., "nearest")` does: at a non-integer
    ratio ("nearest" would map 3 -> 5 as [0,0,1,1,2], this maps [0,0,1,2,2])."""
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


class ConvModule(nn.Module):
    """mmcv ConvModule without norm/activation: a conv under ``.conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel, padding=kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class CPFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, num_outs: int = 2):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(ConvModule(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList([ConvModule(out_channels, out_channels, 3)])

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest(
                laterals[i], laterals[i - 1].shape[-2:]
            )
        outs = [self.fpn_convs[0](laterals[0])] + laterals[1:]
        # extra levels by stride-2 1x1 max-pool (reference cp_fpn.py:193-196)
        while len(outs) < self.num_outs:
            outs.append(F.max_pool2d(outs[-1], 1, 2))
        return outs[: self.num_outs]
