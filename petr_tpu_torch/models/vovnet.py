"""VoVNetV2 backbone (OSA modules + eSE), NCHW, frozen or batch-moments BN.

Counterpart of `petr_tpu/models/vovnet.py` (reference
`models/backbones/vovnet.py`, sty61010/PETR), with the reference's module
names: ``stem.stem_{i}/conv``, ``stage{s}.OSA{s}_{b}.layers.{i}``,
``.concat``, ``.ese.fc``. V-99-eSE is the flagship backbone. With ``remat``
each OSA block is a ``torch.utils.checkpoint`` region in training, as
VoVNetCP's (`petr_tpu/models/vovnet.py:124`). ``quant`` (int8 PTQ) reaches
the stem's three convs and every OSA 3x3 and concat 1x1 conv, as petr_tpu's
(`vovnet.py:88-96,120-122,138`): 3 + 6 per block, 99 in V-99.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from petr_tpu_torch.models.layers import Conv2d, ConvBNReLU, conv_bn_act

SPECS: Dict[str, Dict] = {
    "V-99-eSE": {
        "stem": (64, 64, 128),
        "stage_conv_ch": (128, 160, 192, 224),
        "stage_out_ch": (256, 512, 768, 1024),
        "layer_per_block": 5,
        "block_per_stage": (1, 3, 9, 3),
        "eSE": True,
    },
    "V-39-eSE": {
        "stem": (64, 64, 128),
        "stage_conv_ch": (128, 160, 192, 224),
        "stage_out_ch": (256, 512, 768, 1024),
        "layer_per_block": 5,
        "block_per_stage": (1, 1, 2, 2),
        "eSE": True,
    },
}


def hsigmoid(x: torch.Tensor) -> torch.Tensor:
    return (x + 3.0).clamp(0.0, 6.0) / 6.0


class ESE(nn.Module):
    """Effective squeeze-excite: hsigmoid(conv1x1(avgpool)) channel gate."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * hsigmoid(self.fc(x.mean(dim=(-2, -1), keepdim=True)))


class OSABlock(nn.Module):
    """One-shot aggregation: k sequential 3x3 convs, concat all, 1x1 project,
    eSE gate, optional identity."""

    def __init__(
        self, name: str, in_ch: int, stage_ch: int, concat_ch: int,
        layer_per_block: int, identity: bool = False, use_ese: bool = True,
        bn_mode: str = "frozen", quant: str = "none",
    ):
        super().__init__()
        self.identity = identity
        self.layers = nn.ModuleList(
            ConvBNReLU(f"{name}_{i}", in_ch if i == 0 else stage_ch, stage_ch, bn_mode=bn_mode, quant=quant)
            for i in range(layer_per_block)
        )
        self.concat = ConvBNReLU(
            f"{name}_concat", in_ch + layer_per_block * stage_ch, concat_ch, kernel=1, bn_mode=bn_mode,
            quant=quant,
        )
        self.ese = ESE(concat_ch) if use_ese else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        y = x
        for layer in self.layers:
            y = layer(y)
            feats.append(y)
        y = self.concat(torch.cat(feats, dim=1))
        if self.ese is not None:
            y = self.ese(y)
        if self.identity:
            y = y + x
        return y


class Stem(nn.Sequential):
    """The stem's three ConvBNReLUs as one flat Sequential of their children
    (``stem_{i}/conv``, ``/norm``, ``/relu``), the reference's keys; each
    triple runs as a ConvBNReLU does, off the K5 route (the stem stays on
    cuDNN, its first conv at stride 2)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mods = list(self)
        for i in range(0, len(mods), 3):
            x = conv_bn_act(mods[i], mods[i + 1], mods[i + 2], x, fused_route=False)
        return x


class VoVNet(nn.Module):
    """VoVNetV2; returns features for ``out_indices`` (0..3 = stage2..stage5,
    strides 4/8/16/32). ``bn_mode`` is "frozen" or "batch" (see
    ``FrozenBatchNorm``); ``quant`` "none", "calib" or "int8" (see
    ``QuantConv2d``)."""

    def __init__(self, spec: str = "V-99-eSE", out_indices: Sequence[int] = (2, 3),
                 remat: bool = False, bn_mode: str = "frozen", quant: str = "none"):
        super().__init__()
        s = SPECS[spec]
        self.out_indices = tuple(out_indices)
        self.remat = remat
        s0, s1, s2 = s["stem"]
        stem = [
            ConvBNReLU("stem_1", 3, s0, stride=2, bn_mode=bn_mode, quant=quant),
            ConvBNReLU("stem_2", s0, s1, stride=1, bn_mode=bn_mode, quant=quant),
            ConvBNReLU("stem_3", s1, s2, stride=2, bn_mode=bn_mode, quant=quant),
        ]
        # one flat Sequential, as the reference's `stem.stem_{i}/conv` keys need
        self.stem = Stem(
            OrderedDict((n, m) for c in stem for n, m in c.named_children())
        )
        in_ch = s2
        for stage in range(4):
            blocks = OrderedDict()
            for b in range(s["block_per_stage"][stage]):
                name = f"OSA{stage + 2}_{b + 1}"
                blocks[name] = OSABlock(
                    name, in_ch, s["stage_conv_ch"][stage], s["stage_out_ch"][stage],
                    s["layer_per_block"], identity=b > 0, use_ese=s["eSE"], bn_mode=bn_mode,
                    quant=quant,
                )
                in_ch = s["stage_out_ch"][stage]
            self.add_module(f"stage{stage + 2}", nn.Sequential(blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        remat = self.remat and self.training and torch.is_grad_enabled()
        outs = []
        for stage in range(4):
            if stage > 0:
                # ceil-mode 3x3/2 max-pool (reference `vovnet.py:243`)
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            for block in getattr(self, f"stage{stage + 2}"):
                x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            if stage in self.out_indices:
                outs.append(x)
        return outs
