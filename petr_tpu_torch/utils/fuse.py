"""Conv + frozen-BN folding (reference `tools/misc/fuse_conv_bn.py` capability).

Counterpart of `petr_tpu/utils/fuse.py`. With frozen statistics a BN is the
affine map y = x * mul + add, mul = weight / sqrt(var + eps), add = bias -
mean * mul. Folding multiplies the preceding (bias-free) conv's output
channels by ``mul`` and leaves the BN as identity statistics (weight 1,
mean 0, var 1) with ``add`` as its bias, so the module structure and the
``state_dict``'s keys stay as they are. As in petr_tpu, the BN still divides
by sqrt(1 + eps) after folding.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _pairs(sd: Mapping[str, torch.Tensor]):
    """(conv weight key, BN key prefix) of every conv + BN pair petr_tpu folds:
    ConvBNReLU's ``{name}/conv`` + ``{name}/norm``, and ResNet's ``conv{i}`` +
    ``bn{i}`` and ``downsample.0`` + ``downsample.1``. A DCN ``conv2`` is left
    alone, as petr_tpu's fold leaves its ``conv2_weight`` (no ``conv2`` node)."""
    for key in sd:
        m = re.fullmatch(r"(.*)/conv\.weight", key)
        if m:
            yield key, f"{m.group(1)}/norm."
            continue
        m = re.fullmatch(r"(.*?)(^|\.)conv(\d)\.weight", key)
        if m:
            pre = m.group(1) + m.group(2)
            if m.group(3) == "2" and f"{pre}conv2.conv_offset.weight" in sd:
                continue
            yield key, f"{pre}bn{m.group(3)}."
            continue
        m = re.fullmatch(r"(.*\.)downsample\.0\.weight", key)
        if m:
            yield key, f"{m.group(1)}downsample.1."


def fold_frozen_bn(state_dict: Mapping[str, torch.Tensor], eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """A new ``state_dict`` with every conv + frozen-BN pair folded (fp32,
    on the CPU); other entries are kept as they are. The arithmetic is
    numpy's in fp32, as petr_tpu's (numpy's sqrt rounds correctly; torch's
    vectorised CPU sqrt may not, by an ulp)."""
    out = {k: v for k, v in state_dict.items()}
    for conv_key, bn in _pairs(state_dict):
        if not all(bn + leaf in state_dict for leaf in _BN_LEAVES):
            continue
        w, b, mean, var = (state_dict[bn + leaf].detach().float().cpu().numpy() for leaf in _BN_LEAVES)
        mul = w / np.sqrt(var + np.float32(eps))
        add = b - mean * mul
        kernel = state_dict[conv_key].detach().float().cpu().numpy()
        out[conv_key] = torch.from_numpy(kernel * mul.reshape(-1, *[1] * (kernel.ndim - 1)))
        out[bn + "weight"] = torch.ones(w.shape)
        out[bn + "bias"] = torch.from_numpy(add)
        out[bn + "running_mean"] = torch.zeros(mean.shape)
        out[bn + "running_var"] = torch.ones(var.shape)
    return out
