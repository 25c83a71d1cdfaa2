"""Calibration, scale persistence and the switch to the int8 backbone.

Counterpart of `petr_tpu/quant/ptq.py`. Calibration runs the detector with
its quantised convs in "calib" mode: each records the running max |x| of
its input over the calibration batches (``models.layers.QuantConv2d``).
The result is petr_tpu's "quant" tree, and ``save_scales`` writes petr_tpu's
``.npz`` keys (``backbone/stem1/act_amax``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Mapping

import numpy as np
import torch
from torch import nn

from petr_tpu_torch.configs.config import ExperimentConfig, eval_model_config
from petr_tpu_torch.models.layers import QuantConv2d
from petr_tpu_torch.utils.convert import flatten_quant_tree, quant_scales_from_port, quant_scales_to_port


def quant_convs(model: nn.Module) -> Dict[str, QuantConv2d]:
    """The quantisable convs of ``model`` by module name (99 in V-99: the
    stem's 3, and 6 per OSA block); raises if there are none (a ResNet
    backbone, which petr_tpu does not quantise either)."""
    convs = {name: m for name, m in model.named_modules() if isinstance(m, QuantConv2d)}
    if not convs:
        raise NotImplementedError("backbone.quant is only supported for the VoVNet backbone")
    return convs


def set_quant(model: nn.Module, mode: str) -> nn.Module:
    """Every quantisable conv of ``model`` to ``mode`` ("none", "calib" or
    "int8"); their recorded maxima stay as they are."""
    for conv in quant_convs(model).values():
        conv.set_quant(mode)
    return model


def scales_of(model: nn.Module) -> Dict[str, Any]:
    """The recorded maxima of ``model``'s quantised convs as petr_tpu's
    "quant" tree of fp32 numpy arrays."""
    convs = quant_convs(model)
    missing = [name for name, conv in convs.items() if conv.quant == "none"]
    if missing:
        raise ValueError(f"convs never set to calib or int8: {missing[:3]}...")
    return quant_scales_from_port({name: conv.act_amax.detach().cpu().numpy() for name, conv in convs.items()})


@torch.no_grad()
def apply_scales(model: nn.Module, quant_tree: Mapping[str, Any], mode: str = "int8") -> nn.Module:
    """Load petr_tpu's "quant" tree into ``model``'s quantised convs and set
    them to ``mode`` (the int8 backbone by default). Raises on a conv the
    tree lacks and on a leaf no conv takes. Call it outside
    ``torch.inference_mode``: the maxima are buffers the model keeps."""
    convs = quant_convs(model)
    for name, amax in quant_scales_to_port(quant_tree, convs).items():
        conv = convs[name]
        conv.set_quant(mode)
        conv.act_amax.copy_(torch.tensor(np.asarray(amax), dtype=torch.float32))
    return model


def _as_inputs(batch: Mapping[str, Any], device: torch.device):
    def t(key):
        return torch.as_tensor(np.asarray(batch[key]), dtype=torch.float32).to(device)

    ts = t("timestamp") if batch.get("timestamp") is not None else None
    return (t("images"), t("img2lidar"), t("img_hw")), ts


def calibrate(model: nn.Module, batches: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
    """Run calibration ``batches`` (dicts with images, img2lidar, img_hw and
    optionally timestamp, numpy or tensors) through ``model`` in eval mode
    with its quantised convs in "calib" mode -> petr_tpu's "quant" tree of
    each conv's max |x| over all batches. The convs' modes are restored
    after; their maxima hold the result."""
    convs = quant_convs(model)
    modes = {name: conv.quant for name, conv in convs.items()}
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    set_quant(model, "calib")
    with torch.no_grad():
        for conv in convs.values():
            conv.act_amax.zero_()
    n = 0
    try:
        for batch in batches:
            args, ts = _as_inputs(batch, device)
            with torch.no_grad():
                model(*args, timestamp=ts)
            n += 1
        if n == 0:
            raise ValueError("calibrate() needs at least one batch")
        return scales_of(model)
    finally:
        for name, conv in convs.items():
            conv.set_quant(modes[name])
        model.train(was_training)


def calibrate_detector(cfg: ExperimentConfig, model: nn.Module, batches: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
    """Calibrate the detector of ``cfg`` with ``model``'s weights (any quant
    setting) on ``batches`` -> petr_tpu's "quant" tree. As petr_tpu's, the
    pass runs ``eval_model_config`` (a ``bn_mode="batch"`` model calibrates on
    its running statistics) with the backbone in "calib" mode, on a copy
    built on ``model``'s device: ``model`` itself is not changed."""
    from petr_tpu_torch.models.detector import PETRDetector

    mcfg = eval_model_config(cfg.model)
    mcfg = dataclasses.replace(mcfg, backbone=dataclasses.replace(mcfg.backbone, quant="calib"))
    device = next(model.parameters()).device
    calib = PETRDetector(mcfg)
    calib.load_state_dict(model.state_dict())
    return calibrate(calib.to(device), batches)


def save_scales(path: str, quant_tree: Mapping[str, Any]) -> None:
    """Write a "quant" tree as an ``.npz`` of path-keyed arrays, petr_tpu's
    ``save_scales`` keys."""
    np.savez(path, **flatten_quant_tree(quant_tree))


def load_scales(path: str) -> Dict[str, Any]:
    """An ``.npz`` of ``save_scales`` (either package's) -> the "quant" tree
    of fp32 numpy arrays."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v, dtype=np.float32)
    return tree
