"""Checkpoint save/restore with keep-last-k rotation.

Counterpart of `petr_tpu/train/checkpoint.py`, with its public functions
and its on-disk layout: ``base/step_%08d/`` per checkpoint, the newest
``max_keep`` kept, and ``meta.json`` beside the weights. Reference
semantics: mmcv CheckpointHook interval=1, max_keep_ckpts=3
(`petrv2_vovnet_gridmask_p4_800x320.py:263`), `load_from` partial init,
`resume_from` full state resume.

petr_tpu writes its state with orbax, which is JAX's. The port writes one
``torch.save`` file per checkpoint, ``state.pt``: ``{"model": state_dict,
"optimizer": optimizer.state_dict(), "step": int}``, read back with
``weights_only=True`` onto the model's device. A petr_tpu (orbax)
checkpoint cannot be read here: that needs orbax, which the port does not
depend on and the card's machine does not have (ROADMAP.md §1, item 11).
petr_tpu weights cross over through `utils/convert.py` instead.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch
from torch import nn

STATE_FILE = "state.pt"


def _ckpt_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def save_checkpoint(
    base: str, step: int, state: Any, max_keep: int = 3, meta: Optional[dict] = None
) -> str:
    """Save ``state`` (a ``train.TrainState``) as ``base/step_<step>/state.pt``
    and return that directory; ``meta`` (config, class names, version, as
    the reference embeds, `tools/train.py:233-243`) is written beside it as
    meta.json. Then only the newest ``max_keep`` step directories are kept."""
    os.makedirs(base, exist_ok=True)
    path = _ckpt_dir(base, step)
    os.makedirs(path, exist_ok=True)
    payload = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "step": int(state.step)}
    target = os.path.join(path, STATE_FILE)
    tmp = target + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, target)  # a reader never finds half a file
    if meta is not None:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
    kept = sorted(d for d in os.listdir(base) if d.startswith("step_"))
    for d in kept[:-max_keep]:
        shutil.rmtree(os.path.join(base, d), ignore_errors=True)
    return path


def save_params(path: str, model: nn.Module, meta: Optional[dict] = None) -> str:
    """Write ``model``'s weights alone as the checkpoint directory ``path``
    (``state.pt`` holding ``{"model": state_dict}``, and ``meta.json``):
    what ``load_params`` (``cli.test --ckpt``, ``cli.train --load-from``)
    reads; ``restore_checkpoint`` needs a training state and refuses it."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_FILE)
    tmp = target + ".tmp"
    torch.save({"model": model.state_dict()}, tmp)
    os.replace(tmp, target)
    if meta is not None:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
    return path


def latest_checkpoint(base: str) -> Optional[str]:
    if not os.path.isdir(base):
        return None
    kept = sorted(d for d in os.listdir(base) if d.startswith("step_"))
    return os.path.join(base, kept[-1]) if kept else None


def _read(path: str, model: nn.Module) -> Dict[str, Any]:
    device = next(model.parameters()).device
    return torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)


def _check_keys(model: nn.Module, weights: Dict[str, torch.Tensor], path: str) -> None:
    want, got = set(model.state_dict()), set(weights)
    missing, unexpected = sorted(want - got), sorted(got - want)
    if missing or unexpected:
        raise KeyError(f"checkpoint {path} does not match the model: missing keys {missing}, "
                       f"unexpected keys {unexpected}")


def restore_checkpoint(path: str, state: Any) -> Any:
    """Load the checkpoint directory ``path`` into ``state`` (weights, AdamW
    moments and step counts, the step) in place, and return it."""
    payload = _read(path, state.model)
    if "optimizer" not in payload:
        raise KeyError(f"checkpoint {path} holds weights only (save_params): load it with load_params")
    _check_keys(state.model, payload["model"], path)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


def load_params(path: str, model: nn.Module) -> nn.Module:
    """Load only the weights of the checkpoint directory ``path`` into
    ``model`` (load_from-style), strictly: a missing or unexpected key
    raises a KeyError that names it. Returns ``model``."""
    weights = _read(path, model)["model"]
    _check_keys(model, weights, path)
    model.load_state_dict(weights)
    return model
