"""Checkpoint publishing (reference `tools/model_converters/publish_model.py`):
strip the optimizer state, keep the weights only, append a content-hash tag.

Counterpart of `petr_tpu/utils/publish.py`, on the port's checkpoints
(``state.pt`` of ``train.checkpoint``, not orbax): the model's
``state_dict`` alone goes to ``name-<8 hex of its sha256>.pt``.
"""

from __future__ import annotations

import hashlib
import io
import os
from typing import Dict

import torch

from petr_tpu_torch.train.checkpoint import STATE_FILE


def publish_checkpoint(ckpt_dir: str, out_path: str) -> str:
    """Read a port checkpoint directory (``save_checkpoint`` or
    ``save_params``), write its weights alone to ``out_path`` with a
    sha256 tag before the extension (``name-<8hex>.pt``); returns that path."""
    state = torch.load(os.path.join(ckpt_dir, STATE_FILE), map_location="cpu", weights_only=True)
    buf = io.BytesIO()
    torch.save({"model": state["model"]}, buf)
    blob = buf.getvalue()
    tag = hashlib.sha256(blob).hexdigest()[:8]
    base, ext = os.path.splitext(out_path)
    final = f"{base}-{tag}{ext or '.pt'}"
    with open(final, "wb") as f:
        f.write(blob)
    return final


def load_published(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a published file (``model.load_state_dict`` takes it)."""
    return torch.load(path, map_location="cpu", weights_only=True)["model"]
