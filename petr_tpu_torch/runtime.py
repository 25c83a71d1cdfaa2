"""Replay of the port's serving artifacts without its model code.

An artifact (``serve.export.save_artifact``) is a zip of ``meta.json`` and
the ``torch.export`` program of the serving step (``program.pt2``), or, for
a streaming artifact (``save_streaming_artifact``), of the feature
extractor's and the head's (``feature.pt2``, ``head.pt2``). The programs call
the kernels as the port's ``torch.library`` ops (``petr_tpu_torch::*``), so
replaying one needs PyTorch and the op library that ``meta["ops"]`` names
(``petr_tpu_torch.ops``, which registers them and builds each kernel on its
first launch), and nothing of ``petr_tpu_torch.models``. Counterpart of
petr_tpu's ``load_artifact`` and ``StreamingArtifactRunner``
(`petr_tpu/serve/export.py:125-300`), whose StableHLO modules replay with
JAX alone.

An artifact exported without its weights also takes each int8 conv's
prepared operands (the BN folded in, quantised, tiled) after them:
``prepare_int8_operands`` makes them once, when the artifact is loaded, from
the weights it is given, with the op library's own functions.
"""

from __future__ import annotations

import importlib
import io
import json
import zipfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

SERVING_FORMAT = "petr_tpu_torch.serve/1"
STREAMING_FORMAT = "petr_tpu_torch.serve/streaming-1"


def _read(path: str, fmt: str, programs: Sequence[str]) -> Tuple[Dict[str, Any], list]:
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format") != fmt:
            raise ValueError(f"not a {fmt} artifact: {path} ({meta.get('format')!r})")
        importlib.import_module(meta["ops"])  # registers the kernels' ops
        eps = [torch.export.load(io.BytesIO(z.read(name))) for name in programs]
    return meta, eps


def prepare_int8_operands(meta: Dict[str, Any], program: str, params: Sequence[torch.Tensor]
                          ) -> Tuple[torch.Tensor, ...]:
    """The int8 convs' operands that ``program`` takes after the weights
    (``meta["int8_operands"]``), prepared from ``params`` (the state_dict's
    tensors in ``meta["param_names"]``' order) as the model prepares them."""
    specs = meta.get("int8_operands", {}).get(program, [])
    if not specs:
        return ()
    conv_int8 = importlib.import_module(meta["ops"] + ".conv_int8")
    index = {name: i for i, name in enumerate(meta["param_names"])}
    out = []
    with torch.no_grad():
        for spec in specs:
            weight, *norm = (params[index[name]] for name in (spec["weight"], *spec["norm"]))
            mul, add = conv_int8.fold_bn(*norm, spec["eps"])
            amax = torch.tensor(spec["amax"], dtype=torch.float32, device=weight.device)
            wq, sa, scale, add = conv_int8.prepare_operands(weight, mul, add, amax)
            out += [conv_int8.tile_weight(wq, bn) for bn in spec["bns"]] + [sa, scale, add]
    return tuple(out)


class _Program:
    """One loaded program (``program``, its file in the zip): array-likes in
    (moved to the artifact's device as fp32), tensors on the device out."""

    def __init__(self, ep, meta: Dict[str, Any], params: Optional[Sequence[torch.Tensor]], program: str):
        self.module = ep.module()
        self.device = torch.device(meta["device"])
        self.params = self.int8 = ()
        if not meta["embed_params"]:
            if params is None:
                raise ValueError("artifact exported without params; pass params= (the state_dict's tensors in order)")
            if len(params) != len(meta["param_names"]):
                raise ValueError(f"the artifact takes {len(meta['param_names'])} parameters, got {len(params)}")
            # each requires grad as the model's did at export: matmul's
            # folding of batch dimensions, hence its sum order, depends on it
            self.params = tuple(torch.as_tensor(p).detach().to(self.device).requires_grad_(g)
                                for p, g in zip(params, meta["param_requires_grad"]))
            self.int8 = prepare_int8_operands(meta, program, self.params)

    def tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)

    def __call__(self, *inputs):
        with torch.inference_mode():
            return self.module(*self.params, *self.int8, *inputs)


def load_artifact(path: str, params: Optional[Sequence[torch.Tensor]] = None
                  ) -> Tuple[Callable[..., Dict[str, torch.Tensor]], Dict[str, Any]]:
    """Load a serving artifact -> (fn, meta). ``fn(*inputs)`` takes the
    positional inputs of ``meta["input_spec"]`` (numpy arrays or tensors)
    and returns the decoded boxes, scores, labels and valid as tensors on
    ``meta["device"]``. Without ``meta["embed_params"]`` pass ``params``: the
    model's ``state_dict`` tensors in order (``meta["param_names"]``), on
    that device."""
    meta, (ep,) = _read(path, SERVING_FORMAT, ("program.pt2",))
    program = _Program(ep, meta, params, "program.pt2")
    n = len(meta["input_spec"])

    def fn(*inputs) -> Dict[str, torch.Tensor]:
        if len(inputs) != n:
            raise TypeError(f"the artifact serves {list(meta['input_spec'])}, got {len(inputs)} inputs")
        return program(*(program.tensor(a) for a in inputs))

    return fn, meta


class StreamingArtifactRunner:
    """Per-frame replay of a streaming artifact, no model code needed.

    Mirrors ``serve.StreamingPETRv2.step``: the previous frame's features
    stay on the device between frames, and the first frame of a scene (or
    after ``reset``) stands in for its own previous frame. Per-frame inputs:
    the current frame's 6 views (B, 6, H, W, 3), and img2lidar (B, 12, 4, 4),
    img_hw (B, 12, 2) and timestamp (B, 12) for all 12 views, current first.
    ``params`` as for ``load_artifact``."""

    def __init__(self, path: str, params: Optional[Sequence[torch.Tensor]] = None):
        self.meta, (feat, head) = _read(path, STREAMING_FORMAT, ("feature.pt2", "head.pt2"))
        self._feat = _Program(feat, self.meta, params, "feature.pt2")
        self._head = _Program(head, self.meta, params, "head.pt2")
        self._prev: Optional[torch.Tensor] = None

    def reset(self) -> None:
        """Drop the cached frame (a scene boundary)."""
        self._prev = None

    def step(self, images, img2lidar, img_hw, timestamp) -> Dict[str, torch.Tensor]:
        t = self._feat.tensor
        cur = self._feat(t(images))
        prev = cur if self._prev is None else self._prev
        out = self._head(cur, prev, t(img2lidar), t(img_hw), t(timestamp))
        self._prev = cur
        return out
