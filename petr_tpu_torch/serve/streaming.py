"""Streaming PETRv2 inference with the previous frame's features cached.

Counterpart of `petr_tpu/serve/streaming.py`. PETRv2 sees two frames as 12
views: the current frame's 6, then the previous frame's 6. The reference
runs the backbone on all 12 every sample (`petr3d.py:84-85`); a stream has
computed the previous frame's features one step ago. So ``step`` runs the
backbone and neck (``PETRDetector.extract_feats``) on the 6 new views only,
puts the cached features of the previous frame after them, and runs the
head (``forward_head``). That is exact: backbone features depend on the
pixels alone, and the ego motion enters through the current-frame-aligned
``img2lidar`` and the timestamps, which the head reads every frame.

At a scene's start ``prime`` caches the stored previous sweep's views;
without one the current frame stands in for the previous one (the
reference's ``pad_empty_sweeps``), and ``self_padded_timestamp`` gives the
timestamps the data layer would.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from petr_tpu_torch.configs.config import ExperimentConfig
from petr_tpu_torch.models.detector import PETRDetector
from petr_tpu_torch.ops.nms_free import nms_free_decode
from petr_tpu_torch.quant.ptq import apply_scales
from petr_tpu_torch.serve.export import resolve_device


class StreamingPETRv2:
    """Stateful per-frame runner of a 2-frame (12-view) PETRv2 model.

    ``model`` is the serving detector (``build_detector(cfg)``); it moves to
    ``device``. ``quant_scales`` (petr_tpu's "quant" tree) switches its
    backbone to int8 with those scales (``quant.apply_scales``). With
    ``decode`` a step returns the decoded boxes of the last
    decoder layer (``boxes``, ``scores``, ``labels``, ``valid``), otherwise
    the per-layer ``cls_logits`` and ``bbox_codes``; tensors on ``device``.

    Per-frame inputs to ``step`` (numpy arrays or tensors):
      images:    (B, 6, H, W, 3), the current frame's normalised views only;
      img2lidar: (B, 12, 4, 4), current 6 first, previous 6 after, both in
                 the current frame's lidar coordinates (``align_prev_lidar2img``);
      img_hw:    (B, 12, 2);
      timestamp: (B, 12) lidar-relative seconds (needed with ``with_time``).
    """

    num_cams = 6

    def __init__(self, cfg: ExperimentConfig, model: PETRDetector, *, decode: bool = True,
                 quant_scales=None, device: Union[str, torch.device] = "cuda"):
        if cfg.data.num_frames < 2:
            raise ValueError(f"StreamingPETRv2 needs a 2-frame config, got num_frames="
                             f"{cfg.data.num_frames} ({cfg.name})")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        if quant_scales is not None:  # the int8 PTQ backbone for the per-frame features
            apply_scales(self.model, quant_scales)
        self.decode = decode
        self.input_hw = tuple(cfg.data.image_size)
        self._prev_feats: Optional[torch.Tensor] = None

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def reset(self) -> None:
        """Drop the cached frame (a scene boundary)."""
        self._prev_feats = None

    def prime(self, images) -> None:
        """Cache the features of the PREVIOUS frame's 6 views (a scene's
        start, from its stored sweep), so that the first ``step`` equals the
        full 12-view forward."""
        with torch.inference_mode():
            self._prev_feats = self.model.extract_feats(self._tensor(images))

    def step(self, images, img2lidar, img_hw, timestamp=None) -> Dict[str, torch.Tensor]:
        images = self._tensor(images)
        if images.shape[1] != self.num_cams:
            raise ValueError(f"step expects the current frame's {self.num_cams} views, got "
                             f"{images.shape[1]}: pass 6 views; the previous 6 are cached")
        with torch.inference_mode():
            cur = self.model.extract_feats(images)
            prev = cur if self._prev_feats is None else self._prev_feats
            out = self.model.forward_head(
                torch.cat([cur, prev], dim=1), self._tensor(img2lidar), self._tensor(img_hw), self.input_hw,
                timestamp=None if timestamp is None else self._tensor(timestamp))
            self._prev_feats = cur
            if not self.decode:
                return out
            return nms_free_decode(
                out["cls_logits"][-1], out["bbox_codes"][-1], max_num=self.cfg.max_det,
                num_classes=self.cfg.model.head.num_classes, post_center_range=self.cfg.post_center_range,
                score_threshold=self.cfg.score_threshold)


def lidar2global(l2e_rot, l2e_trans, e2g_rot, e2g_trans) -> np.ndarray:
    """4x4 lidar->global from the calibrated-sensor and ego-pose (R, t)
    pairs, in fp64 (`petr_tpu/serve/streaming.py::lidar2global`)."""
    l2e = np.eye(4)
    l2e[:3, :3] = np.asarray(l2e_rot, np.float64)
    l2e[:3, 3] = np.asarray(l2e_trans, np.float64)
    e2g = np.eye(4)
    e2g[:3, :3] = np.asarray(e2g_rot, np.float64)
    e2g[:3, 3] = np.asarray(e2g_trans, np.float64)
    return e2g @ l2e


def align_prev_lidar2img(prev_lidar2img: np.ndarray, prev_lidar2global: np.ndarray,
                         cur_lidar2global: np.ndarray) -> np.ndarray:
    """A previous frame's lidar2img (..., N, 4, 4) re-expressed in the
    CURRENT lidar frame: current lidar -> global -> previous lidar ->
    previous image, in fp64 (the matrices are inverted downstream)."""
    cur2prev = np.linalg.inv(np.asarray(prev_lidar2global, np.float64)) @ np.asarray(cur_lidar2global, np.float64)
    return np.asarray(prev_lidar2img, np.float64) @ cur2prev


def self_padded_timestamp(timestamp_6: np.ndarray, sweep_range=(3, 27)) -> np.ndarray:
    """A scene's first (B, 12) timestamps from the current frame's (B, 6):
    the padded previous frame repeats the current one, offset by the mean
    sweep time, as the data layer pads (reference `loading.py:69-78`)."""
    lo, hi = sweep_range
    mean_time = (lo + hi) / 2.0 * 0.083
    t = np.asarray(timestamp_6, dtype=np.float64)
    return np.concatenate([t, t + mean_time], axis=1)
