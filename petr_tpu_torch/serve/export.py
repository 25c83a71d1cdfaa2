"""Serving step: forward + NMS-free decode of the last decoder layer.

Counterpart of `petr_tpu/serve/export.py::make_serving_fn`; its decode,
``decode_last_layer``, is also the eval step's
(`train/train_step.py::make_eval_step`). petr_tpu exports the jitted
step as a StableHLO artifact; PyTorch runs eagerly, so here the step is a
plain function over a model that lives on the device. It takes and returns
numpy arrays.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple, Union

import numpy as np
import torch

from petr_tpu_torch.configs.config import ExperimentConfig, eval_model_config
from petr_tpu_torch.models.detector import PETRDetector, init_weights
from petr_tpu_torch.ops.nms_free import nms_free_decode


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device to run on; raises rather than fall back to the CPU when
    CUDA is asked for and there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def build_detector(
    cfg: ExperimentConfig, seed: int = 0, device: Union[str, torch.device] = "cuda"
) -> PETRDetector:
    """The serving (eval-config) detector of ``cfg`` with random weights drawn
    from ``seed``, on ``device``, in eval mode."""
    device = resolve_device(device)
    model = init_weights(PETRDetector(eval_model_config(cfg.model)), seed)
    return model.to(device).eval()


def decode_last_layer(cfg: ExperimentConfig, outputs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``nms_free_decode`` of the last decoder layer of the detector's
    outputs, with ``cfg``'s limits; the serving step and the eval step
    (`train/train_step.py::make_eval_step`) share it."""
    return nms_free_decode(
        outputs["cls_logits"][-1],
        outputs["bbox_codes"][-1],
        max_num=cfg.max_det,
        num_classes=cfg.model.head.num_classes,
        post_center_range=cfg.post_center_range,
        score_threshold=cfg.score_threshold,
    )


def serving_input_spec(cfg: ExperimentConfig, batch_size: int = 1) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """The serving call's positional inputs in order -> (shape, dtype):
    images, img2lidar, img_hw, and timestamp for a 2-frame config
    (`petr_tpu/serve/export.py:31-46`). Its keys are ``InferenceServer``'s
    ``input_keys``."""
    N = cfg.data.num_views * cfg.data.num_frames
    H, W = cfg.data.image_size
    spec = {
        "images": ((batch_size, N, H, W, 3), "float32"),
        "img2lidar": ((batch_size, N, 4, 4), "float32"),
        "img_hw": ((batch_size, N, 2), "float32"),
    }
    if cfg.data.num_frames > 1:
        spec["timestamp"] = ((batch_size, N), "float32")
    return spec


def make_serving_fn(
    cfg: ExperimentConfig,
    model: PETRDetector,
    device: Union[str, torch.device] = "cuda",
) -> Callable[..., Dict[str, np.ndarray]]:
    """``fn(images, img2lidar, img_hw)``, or ``fn(images, img2lidar, img_hw,
    timestamp)`` for a 2-frame config (PETRv2), over batched numpy inputs
    in petr_tpu's layout (``serving_input_spec``) -> dict of numpy boxes
    (B, max_det, 9), scores, labels and valid (B, max_det). Moves ``model``
    to ``device``."""
    if cfg.model.head.kind == "depthr":
        raise NotImplementedError(
            "the depthr head needs GT depth at test time (oracle); it has no serving path"
        )
    device = resolve_device(device)
    model = model.to(device).eval()
    n_inputs = len(serving_input_spec(cfg))

    def fn(*inputs) -> Dict[str, np.ndarray]:
        if len(inputs) != n_inputs:
            raise TypeError(f"{cfg.name} serves {list(serving_input_spec(cfg))}, got {len(inputs)} inputs")
        with torch.inference_mode():
            args = [torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device) for a in inputs]
            out = model(*args[:3], timestamp=args[3] if n_inputs == 4 else None)
            return {k: v.cpu().numpy() for k, v in decode_last_layer(cfg, out).items()}

    return fn
