"""Evaluation over a dataset (the reference's mmcv EvalHook capability:
`evaluation = dict(interval=...)`, e.g. `petr_r50dcn_gridmask_p4.py:262`).

Counterpart of `petr_tpu/train/evaluate.py`: NMS-free decode of every
sample with the current weights, then the self-contained nuScenes metric
dict (mAP, NDS, the TP errors). The decode is ``train.make_eval_step`` on
the model's device, where petr_tpu jits its eval step.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from torch import nn

from petr_tpu_torch.data import Loader
from petr_tpu_torch.metrics.nuscenes import boxes_from_arrays, evaluate_detections, ground_truth_from_infos
from petr_tpu_torch.train.train_step import make_eval_step

DET_KEYS = ("boxes", "scores", "labels", "valid")


def _decode_dataset(cfg, model: nn.Module, ds, batch_size: int) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """Decode every sample of ``ds``; returns (tokens, stacked det arrays)."""
    loader = Loader(ds, batch_size, shuffle=False, drop_last=False)
    eval_step = make_eval_step(cfg)
    tokens: List[str] = []
    chunks: List[Dict[str, np.ndarray]] = []
    for batch in loader.epoch(0):
        toks = batch.pop("tokens")
        det = eval_step(model, batch)
        tokens.extend(toks)
        chunks.append({k: det[k].cpu().numpy() for k in DET_KEYS})
    if not chunks:
        return [], {}
    det = {k: np.concatenate([c[k] for c in chunks], axis=0)[: len(tokens)] for k in chunks[0]}
    return tokens, det


def _preds_from_det(tokens, det, info_by_token):
    return {
        tok: boxes_from_arrays(
            tok, det["boxes"][i], det["scores"][i], det["labels"][i],
            det["valid"][i], info=info_by_token.get(tok),
        )
        for i, tok in enumerate(tokens)
    }


def evaluate_model(cfg, model: nn.Module, ds, batch_size: int = 1, classes=None) -> Dict[str, float]:
    """Decode + metrics over ``ds`` (a test-mode NuScenesDataset) with
    ``model`` (in eval mode, on its device).

    ``classes`` restricts scoring (devkit semantics score ALL classes,
    counting no-GT classes as AP 0 — pass the present subset on restricted
    synthetic data)."""
    info_by_token = {info["token"]: info for info in ds.infos}
    tokens, det = _decode_dataset(cfg, model, ds, batch_size)
    preds = _preds_from_det(tokens, det, info_by_token)
    gts = ground_truth_from_infos(ds.infos)
    if classes is not None:
        return evaluate_detections(gts, preds, classes=classes)
    return evaluate_detections(gts, preds)


def evaluate_model_multiprocess(cfg, model: nn.Module, ds, batch_size: int = 1) -> Dict[str, float]:
    """petr_tpu's full-split eval over processes (`evaluate.py:73`): not
    ported yet."""
    raise NotImplementedError(
        "evaluate_model_multiprocess needs torch.distributed: ROADMAP.md §1, item 10 (parallel)")
