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


def evaluate_model_multiprocess(cfg, model: nn.Module, ds, batch_size: int = 1, classes=None) -> Dict[str, float]:
    """Full-split eval over the ranks of the process group; call it on every
    rank (`petr_tpu/train/evaluate.py:73-150`).

    Rank p decodes ``infos[p::nproc]`` on its own device with no mesh in
    context: the ranks run different numbers of eval steps, so a collective
    inside the decode (the token-sharded decoder's) would deadlock, which
    is why petr_tpu decodes under a one-device local mesh. Each rank pads
    its decode arrays to the common maximum, one ``all_gather_object``
    (pickled through the process group) makes every rank's detections
    visible, and every rank returns the same full-split metric dict. With
    fewer samples than ranks it raises on every rank (the split's size is
    known to all, so none is left waiting in the gather)."""
    import copy

    import torch.distributed as dist

    from petr_tpu_torch.parallel.mesh import use_mesh

    nproc = dist.get_world_size() if dist.is_initialized() else 1
    if nproc == 1:
        return evaluate_model(cfg, model, ds, batch_size, classes)
    pid = dist.get_rank()
    if len(ds.infos) < nproc:
        raise ValueError(f"evaluate_model_multiprocess: {len(ds.infos)} val samples < {nproc} processes: "
                         "every process would not get a shard")
    local_ds = copy.copy(ds)
    local_ds.infos = list(ds.infos)[pid::nproc]
    with use_mesh(None):
        tokens, det = _decode_dataset(cfg, model, local_ds, batch_size)

    n_max = (len(ds.infos) + nproc - 1) // nproc
    n_local = len(tokens)

    def pad(x):
        if n_local == n_max:
            return x
        return np.concatenate([x, np.zeros((n_max - n_local,) + x.shape[1:], x.dtype)], axis=0)

    payload = {k: pad(v) for k, v in det.items()}
    payload["n_valid"] = n_local
    gathered: List[Dict] = [None] * nproc
    dist.all_gather_object(gathered, payload)

    info_by_token = {info["token"]: info for info in ds.infos}
    preds = {}
    for p in range(nproc):
        toks = [info["token"] for info in list(ds.infos)[p::nproc]]
        if gathered[p]["n_valid"] != len(toks):
            raise RuntimeError(f"rank {p} decoded {gathered[p]['n_valid']} samples of {len(toks)}")
        det_p = {k: gathered[p][k] for k in DET_KEYS}
        preds.update(_preds_from_det(toks, det_p, info_by_token))
    gts = ground_truth_from_infos(ds.infos)
    if classes is not None:
        return evaluate_detections(gts, preds, classes=classes)
    return evaluate_detections(gts, preds)
