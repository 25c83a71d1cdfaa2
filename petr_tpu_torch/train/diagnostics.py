"""Training-run diagnostics beyond scalar metrics.

Counterpart of `petr_tpu/train/diagnostics.py`. ``make_velocity_probe``
gives TP-matched velocity statistics on a val split: the check that tells
"the temporal pathway learns cross-frame correspondence" from "the
velocity head collapsed to v = 0" (petr_tpu's 8k-step PETRv2 synthetic run
scored mAVE 1.504 with a predicted-velocity std of 0.01 m/s). A temporal
run whose mAVE tracks the predict-zero baseline has not learned velocity,
whatever its mAP.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
from torch import nn

from petr_tpu_torch.data import Loader
from petr_tpu_torch.train.train_step import make_eval_step


def make_velocity_probe(
    cfg,
    ds,
    batch_size: int = 4,
    score_thr: float = 0.15,
    dist_thr: float = 2.0,
) -> Callable[[nn.Module], Dict[str, float]]:
    """A velocity probe over ``ds``, a test-mode dataset.

    The returned callable maps a model (in eval mode, on its device) to
    statistics over centre-distance-matched (GT, detection) pairs:
        tp          matched pair count
        vel_err     mean L2 velocity error of predictions
        zero_err    the predict-zero baseline on the SAME pairs (mean |v_gt|)
        pred_std    std of predicted velocity components (0.0 = collapsed)
        gt_std      std of GT velocity components
        corr_vx/vy  per-component Pearson correlation (0.0 when degenerate)

    A healthy temporal model shows vel_err < zero_err and corr >> 0.
    """
    eval_step = make_eval_step(cfg)
    loader = Loader(ds, batch_size, shuffle=False, drop_last=False)

    def probe(model: nn.Module) -> Dict[str, float]:
        pv, gv = [], []
        for batch in loader.epoch(0):
            batch.pop("tokens")
            gt = np.asarray(batch["gt_boxes"])
            gm = np.asarray(batch["gt_valid"])
            det = {k: v.cpu().numpy() for k, v in eval_step(model, batch).items()}
            for i in range(len(det["boxes"])):
                boxes = det["boxes"][i]
                keep = (det["scores"][i] > score_thr) & det["valid"][i]
                if not keep.any():
                    continue
                cand = boxes[keep]
                for g in gt[i][gm[i]]:
                    d = np.linalg.norm(cand[:, :2] - g[:2], axis=-1)
                    j = int(d.argmin())
                    if d[j] < dist_thr:
                        pv.append(cand[j, 7:9])
                        gv.append(g[7:9])
        if len(pv) < 3:
            return {"tp": float(len(pv))}
        pv_a, gv_a = np.asarray(pv), np.asarray(gv)
        out = {
            "tp": float(len(pv_a)),
            "vel_err": float(np.linalg.norm(pv_a - gv_a, axis=-1).mean()),
            "zero_err": float(np.linalg.norm(gv_a, axis=-1).mean()),
            "pred_std": float(pv_a.std()),
            "gt_std": float(gv_a.std()),
        }
        for k in range(2):
            c = 0.0
            if pv_a[:, k].std() > 1e-6 and gv_a[:, k].std() > 1e-6:
                c = float(np.corrcoef(pv_a[:, k], gv_a[:, k])[0, 1])
            out[f"corr_v{'xy'[k]}"] = c
        return out

    return probe
