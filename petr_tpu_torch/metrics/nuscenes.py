"""Self-contained nuScenes detection metrics (mAP / TP-errors / NDS).

The reference delegates evaluation to the nuscenes-devkit
(`CustomNuScenesDataset.evaluate` -> devkit). This module re-implements the
official algorithm (center-distance matching at {0.5, 1, 2, 4} m, 101-point
interpolated AP with min recall/precision 0.1, cumulative-mean TP errors at
2 m, NDS = (5*mAP + sum(1 - min(1, err))) / 10) so the engine evaluates
without the devkit. Distances/errors are computed in the lidar frame, which
is equivalent to the devkit's global frame for all the metrics used
(rigid-transform invariant).

Devkit-conformance notes:
  * classes with no GT anywhere are scored like the devkit's
    `DetectionMetricData.no_predictions()` — AP 0 and TP errors 1.0 are
    INCLUDED in mAP / the mean TP errors (this is why tiny synthetic evals
    that cover few classes report low absolute numbers; pass a restricted
    ``classes`` tuple to score only the classes present).
  * the per-class eval-range filter uses the box's distance from the EGO
    frame origin when ``ego_dist`` is set (devkit `filter_eval_boxes` uses
    the global-frame xy displacement from the ego pose; the ego-frame xy
    norm differs only by vehicle roll/pitch — centimeters). When ``ego_dist``
    is absent it falls back to the lidar-origin distance (~1 m bias: the
    LIDAR_TOP mount offset).
  * the devkit's bikes-in-bike-rack GT removal needs the map layer and is
    not reproduced.

Inputs are plain per-sample lists of DetectionBox, so this evaluates both our
model outputs and imported reference results identically.

The port's copy of `petr_tpu/metrics/nuscenes.py` (numpy only), unchanged.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from petr_tpu_torch.configs.config import NUSCENES_CLASSES

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_DIST = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_INTERP = 101

# official per-class eval range (meters from ego)
CLS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}
# classes where a TP metric is undefined (official devkit)
NO_VELOCITY = {"barrier", "traffic_cone"}
NO_ORIENT = {"traffic_cone"}
NO_ATTR = {"barrier", "traffic_cone"}
PERIOD_PI = {"barrier"}


@dataclasses.dataclass
class DetectionBox:
    sample_token: str
    center: np.ndarray  # (3,) gravity center, lidar frame
    size: np.ndarray  # (3,) w, l, h
    yaw: float
    velocity: np.ndarray  # (2,)
    name: str
    score: float = -1.0
    attr: str = ""
    num_pts: int = -1  # GT only; -1 = unknown
    ego_dist: float = -1.0  # xy distance from the ego origin; -1 = unknown


def _center_dist(a: DetectionBox, b: DetectionBox) -> float:
    return float(np.hypot(a.center[0] - b.center[0], a.center[1] - b.center[1]))


def _scale_err(a: DetectionBox, b: DetectionBox) -> float:
    """1 - IoU of center/yaw-aligned boxes (pure size IoU)."""
    mins = np.minimum(a.size, b.size)
    inter = float(np.prod(mins))
    union = float(np.prod(a.size) + np.prod(b.size) - inter)
    return 1.0 - inter / max(union, 1e-9)


def _yaw_err(a: DetectionBox, b: DetectionBox, period: float) -> float:
    d = (a.yaw - b.yaw) % period
    if d > period / 2:
        d = period - d
    return abs(d)


def _vel_err(a: DetectionBox, b: DetectionBox) -> float:
    return float(np.linalg.norm(np.asarray(a.velocity) - np.asarray(b.velocity)))


def _cummean(x: np.ndarray) -> np.ndarray:
    if len(x) == 0:
        return x
    x = x.astype(float)
    # official devkit `cummean`: an all-NaN series (e.g. attribute errors
    # when every matched GT lacks an attribute) is the WORST case -> ones
    if np.isnan(x).all():
        return np.ones(len(x))
    # official: ignore NaNs (attribute errors on unlabeled GTs)
    sum_vals = np.nancumsum(x)
    count_vals = np.cumsum(~np.isnan(x))
    return np.divide(sum_vals, count_vals, out=np.zeros_like(sum_vals), where=count_vals > 0)


def _filter(boxes: Sequence[DetectionBox], is_gt: bool) -> List[DetectionBox]:
    out = []
    for b in boxes:
        if b.name not in CLS_RANGE:
            continue
        dist = b.ego_dist if b.ego_dist >= 0 else float(np.hypot(b.center[0], b.center[1]))
        if dist > CLS_RANGE[b.name]:
            continue
        if is_gt and b.num_pts == 0:
            continue
        out.append(b)
    return out


def _accumulate(
    gts: Dict[str, List[DetectionBox]],
    preds: Dict[str, List[DetectionBox]],
    cls: str,
    dist_th: float,
):
    """Official `accumulate`: returns interpolated precision + TP-error
    curves on the 101-point recall grid.

    A class with no GT anywhere returns the devkit's
    `DetectionMetricData.no_predictions()` equivalent (precision 0,
    confidence 0, TP errors 1) — it is NOT skipped; the zeros/ones flow
    into mAP and the mean TP errors exactly as in the devkit."""
    cls_gts = {tok: [g for g in boxes if g.name == cls] for tok, boxes in gts.items()}
    npos = sum(len(v) for v in cls_gts.values())
    if npos == 0:
        return _NO_PREDICTIONS()

    cls_preds = [p for boxes in preds.values() for p in boxes if p.name == cls]
    cls_preds.sort(key=lambda p: -p.score)

    tp, fp, conf = [], [], []
    match_data = defaultdict(list)
    taken = set()
    for p in cls_preds:
        best_gt, best_d = None, dist_th
        for gi, g in enumerate(cls_gts.get(p.sample_token, [])):
            if (p.sample_token, gi) in taken:
                continue
            d = _center_dist(p, g)
            if d < best_d:
                best_d, best_gt = d, gi
        if best_gt is not None:
            taken.add((p.sample_token, best_gt))
            tp.append(1)
            fp.append(0)
            conf.append(p.score)
            g = cls_gts[p.sample_token][best_gt]
            match_data["trans_err"].append(best_d)
            match_data["scale_err"].append(_scale_err(p, g))
            match_data["orient_err"].append(
                _yaw_err(p, g, np.pi if cls in PERIOD_PI else 2 * np.pi)
            )
            match_data["vel_err"].append(_vel_err(p, g))
            match_data["attr_err"].append(
                np.nan if not g.attr else float(p.attr != g.attr)
            )
            match_data["conf"].append(p.score)
        else:
            tp.append(0)
            fp.append(1)
            conf.append(p.score)

    if len(match_data["conf"]) == 0:
        # no matches at all: AP 0, TP errors undefined -> worst (1.0)
        return _NO_PREDICTIONS()

    tp_c = np.cumsum(tp).astype(float)
    fp_c = np.cumsum(fp).astype(float)
    prec = tp_c / (tp_c + fp_c)
    rec = tp_c / npos

    rec_interp = np.linspace(0, 1, N_INTERP)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf, right=0)

    out = {"precision": prec_i, "confidence": conf_i}
    for key in ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err"):
        vals = _cummean(np.asarray(match_data[key], float))
        mconf = np.asarray(match_data["conf"], float)
        # interpolate cumulative means onto the recall grid via confidence
        out[key] = np.interp(conf_i[::-1], mconf[::-1], vals[::-1])[::-1]
    return out


def _NO_PREDICTIONS():
    """Devkit `DetectionMetricData.no_predictions()`: precision/confidence 0,
    every TP error 1."""
    return {
        "precision": np.zeros(N_INTERP),
        "confidence": np.zeros(N_INTERP),
        **{k: np.ones(N_INTERP)
           for k in ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")},
    }


def _calc_ap(md) -> float:
    prec = md["precision"].copy()
    prec = prec[round(100 * MIN_RECALL) + 1 :]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def _calc_tp(md, name: str) -> float:
    first = round(100 * MIN_RECALL) + 1
    # devkit `max_recall_ind`: the LAST index with nonzero interpolated
    # confidence (not round(100*max_recall) — interp zeroes strictly beyond
    # max recall, so these differ by one grid point at the boundary)
    nonzero = np.nonzero(md["confidence"])[0]
    last = int(nonzero[-1]) if len(nonzero) else 0
    if last < first:
        return 1.0
    return float(np.mean(md[name][first : last + 1]))


def evaluate_detections(
    gts: Dict[str, List[DetectionBox]],
    preds: Dict[str, List[DetectionBox]],
    classes: Sequence[str] = NUSCENES_CLASSES,
) -> Dict[str, float]:
    """Full nuScenes detection evaluation.

    Args:
        gts/preds: sample_token -> boxes.
    Returns:
        dict with mAP, NDS, per-class AP, and the five mean TP errors.
    """
    gts = {tok: _filter(v, is_gt=True) for tok, v in gts.items()}
    # devkit asserts <=500 boxes/sample; we keep the highest-scoring 500
    preds = {
        tok: sorted(_filter(v, is_gt=False), key=lambda b: -b.score)[:500]
        for tok, v in preds.items()
    }

    ap: Dict[str, Dict[float, float]] = defaultdict(dict)
    tp_err: Dict[str, Dict[str, float]] = defaultdict(dict)
    for cls in classes:
        for dist_th in DIST_THRESHOLDS:
            md = _accumulate(gts, preds, cls, dist_th)
            ap[cls][dist_th] = _calc_ap(md)
            if dist_th == TP_DIST:
                for name in ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err"):
                    if name == "vel_err" and cls in NO_VELOCITY:
                        continue
                    if name == "orient_err" and cls in NO_ORIENT:
                        continue
                    if name == "attr_err" and cls in NO_ATTR:
                        continue
                    tp_err[name][cls] = _calc_tp(md, name)

    results: Dict[str, float] = {}
    class_aps = {c: float(np.mean(list(v.values()))) for c, v in ap.items() if v}
    m_ap = float(np.mean(list(class_aps.values()))) if class_aps else 0.0
    results["mAP"] = m_ap
    for c, v in class_aps.items():
        results[f"AP_{c}"] = v

    tp_means = {}
    short = {
        "trans_err": "mATE", "scale_err": "mASE", "orient_err": "mAOE",
        "vel_err": "mAVE", "attr_err": "mAAE",
    }
    for name in ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err"):
        vals = list(tp_err[name].values())
        tp_means[name] = float(np.mean(vals)) if vals else 1.0
        results[short[name]] = tp_means[name]

    nds = (5 * m_ap + sum(1 - min(1.0, v) for v in tp_means.values())) / 10.0
    results["NDS"] = float(nds)
    return results


def _rot_of(q: np.ndarray) -> np.ndarray:
    if q.shape == (3, 3):
        return q
    w, x, y, z = q  # quaternion (w, x, y, z)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _ego_dist_fn(info: Optional[dict]):
    """Devkit `ego_dist` for a lidar-frame point: the GLOBAL-frame xy
    displacement from the ego pose (||(c_g - t_e2g)[:2]|| =
    ||(R_e2g (R_l2e c + t_l2e))[:2]||) when the info record carries
    ego2global; falls back to the ego-frame xy norm (differs only by
    vehicle roll/pitch — centimeters) with lidar2ego alone; else -1."""
    if not info or "lidar2ego_translation" not in info:
        return lambda center: -1.0
    t = np.asarray(info["lidar2ego_translation"], float)
    R = _rot_of(np.asarray(info["lidar2ego_rotation"], float))
    R_e2g = None
    if "ego2global_rotation" in info:
        R_e2g = _rot_of(np.asarray(info["ego2global_rotation"], float))

    def fn(center):
        p = R @ np.asarray(center, float) + t
        if R_e2g is not None:
            p = R_e2g @ p
        return float(np.hypot(p[0], p[1]))

    return fn


def boxes_from_arrays(
    sample_token: str,
    boxes: np.ndarray,  # (K, 9) gravity-center
    scores: np.ndarray,
    labels: np.ndarray,
    valid: np.ndarray,
    classes: Sequence[str] = NUSCENES_CLASSES,
    info: Optional[dict] = None,  # sample info record, for ego_dist
) -> List[DetectionBox]:
    """Model outputs -> DetectionBoxes with the standard attribute heuristic
    (mmdet3d submission convention)."""
    ego_dist = _ego_dist_fn(info)
    out = []
    default_attr = {
        "car": "vehicle.parked", "truck": "vehicle.parked", "bus": "vehicle.moving",
        "trailer": "vehicle.parked", "construction_vehicle": "vehicle.parked",
        "pedestrian": "pedestrian.moving", "motorcycle": "cycle.without_rider",
        "bicycle": "cycle.without_rider", "barrier": "", "traffic_cone": "",
    }
    for k in range(len(boxes)):
        if not valid[k]:
            continue
        name = classes[int(labels[k])]
        speed = float(np.hypot(boxes[k, 7], boxes[k, 8]))
        if speed > 0.2 and name in ("car", "construction_vehicle", "bus", "truck", "trailer"):
            attr = "vehicle.moving"
        elif speed > 0.2 and name in ("bicycle", "motorcycle"):
            attr = "cycle.with_rider"
        else:
            attr = default_attr[name]
        out.append(
            DetectionBox(
                sample_token=sample_token,
                center=boxes[k, :3].astype(float),
                size=boxes[k, 3:6].astype(float),
                yaw=float(boxes[k, 6]),
                velocity=boxes[k, 7:9].astype(float),
                name=name,
                score=float(scores[k]),
                attr=attr,
                ego_dist=ego_dist(boxes[k, :3]),
            )
        )
    return out


def ground_truth_from_infos(
    infos: Sequence[dict], classes: Sequence[str] = NUSCENES_CLASSES
) -> Dict[str, List[DetectionBox]]:
    """GT DetectionBoxes per sample token from info records (bottom-center z
    converted to gravity center, NaN velocities zeroed)."""
    gts: Dict[str, List[DetectionBox]] = {}
    for info in infos:
        tok = info["token"]
        ego_dist = _ego_dist_fn(info)
        boxes = np.asarray(info["gt_boxes"], float).reshape(-1, 7)
        vel = np.nan_to_num(
            np.asarray(info.get("gt_velocity", np.zeros((len(boxes), 2))), float)
        )
        labels = np.asarray(info.get("gt_labels"), int)
        attrs = info.get("gt_attrs", [""] * len(boxes))
        # devkit GT `num_pts` is lidar+radar; legacy infos only carried the
        # (misnamed) sum under num_lidar_pts
        npts = info.get("num_pts", info.get("num_lidar_pts", [10] * len(boxes)))
        gts[tok] = [
            DetectionBox(
                sample_token=tok,
                center=np.array([b[0], b[1], b[2] + b[5] / 2]),
                size=b[3:6],
                yaw=float(b[6]),
                velocity=vel[i],
                name=classes[labels[i]],
                attr=attrs[i] if i < len(attrs) else "",
                num_pts=int(npts[i]) if i < len(npts) else 10,
                ego_dist=ego_dist([b[0], b[1], b[2] + b[5] / 2]),
            )
            for i, b in enumerate(boxes)
        ]
    return gts
