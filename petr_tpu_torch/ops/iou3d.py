"""Rotated BEV / 3D IoU and BEV NMS (host-side NumPy).

Counterpart of `petr_tpu/ops/iou3d.py` (reference
`core/bbox/iou_calculators/iou3d_calculator.py`, sty61010/PETR, which calls
mmdet3d's CUDA rotated-overlap kernels). PETR decodes without NMS and gives
the IoU cost weight 0, so this is evaluation and analysis tooling: exact
polygon clipping (Sutherland-Hodgman) on the host, with the same float64
arithmetic in the same order as petr_tpu's, so both give the same bits.
Boxes: (cx, cy, cz, w, l, h, yaw), z at the gravity centre.
"""

from __future__ import annotations

import numpy as np


def _bev_corners(box: np.ndarray) -> np.ndarray:
    cx, cy, w, l, yaw = box[0], box[1], box[3], box[4], box[6]
    c, s = np.cos(yaw), np.sin(yaw)
    local = np.array([[-w / 2, -l / 2], [w / 2, -l / 2], [w / 2, l / 2], [-w / 2, l / 2]])
    R = np.array([[c, -s], [s, c]])
    return local @ R.T + np.array([cx, cy])


def _clip_polygon(poly: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Clip ``poly`` to the half-plane left of the edge a -> b."""
    if len(poly) == 0:
        return poly
    d = b - a
    out = []
    n = len(poly)
    for i in range(n):
        p, q = poly[i], poly[(i + 1) % n]
        side_p = d[0] * (p[1] - a[1]) - d[1] * (p[0] - a[0])
        side_q = d[0] * (q[1] - a[1]) - d[1] * (q[0] - a[0])
        if side_p >= 0:
            out.append(p)
        if (side_p > 0) != (side_q > 0) and side_p != side_q:
            t = side_p / (side_p - side_q)
            out.append(p + t * (q - p))
    return np.asarray(out) if out else np.zeros((0, 2))


def _poly_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def bev_overlap(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """Exact intersection area of two rotated rectangles in BEV."""
    pa = _bev_corners(np.asarray(box_a, float))
    pb = _bev_corners(np.asarray(box_b, float))
    poly = pa
    for i in range(4):
        poly = _clip_polygon(poly, pb[i], pb[(i + 1) % 4])
    return _poly_area(poly)


def _as_boxes(boxes: np.ndarray) -> np.ndarray:
    return np.asarray(boxes, float).reshape(-1, np.shape(boxes)[-1])


def bev_iou(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(Na, Nb) rotated IoU in BEV."""
    boxes_a, boxes_b = _as_boxes(boxes_a), _as_boxes(boxes_b)
    out = np.zeros((len(boxes_a), len(boxes_b)))
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    for i, a in enumerate(boxes_a):
        for j, b in enumerate(boxes_b):
            inter = bev_overlap(a, b)
            union = area_a[i] + area_b[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def iou_3d(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(Na, Nb) 3D IoU: the BEV overlap times the overlap in z."""
    boxes_a, boxes_b = _as_boxes(boxes_a), _as_boxes(boxes_b)
    out = np.zeros((len(boxes_a), len(boxes_b)))
    for i, a in enumerate(boxes_a):
        for j, b in enumerate(boxes_b):
            inter_bev = bev_overlap(a, b)
            za0, za1 = a[2] - a[5] / 2, a[2] + a[5] / 2
            zb0, zb1 = b[2] - b[5] / 2, b[2] + b[5] / 2
            dz = max(0.0, min(za1, zb1) - max(za0, zb0))
            inter = inter_bev * dz
            union = a[3] * a[4] * a[5] + b[3] * b[4] * b[5] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def nms_bev(boxes: np.ndarray, scores: np.ndarray, iou_thr: float = 0.5, max_out: int = 500) -> np.ndarray:
    """Greedy rotated-BEV NMS in descending score order -> the kept indices
    (int64)."""
    order = np.argsort(-np.asarray(scores))
    keep = []
    for idx in order:
        if not any(bev_iou(boxes[idx:idx + 1], boxes[k:k + 1])[0, 0] > iou_thr for k in keep):
            keep.append(int(idx))
            if len(keep) >= max_out:
                break
    return np.asarray(keep, np.int64)
