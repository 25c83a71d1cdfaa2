"""nuScenes submission export: lidar-frame detections -> global frame.

Behavioral reference: upstream mmdet3d `NuScenesDataset._format_bbox` ->
`output_to_nusc_box` + `lidar_nusc_box_to_global` (the path the reference's
`tools/test.py:226-242` --format-only flag exercises). Per box:

  1. internal (mmdet) yaw -> nuScenes lidar-frame yaw: y_n = -y - pi/2
     (involution of the info-builder storage convention,
     `tools/data_converter/nuscenes_converter.py` gt_boxes yaw).
  2. lidar -> ego -> global rigid chain using the info record's
     `lidar2ego_*` / `ego2global_*` (stored by `data/info.py`,
     mirroring `nuscenes_converter.py:182-185`): center translated, the
     yaw-only box quaternion composed q_g = q_e2g * q_l2e * q_box, the
     (vx, vy, 0) velocity rotated.
  3. the upstream class-range filter applied on the EGO-frame xy radius
     (mmdet3d `lidar_nusc_box_to_global` drops boxes beyond
     `eval_detection_configs.class_range` before writing).

The output dict follows the official submission schema, so the JSON from
`cli.test --out` is devkit-scorable (translation = global gravity center,
rotation = global-frame quaternion (w, x, y, z), size = (w, l, h)).

The port's copy of `petr_tpu/metrics/submission.py`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from petr_tpu_torch.metrics.nuscenes import CLS_RANGE, DetectionBox, _rot_of


def quat_mult(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product of (w, x, y, z) quaternions."""
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(3, 3) rotation matrix -> (w, x, y, z) quaternion (w >= 0).

    Shepperd's method: branch on the largest of {trace, R00, R11, R22} so
    the divisor is always the dominant quaternion component — stable for
    rotations near pi, where a w-first form divides near-cancelling
    off-diagonal differences by a tiny 4w.
    """
    diag = np.diag(R)
    tr = float(diag.sum())
    if tr > diag.max():
        s = np.sqrt(tr + 1.0) * 2.0  # s = 4w
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s,
                      (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(diag))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2.0  # 4*q_i
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    if q[0] < 0.0:
        q = -q
    return q / np.linalg.norm(q)


def _pose_of(info: dict, key: str):
    """(R (3,3), t (3,), q (w,x,y,z)) for a stored pose — the rotation may
    be a quaternion (the info-builder convention) or a 3x3 matrix."""
    raw = np.asarray(info[f"{key}_rotation"], float)
    R = _rot_of(raw)
    q = raw if raw.shape == (4,) else _rot_to_quat(R)
    return R, np.asarray(info[f"{key}_translation"], float), q


def lidar_box_to_global(info: dict, center, yaw: float, velocity):
    """One lidar-frame box (gravity center, mmdet yaw, (vx, vy)) -> global.

    Returns (center_g (3,), quat_g (4,) wxyz, vel_g (2,), ego_radius).
    ``ego_radius`` is the ego-frame xy distance used by the upstream
    class-range filter.
    """
    R_l2e, t_l2e, q_l2e = _pose_of(info, "lidar2ego")
    R_e2g, t_e2g, q_e2g = _pose_of(info, "ego2global")

    yaw_nusc = -float(yaw) - np.pi / 2.0
    q_box = np.array([np.cos(yaw_nusc / 2), 0.0, 0.0, np.sin(yaw_nusc / 2)])

    c_e = R_l2e @ np.asarray(center, float) + t_l2e
    ego_radius = float(np.hypot(c_e[0], c_e[1]))
    c_g = R_e2g @ c_e + t_e2g
    q_g = quat_mult(q_e2g, quat_mult(q_l2e, q_box))
    v3 = R_e2g @ (R_l2e @ np.array([velocity[0], velocity[1], 0.0], float))
    return c_g, q_g, v3[:2], ego_radius


def _requires_pose(info: dict) -> bool:
    return "ego2global_rotation" in info and "lidar2ego_rotation" in info


def format_sample(info: dict, boxes: Sequence[DetectionBox]) -> List[dict]:
    """One sample's DetectionBoxes -> submission result entries (global)."""
    out = []
    for d in boxes:
        c_g, q_g, v_g, ego_r = lidar_box_to_global(info, d.center, d.yaw, d.velocity)
        # upstream lidar_nusc_box_to_global class-range filter (ego radius)
        if ego_r > CLS_RANGE.get(d.name, 0.0):
            continue
        out.append({
            "sample_token": d.sample_token,
            "translation": [float(v) for v in c_g],
            "size": [float(v) for v in d.size],
            "rotation": [float(v) for v in q_g],
            "velocity": [float(v) for v in v_g],
            "detection_name": d.name,
            "detection_score": float(d.score),
            "attribute_name": d.attr,
        })
    return out


def build_submission(
    preds: Dict[str, List[DetectionBox]],
    infos: Sequence[dict],
    meta: dict | None = None,
) -> dict:
    """All samples -> official submission dict ({"meta": ..., "results": ...}).

    Raises a clear error when the info records predate the ego2global
    schema (re-run `cli.create_data`), instead of silently writing
    wrong-frame boxes.
    """
    info_by_token = {info["token"]: info for info in infos}
    missing = [tok for tok in preds if not _requires_pose(info_by_token.get(tok, {}))]
    if missing:
        raise ValueError(
            f"{len(missing)} samples lack ego2global pose in their info "
            f"records (e.g. token {missing[0]!r}); regenerate infos with "
            "data.info.build_infos — a submission cannot be expressed "
            "in the lidar frame."
        )
    return {
        "meta": meta or {
            "use_camera": True, "use_lidar": False, "use_radar": False,
            "use_map": False, "use_external": False,
        },
        "results": {
            tok: format_sample(info_by_token[tok], boxes)
            for tok, boxes in preds.items()
        },
    }
