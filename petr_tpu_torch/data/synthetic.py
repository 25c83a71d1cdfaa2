"""Procedural multi-scene synthetic nuScenes-style dataset.

End-to-end training validation without the real dataset (the strongest
in-container proxy for the reference's golden-metric protocol,
`tools/dist_test.sh <cfg> <ckpt> --eval bbox`): distinct scenes with
multiple classes and moving objects are RENDERED into the 6-camera rig, so
a detector trained on some scenes must genuinely learn appearance -> 3D
geometry to score on held-out scenes — memorization (the overfit demo)
cannot.

Learnability design:
  * class identity is color-coded (car red-ish, bus blue-ish, pedestrian
    green-ish) with size priors per class;
  * 3D position must be inferred from image position + projected size
    through the camera geometry (the PETR 3D-PE pathway);
  * velocity is visually encoded (hue shift proportional to (vx, vy)), so
    single-frame models can learn AVE — objects also actually move across
    frames (consistent with their velocity), which temporal (v2) models can
    exploit via the sweep records.

Info records use the full production schema from `data/info.py`
(ego2global/lidar2ego poses, valid_flag, num_pts, sweeps_cams), so the same
loaders / evaluator / submission path run unchanged.

The port's copy of `petr_tpu/data/synthetic.py`: for the same arguments it
writes the same JPEG bytes and the same info records.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np

SYNTH_CLASSES = ("car", "bus", "pedestrian")
# (w, l, h) size priors and base BGR colors
_CLASS_SPEC = {
    "car": ((2.0, 4.6, 1.6), (40.0, 40.0, 220.0), 8.0),
    "bus": ((3.0, 10.0, 3.4), (220.0, 60.0, 40.0), 6.0),
    "pedestrian": ((0.7, 0.7, 1.8), (40.0, 200.0, 40.0), 1.5),
}
_CLASS_IDX = {"car": 0, "bus": 3, "pedestrian": 8}  # NUSCENES_CLASSES indices

CAM_YAWS = {
    "CAM_FRONT": 0.0,
    "CAM_FRONT_RIGHT": -np.pi / 3,
    "CAM_FRONT_LEFT": np.pi / 3,
    "CAM_BACK": np.pi,
    "CAM_BACK_LEFT": 2 * np.pi / 3,
    "CAM_BACK_RIGHT": -2 * np.pi / 3,
}


def _rig(image_hw: Tuple[int, int]):
    """6-camera rig: intrinsics + sensor2lidar transforms (cam z forward,
    x right, y down; mounted 1.5 m up, 0.5 m out along the view yaw)."""
    H, W = image_hw
    f = W * 0.72  # ~70 deg hFoV so adjacent views overlap like nuScenes
    K = np.array([[f, 0.0, W / 2.0], [0.0, f, H / 2.0], [0.0, 0.0, 1.0]])
    rig = {}
    for name, yaw in CAM_YAWS.items():
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        R = np.stack([right, down, fwd], axis=1)  # cam axes in lidar coords
        t = fwd * 0.5 + np.array([0.0, 0.0, 1.5])
        rig[name] = {"K": K, "R": R, "t": t}
    return rig


def _corners(box7: np.ndarray) -> np.ndarray:
    """(7,) (x, y, z_bottom, w, l, h, yaw) -> (8, 3) lidar-frame corners."""
    x, y, z, w, l, h, yaw = box7
    dx = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * (l / 2)
    dy = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * (w / 2)
    dz = np.array([0, 0, 0, 0, 1, 1, 1, 1]) * h
    c, s = np.cos(yaw), np.sin(yaw)
    cx = c * dx - s * dy + x
    cy = s * dx + c * dy + y
    return np.stack([cx, cy, dz + z], -1)


def _render_view(img, cam, boxes7, names, vels, velocity_hue=True):
    """Painter's-algorithm rectangles: project corners, fill the clipped
    image-plane AABB with the class color + a velocity hue shift.

    ``velocity_hue=False`` removes the hue cue — then inter-frame MOTION is
    the only velocity signal, so only temporal (2-frame, PETRv2) models can
    learn AVE; this is the discriminative dataset for validating the
    with_time velocity pathway (reference `petrv2_head.py:499-521`)."""
    H, W = img.shape[:2]
    K, R, t = cam["K"], cam["R"], cam["t"]
    depth_order = []
    for i, b in enumerate(boxes7):
        pc = (R.T @ (_corners(b) - t).T).T  # (8, 3) camera frame
        if (pc[:, 2] > 0.3).sum() < 4:
            continue
        z = np.maximum(pc[:, 2], 0.3)
        uv = (K @ (pc / z[:, None]).T).T[:, :2]
        u0, u1 = uv[:, 0].min(), uv[:, 0].max()
        v0, v1 = uv[:, 1].min(), uv[:, 1].max()
        if u1 < 0 or v1 < 0 or u0 >= W or v0 >= H:
            continue
        depth_order.append((float(pc[:, 2].mean()), i, (u0, v0, u1, v1)))
    for depth, i, (u0, v0, u1, v1) in sorted(depth_order, key=lambda x: -x[0]):
        u0, v0 = max(int(u0), 0), max(int(v0), 0)
        u1, v1 = min(int(u1) + 1, W), min(int(v1) + 1, H)
        if u1 <= u0 or v1 <= v0:
            continue
        base = np.array(_CLASS_SPEC[names[i]][1])
        shade = np.clip(1.1 - depth / 60.0, 0.45, 1.0)
        color = base * shade
        if velocity_hue:
            # velocity cue: hue shift proportional to (vx, vy)
            color = color + np.array([12.0 * vels[i][0], 12.0 * vels[i][1], 0.0])
        img[v0:v1, u0:u1] = np.clip(color, 0, 255)
    return img


def _scene_objects(rng: np.random.Generator, n_objects: int):
    names, boxes, vels = [], [], []
    for _ in range(n_objects):
        name = SYNTH_CLASSES[int(rng.integers(len(SYNTH_CLASSES)))]
        (w, l, h), _, vmax = _CLASS_SPEC[name]
        r = rng.uniform(6.0, 34.0)
        th = rng.uniform(-np.pi, np.pi)
        yaw = rng.uniform(-np.pi, np.pi)
        speed = rng.uniform(0.0, vmax) * (rng.random() < 0.6)
        names.append(name)
        boxes.append([r * np.cos(th), r * np.sin(th), 0.0,
                      w * rng.uniform(0.9, 1.1), l * rng.uniform(0.9, 1.1),
                      h * rng.uniform(0.9, 1.1), yaw])
        vels.append([speed * np.cos(yaw), speed * np.sin(yaw)])
    return names, np.asarray(boxes, float), np.asarray(vels, float)


def generate_synthetic_scenes(
    out_dir: str,
    n_scenes: int = 8,
    frames_per_scene: int = 4,
    image_hw: Tuple[int, int] = (64, 160),
    n_objects: int = 6,
    val_scenes: int = 2,
    seed: int = 0,
    dt: float = 0.5,
    velocity_hue: bool = True,
) -> Dict[str, List[Dict]]:
    """Render scenes to ``out_dir`` and return {"train": infos, "val": infos}
    (held-out scenes go to val). Also writes synth_infos_{train,val}.pkl.
    ``velocity_hue=False``: motion across frames is the ONLY velocity signal
    (see `_render_view`)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    rig = _rig(image_hw)
    rng = np.random.default_rng(seed)
    H, W = image_hw
    splits: Dict[str, List[Dict]] = {"train": [], "val": []}

    for s in range(n_scenes):
        split = "val" if s < val_scenes else "train"
        names, boxes, vels = _scene_objects(rng, n_objects)
        bg = rng.uniform(90, 130)
        # Warmup frame (fidx = -1): real nuScenes keyframes ALWAYS carry
        # prior sweeps, so the reference's pad_empty_sweeps
        # (`loading.py:69-78`) is an exception path — without this frame the
        # scene's first keyframe would systematically hit it, teaching a
        # temporal model "two identical images -> nonzero velocity" on 1/4
        # of samples and capping held-out mAVE. Rendered from a SEPARATE rng
        # stream so every fidx >= 0 image is bit-identical to datasets
        # generated before this change (single-frame baselines stay exactly
        # comparable); used only as the first keyframe's sweep record.
        wrng = np.random.default_rng([seed, s, 991])
        pos_m1 = boxes.copy()
        pos_m1[:, :2] -= vels * dt
        warmup_cams = {}
        for cname, cam in rig.items():
            img = np.full((H, W, 3), bg, np.float32)
            img += wrng.normal(0, 6.0, img.shape)
            img += np.linspace(18, -18, H)[:, None, None]
            img = _render_view(img, cam, pos_m1, names, vels, velocity_hue)
            path = os.path.join(out_dir, f"s{s}_fm1_{cname}.jpg")
            Image.fromarray(
                np.clip(img, 0, 255).astype(np.uint8)[..., ::-1]
            ).save(path, quality=92)
            warmup_cams[cname] = {
                "data_path": path,
                "timestamp": 1000.0 + s * 100.0 - dt,
                "cam_intrinsic": cam["K"].copy(),
                "sensor2lidar_rotation": cam["R"].copy(),
                "sensor2lidar_translation": cam["t"].copy(),
            }
        prev_cam_rec = warmup_cams
        for fidx in range(frames_per_scene):
            ts = 1000.0 + s * 100.0 + fidx * dt
            pos = boxes.copy()
            pos[:, :2] += vels * (fidx * dt)
            cams = {}
            for cname, cam in rig.items():
                img = np.full((H, W, 3), bg, np.float32)
                img += rng.normal(0, 6.0, img.shape)
                # horizon gradient so "up" is learnable
                img += np.linspace(18, -18, H)[:, None, None]
                img = _render_view(img, cam, pos, names, vels, velocity_hue)
                path = os.path.join(out_dir, f"s{s}_f{fidx}_{cname}.jpg")
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)[..., ::-1]).save(
                    path, quality=92
                )
                cams[cname] = {
                    "data_path": path,
                    "timestamp": ts,
                    "cam_intrinsic": cam["K"].copy(),
                    "sensor2lidar_rotation": cam["R"].copy(),
                    "sensor2lidar_translation": cam["t"].copy(),
                }
            G = len(names)
            # attributes consistent with the submission heuristic
            # (metrics/nuscenes.py boxes_from_arrays): moving vs parked by
            # speed — so AAE rewards learned velocities instead of pinning 1.0
            attrs = []
            for n, v in zip(names, vels):
                speed = float(np.hypot(v[0], v[1]))
                if n == "pedestrian":
                    attrs.append("pedestrian.moving")
                else:
                    attrs.append("vehicle.moving" if speed > 0.2 else "vehicle.parked")
            info = {
                "token": f"s{s}_f{fidx}",
                "scene_token": f"scene{s}",
                "timestamp": ts,
                "lidar_path": "",
                "lidar2ego_translation": np.array([0.0, 0.0, 1.8]),
                "lidar2ego_rotation": np.array([1.0, 0.0, 0.0, 0.0]),
                "ego2global_translation": np.array([100.0 * s, 0.0, 0.0]),
                "ego2global_rotation": np.array([1.0, 0.0, 0.0, 0.0]),
                "cams": cams,
                "sweeps_cams": [prev_cam_rec] if prev_cam_rec else [],
                "gt_boxes": pos.copy(),
                "gt_velocity": vels.copy(),
                "gt_labels": np.array([_CLASS_IDX[n] for n in names], np.int64),
                "valid_flag": np.ones(G, bool),
                "gt_attrs": attrs,
                "num_lidar_pts": np.full(G, 64, np.int64),
                "num_pts": np.full(G, 64, np.int64),
            }
            splits[split].append(info)
            prev_cam_rec = cams

    for split, infos in splits.items():
        with open(os.path.join(out_dir, f"synth_infos_{split}.pkl"), "wb") as f:
            pickle.dump({"infos": infos, "metadata": {"version": "synthetic"}}, f)
    return splits
