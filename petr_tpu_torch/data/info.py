"""nuScenes info-file builder (host-side data prep).

Behavioral reference: `tools/data_converter/nuscenes_converter.py:26-340`
(sty61010/PETR): official scene splits, per-sample records with the six
camera transforms (sensor->lidar chain via ego poses), GT boxes in the lidar
frame with velocities, plus (for PETRv2) previous-frame camera records whose
transforms are chained through the ego pose so prev-frame lidar2img matrices
are already aligned to the current lidar frame.

Requires the nuscenes-devkit + raw data at runtime; the import is gated so
the rest of the engine works without it. The port's copy of
`petr_tpu/data/info.py`, record for record.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np

from petr_tpu_torch.configs.config import NUSCENES_CLASSES

# nuScenes detection-class mapping (upstream mmdet3d NuScenesDataset.NameMapping)
NAME_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}


def _quat_to_rot(q) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _sensor_to_lidar(nusc, sd_token: str, lidar_sd: Dict) -> Dict:
    """Transform chain sensor -> ego(t_s) -> global -> ego(t_l) -> lidar.

    Mirrors `nuscenes_converter.py:280-340` (obtain_sensor2top).
    """
    sd = nusc.get("sample_data", sd_token)
    cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
    pose = nusc.get("ego_pose", sd["ego_pose_token"])

    l_cs = nusc.get("calibrated_sensor", lidar_sd["calibrated_sensor_token"])
    l_pose = nusc.get("ego_pose", lidar_sd["ego_pose_token"])

    # sensor -> global
    R_s = _quat_to_rot(cs["rotation"])
    t_s = np.asarray(cs["translation"])
    R_pe = _quat_to_rot(pose["rotation"])
    t_pe = np.asarray(pose["translation"])
    # global -> lidar
    R_l = _quat_to_rot(l_cs["rotation"])
    t_l = np.asarray(l_cs["translation"])
    R_le = _quat_to_rot(l_pose["rotation"])
    t_le = np.asarray(l_pose["translation"])

    R = (R_le @ R_l).T @ (R_pe @ R_s)
    t = (R_le @ R_l).T @ (R_pe @ t_s + t_pe - R_le @ t_l - t_le)

    rec = {
        "data_path": sd["filename"],
        "timestamp": sd["timestamp"] / 1e6,
        "sensor2lidar_rotation": R,
        "sensor2lidar_translation": t,
    }
    if sd["sensor_modality"] == "camera":
        rec["cam_intrinsic"] = np.asarray(cs["camera_intrinsic"])
    return rec


CAM_NAMES = (
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_FRONT_LEFT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_BACK_RIGHT",
)


def build_infos(
    data_root: str,
    version: str = "v1.0-trainval",
    max_prev_frames: int = 30,
    *,
    nusc=None,
    train_scenes: Optional[List[str]] = None,
    val_scenes: Optional[List[str]] = None,
) -> Dict[str, List[Dict]]:
    """Build train/val info lists.

    Needs the nuscenes-devkit + raw data in production; ``nusc`` /
    ``train_scenes`` / ``val_scenes`` can be injected (any object with the
    devkit's ``get`` / ``sample`` / ``scene`` / ``box_velocity`` surface)
    so the builder is unit-testable without the devkit.
    """
    if nusc is None:
        from nuscenes.nuscenes import NuScenes  # gated import

        nusc = NuScenes(version=version, dataroot=data_root, verbose=False)
    if train_scenes is None or val_scenes is None:
        from nuscenes.utils import splits

        if version == "v1.0-trainval":
            train_scenes, val_scenes = splits.train, splits.val
        elif version == "v1.0-mini":
            train_scenes, val_scenes = splits.mini_train, splits.mini_val
        elif version == "v1.0-test":
            train_scenes, val_scenes = splits.test, []
        else:
            raise ValueError(version)

    scene_name = {s["token"]: s["name"] for s in nusc.scene}
    train_infos, val_infos = [], []

    for sample in nusc.sample:
        name = scene_name[sample["scene_token"]]
        if name not in train_scenes and name not in val_scenes:
            continue
        lidar_sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])

        cams = {}
        for cam in CAM_NAMES:
            cams[cam] = _sensor_to_lidar(nusc, sample["data"][cam], lidar_sd)

        # previous camera frames (sample_data chain), ego-aligned to current
        # lidar frame — used by the PETRv2 sweep loader.
        sweeps_cams: List[Dict] = []
        prev_tokens = {cam: nusc.get("sample_data", sample["data"][cam])["prev"] for cam in CAM_NAMES}
        for _ in range(max_prev_frames):
            if any(not t for t in prev_tokens.values()):
                break
            frame = {}
            for cam in CAM_NAMES:
                frame[cam] = _sensor_to_lidar(nusc, prev_tokens[cam], lidar_sd)
                prev_tokens[cam] = nusc.get("sample_data", prev_tokens[cam])["prev"]
            sweeps_cams.append(frame)

        # GT in lidar frame (pure-numpy equivalent of the devkit Box
        # translate/rotate chain: p_l = (R_le R_l)^T (p_g - t_le - R_le t_l),
        # R_box_l = (R_le R_l)^T R_box_g, yaw = atan2(R[1,0], R[0,0]) — the
        # ZYX yaw pyquaternion's yaw_pitch_roll[0] returns)
        l_cs = nusc.get("calibrated_sensor", lidar_sd["calibrated_sensor_token"])
        l_pose = nusc.get("ego_pose", lidar_sd["ego_pose_token"])
        R_l = _quat_to_rot(l_cs["rotation"])
        t_l = np.asarray(l_cs["translation"], float)
        R_le = _quat_to_rot(l_pose["rotation"])
        t_le = np.asarray(l_pose["translation"], float)
        R_g2l = (R_le @ R_l).T

        boxes, labels, vels, valid, attrs, npts = [], [], [], [], [], []
        for ann_token in sample["anns"]:
            ann = nusc.get("sample_annotation", ann_token)
            mapped = NAME_MAPPING.get(ann["category_name"])
            if mapped is None or mapped not in NUSCENES_CLASSES:
                continue
            center = R_g2l @ (np.asarray(ann["translation"], float) - t_le - R_le @ t_l)
            R_box = R_g2l @ _quat_to_rot(ann["rotation"])
            yaw = float(np.arctan2(R_box[1, 0], R_box[0, 0]))
            # mmdet3d box convention: (x, y, z_bottom, w, l, h, yaw) with
            # dims reordered (wlh -> w, l, h as stored by the converter:
            # gt_boxes uses box.wlh[[1,0,2]] and yaw = -yaw - pi/2 in
            # mmdet3d 0.17's LiDAR convention)
            w, l, h = np.asarray(ann["size"], float)
            boxes.append(
                [
                    center[0],
                    center[1],
                    center[2] - h / 2.0,
                    w,
                    l,
                    h,
                    -yaw - np.pi / 2.0,
                ]
            )
            v = np.nan_to_num(np.asarray(nusc.box_velocity(ann_token), float))[:2]
            v3 = R_g2l @ np.array([v[0], v[1], 0.0])
            vels.append(v3[:2])
            labels.append(NUSCENES_CLASSES.index(mapped))
            valid.append(ann["num_lidar_pts"] + ann["num_radar_pts"] > 0)
            # (lidar_only, lidar+radar): upstream's `num_lidar_pts` field is
            # lidar-only (the use_valid_flag=False fallback mask); the devkit
            # GT filter uses the lidar+radar sum (`num_pts`).
            npts.append((ann["num_lidar_pts"], ann["num_lidar_pts"] + ann["num_radar_pts"]))
            # attribute name (for AAE in the NDS evaluation)
            if ann["attribute_tokens"]:
                attrs.append(nusc.get("attribute", ann["attribute_tokens"][0])["name"])
            else:
                attrs.append("")

        l_cs_rec = nusc.get("calibrated_sensor", lidar_sd["calibrated_sensor_token"])
        info = {
            "token": sample["token"],
            "scene_token": sample["scene_token"],
            "timestamp": sample["timestamp"] / 1e6,
            "lidar_path": lidar_sd["filename"],
            # lidar->ego calibration: the metric evaluator's class-range
            # filter measures box distance from the EGO origin (devkit
            # `filter_eval_boxes` conformance)
            "lidar2ego_translation": np.asarray(l_cs_rec["translation"], np.float64),
            "lidar2ego_rotation": np.asarray(l_cs_rec["rotation"], np.float64),
            # ego->global pose at the lidar keyframe
            # (`nuscenes_converter.py:184-185`): required to express the
            # submission JSON in the global frame
            # (metrics/submission.py) and for the devkit-exact
            # ego-distance range filter.
            "ego2global_translation": np.asarray(l_pose["translation"], np.float64),
            "ego2global_rotation": np.asarray(l_pose["rotation"], np.float64),
            "cams": cams,
            "sweeps_cams": sweeps_cams,
            "gt_boxes": np.asarray(boxes, np.float64).reshape(-1, 7),
            "gt_velocity": np.asarray(vels, np.float64).reshape(-1, 2),
            "gt_labels": np.asarray(labels, np.int64),
            "valid_flag": np.asarray(valid, bool),
            "gt_attrs": attrs,
            "num_lidar_pts": np.asarray([p[0] for p in npts], np.int64),
            "num_pts": np.asarray([p[1] for p in npts], np.int64),
        }
        (train_infos if name in train_scenes else val_infos).append(info)

    train_infos.sort(key=lambda x: x["timestamp"])
    val_infos.sort(key=lambda x: x["timestamp"])
    return {"train": train_infos, "val": val_infos}


def save_infos(infos: Dict[str, List[Dict]], prefix: str) -> None:
    for split, data in infos.items():
        with open(f"{prefix}_infos_{split}.pkl", "wb") as f:
            pickle.dump({"infos": data}, f)
