"""nuScenes multi-view dataset -> statically-shaped training batches.

Info schema (produced by data/info.py, mirroring the reference's
`tools/data_converter/nuscenes_converter.py` records): per sample a dict
  token, timestamp (s), lidar_path,
  cams: {cam_name: {data_path, cam_intrinsic (3,3),
                    sensor2lidar_rotation (3,3), sensor2lidar_translation (3,),
                    timestamp (s)}},
  sweeps_cams: list of previous-frame cam dicts (ego-aligned lidar2img
      chain precomputed as in the 30-frame info files used by PETRv2),
  gt_boxes (G, 7) [bottom-center z], gt_velocity (G, 2), gt_labels (G,),
  valid_flag (G,) bool.

Camera matrix convention (`datasets/nuscenes_dataset.py:56-66`):
  lidar2cam_r = inv(sensor2lidar_rotation)
  lidar2cam_t = sensor2lidar_translation @ lidar2cam_r.T
  lidar2cam_rt = [[lidar2cam_r.T, 0], [-lidar2cam_t, 1]]   (transposed layout)
  lidar2img = viewpad(intrinsic) @ lidar2cam_rt.T

Batches are padded to static shapes; GT to ``max_gt`` with a validity mask;
GT z converted to gravity center. ``img2lidar`` is inverted here on the host
in float64 (the reference inverts per step on the hot path;
`petr_head.py:308-314`).

The port's copy of `petr_tpu/data/dataset.py`, array for array. It decodes
and resamples through the native C++ loader (``data/native.py``,
``csrc/dataload.cpp``) when that library is built and the augmentation
allows it, as petr_tpu does, and through PIL otherwise; the two branches
differ by pixel noise (a median error under 0.05 of a normalised pixel).
"""

from __future__ import annotations

import pickle
import queue
import threading
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

import numpy as np

from petr_tpu_torch.configs.config import PC_RANGE, DataConfig
from petr_tpu_torch.data import native
from petr_tpu_torch.data.transforms import (
    apply_ida,
    bev_rotate_scale,
    compose_lidar2img,
    normalize_image,
    pad_image,
    sample_ida_params,
    update_intrinsics_ida,
)

if TYPE_CHECKING:
    from PIL import Image

CAM_ORDER = (
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_FRONT_LEFT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_BACK_RIGHT",
)


def cam_matrices(cam: Dict) -> Dict[str, np.ndarray]:
    """Build (intrinsics4, extrinsics4) for one camera record."""
    intrinsic = np.asarray(cam["cam_intrinsic"], np.float64)
    viewpad = np.eye(4)
    viewpad[:3, :3] = intrinsic
    r = np.asarray(cam["sensor2lidar_rotation"], np.float64)
    t = np.asarray(cam["sensor2lidar_translation"], np.float64)
    try:
        lidar2cam_r = np.linalg.inv(r)
        if not np.isfinite(lidar2cam_r).all():
            raise np.linalg.LinAlgError
    except np.linalg.LinAlgError:
        # corrupt rotation: identity fallback; the (now inconsistent)
        # lidar2img flows into _safe_img2lidar / stays masked by the PE
        lidar2cam_r = np.eye(3)
        t = np.full(3, np.nan)  # poison so _safe_img2lidar rejects the view
    lidar2cam_t = t @ lidar2cam_r.T
    rt = np.eye(4)
    rt[:3, :3] = lidar2cam_r.T
    rt[3, :3] = -lidar2cam_t
    return {"intrinsics": viewpad, "extrinsics": rt}


def _safe_img2lidar(l2i: np.ndarray) -> np.ndarray:
    """fp64 batched inverse with corrupt-matrix fallback.

    A non-finite or singular ``lidar2img`` (corrupt calibration) would crash
    the inverse — or worse, propagate NaN through the 3D position embedding,
    where the out-of-range mask does NOT catch NaN (comparisons with NaN are
    False). Corrupt views get a constant far-away back-projection instead:
    every frustum point maps to (1e4, 1e4, 1e4), far outside position_range,
    so the PE mask excludes all of that view's tokens.
    """
    far = np.zeros((4, 4))
    far[:3, 3] = 1e4
    far[3, 3] = 1.0
    out = np.empty_like(l2i, dtype=np.float64)
    for i, m in enumerate(l2i):
        inv = None
        if np.isfinite(m).all():
            try:
                cand = np.linalg.inv(m)
                if np.isfinite(cand).all():
                    inv = cand
            except np.linalg.LinAlgError:
                pass
        out[i] = far if inv is None else inv
    return out


class NuScenesDataset:
    """Reads info records + images, applies the pipeline, emits sample dicts."""

    def __init__(
        self,
        infos: Sequence[Dict],
        cfg: DataConfig,
        training: bool = True,
        data_root: str = "",
        src_hw=None,
        sweep_range=(3, 27),
        view_transform=None,
    ):
        """``view_transform``: optional callable(img_f32_bgr, rng) applied per
        view before normalization — the AlbuMultiview3D /
        PhotoMetricDistortion extension point (e.g.
        ``transforms.photometric_distortion``). Using it disables the native
        fused path for those samples. ``src_hw`` defaults to
        ``cfg.src_hw`` (nuScenes 900x1600)."""
        self.infos = list(infos)
        self.cfg = cfg
        self.training = training
        self.data_root = data_root
        self.src_hw = tuple(src_hw) if src_hw is not None else tuple(
            getattr(cfg, "src_hw", (900, 1600)))
        self.sweep_range = sweep_range
        self.view_transform = view_transform

    @classmethod
    def from_pkl(cls, path: str, cfg: DataConfig, **kw) -> "NuScenesDataset":
        with open(path, "rb") as f:
            data = pickle.load(f)
        infos = data["infos"] if isinstance(data, dict) else data
        return cls(infos, cfg, **kw)

    def __len__(self):
        return len(self.infos)

    def _load_image(self, path: str) -> Image.Image:
        from PIL import Image

        full = path if path.startswith("/") else f"{self.data_root}/{path}"
        img = Image.open(full)
        # PIL loads RGB; caffe-style normalization expects BGR
        return img

    def _select_cams(self, info: Dict, rng: np.random.Generator) -> List[Dict]:
        """Current-frame cams + (v2) one previous-frame sweep of 6 cams.

        Sweep selection mirrors `datasets/pipelines/loading.py:80-94`: train
        picks a random index in sweep_range, test the middle; missing sweeps
        degrade to repeating the current frame (`:69-78`).
        """
        cams = [dict(info["cams"][name], _ts_ref=info["timestamp"]) for name in CAM_ORDER]
        if self.cfg.num_frames > 1:
            sweeps = info.get("sweeps_cams") or []
            if sweeps:
                lo, hi = self.sweep_range
                if self.training:
                    # records with <= lo sweeps (short scenes, synthetic
                    # 1-sweep infos) take the last available sweep instead
                    # of crashing the empty randint range
                    hi_eff = min(hi, len(sweeps))
                    idx = int(rng.integers(lo, hi_eff)) if hi_eff > lo else len(sweeps) - 1
                else:
                    idx = min((lo + hi) // 2, len(sweeps) - 1)
                idx = min(max(idx, 0), len(sweeps) - 1)
                prev = sweeps[idx]
                cams += [dict(prev[name], _ts_ref=info["timestamp"]) for name in CAM_ORDER]
            else:
                # reference pad_empty_sweeps (`loading.py:69-78`): repeat the
                # current frame but offset its timestamp by the mid-sweep
                # mean time so with_time sees a sane nonzero dt
                lo, hi = self.sweep_range
                mean_time = (lo + hi) / 2.0 * 0.083
                cams += [dict(c, _ts_pad=mean_time) for c in cams]
        return cams

    def _full_path(self, path: str) -> str:
        return path if path.startswith("/") else f"{self.data_root}/{path}"

    def _load_and_transform(self, cams, ida) -> List[np.ndarray]:
        """Decode + IDA + normalize + pad for all cams.

        Uses the native C++ fused pipeline (``data/native.py``) when it is
        built, the augmentation has no rotation and no ``view_transform``,
        and every image is a JPEG (petr_tpu's conditions,
        `dataset.py:192-217`); else PIL. The ``view_transform`` rng is
        seeded from ``hash(paths[0])`` as in petr_tpu (`dataset.py:222`);
        Python salts ``hash`` of a str per process, so that augmentation
        differs from run to run unless ``PYTHONHASHSEED`` is set
        (ROADMAP.md §3).
        """
        paths = [self._full_path(c["data_path"]) for c in cams]
        use_native = (
            native.available()
            and ida.rotate_deg == 0.0
            and self.view_transform is None
            and all(p.lower().endswith((".jpg", ".jpeg")) for p in paths)
        )
        if use_native:
            bufs = []
            for p in paths:
                with open(p, "rb") as f:
                    bufs.append(f.read())
            try:
                out = native.process_images(
                    bufs,
                    resize_wh=ida.resize_dims,
                    crop=ida.crop,
                    flip=ida.flip,
                    out_hw=self.cfg.image_size,
                    mean=self.cfg.mean,
                    std=self.cfg.std,
                    to_bgr=not self.cfg.to_rgb,
                )
                return list(out)
            except RuntimeError:
                pass  # a corrupt image: PIL below raises its clear error

        images = []
        rng = np.random.default_rng(abs(hash(paths[0])) % (2**32))
        for cam in cams:
            img = self._load_image(cam["data_path"])
            img = apply_ida(img, ida)
            arr = np.asarray(img, np.float32)
            if arr.ndim == 2:
                arr = np.stack([arr] * 3, -1)
            if not self.cfg.to_rgb:
                arr = arr[..., ::-1]  # RGB -> BGR (caffe convention)
            if self.view_transform is not None and self.training:
                arr = self.view_transform(arr, rng)
            arr = normalize_image(arr, self.cfg.mean, self.cfg.std, False)
            images.append(pad_image(arr, self.cfg.image_size))
        return images

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.get(idx, seed=idx)

    def streaming_sample(self, idx: int, prev_info: Optional[Dict] = None) -> Dict:
        """One streaming step's inputs for a 2-frame (PETRv2) config.

        Current frame: the sample's 6 keyframe cams (images loaded and
        transformed). Previous frame: the ``sweeps_cams`` entry whose
        CAM_FRONT ``data_path`` matches ``prev_info``'s keyframe — i.e. the
        actual previous keyframe, whose backbone features the caller
        (`serve.StreamingPETRv2`) holds in its cache. Its
        ego-aligned matrices and lidar-relative timestamps come from THIS
        sample's own info record (the same chain the offline loader uses),
        so no live pose math is needed. When there is no match but the info
        carries sweep records (scene start), the test-mode sweep is used and
        its IMAGES are returned as ``prev_images`` so the caller can
        ``prime()`` its feature cache — streaming then reproduces the full
        12-view eval exactly on every frame, including scene starts. Only
        when no sweeps exist at all does the previous frame self-pad like
        the offline ``pad_empty_sweeps`` path. Either way ``cached`` is
        False and the caller must ``reset()`` first.

        Returns images for the CURRENT 6 views only, (12,)-view matrices /
        timestamps, ``cached``, and ``prev_images`` (None unless priming).
        """
        assert self.cfg.num_frames > 1, "streaming_sample needs a 2-frame config"
        info = self.infos[idx]
        cams = [dict(info["cams"][name], _ts_ref=info["timestamp"]) for name in CAM_ORDER]

        matched = None
        prime = False
        if prev_info is not None:
            prev_path = prev_info["cams"][CAM_ORDER[0]]["data_path"]
            for frame in info.get("sweeps_cams") or []:
                if frame[CAM_ORDER[0]]["data_path"] == prev_path:
                    matched = frame
                    break
        if matched is None:
            sweeps = info.get("sweeps_cams") or []
            if sweeps:
                # scene start with stored sweeps: the offline eval path's
                # test-mode pick (`_select_cams`), surfaced for cache priming
                lo, hi = self.sweep_range
                matched = sweeps[min(max((lo + hi) // 2, 0), len(sweeps) - 1)]
                prime = True
        if matched is not None:
            prev_cams = [dict(matched[name], _ts_ref=info["timestamp"]) for name in CAM_ORDER]
        else:
            lo, hi = self.sweep_range
            mean_time = (lo + hi) / 2.0 * 0.083
            prev_cams = [dict(c, _ts_pad=mean_time) for c in cams]

        rng = np.random.default_rng(np.random.SeedSequence([0, idx]))
        ida = sample_ida_params(
            rng, self.src_hw, self.cfg.final_dim, self.cfg.resize_lim,
            self.cfg.bot_pct_lim, self.cfg.rot_lim, self.cfg.rand_flip,
            False,  # streaming is an inference path: deterministic IDA
        )
        images = self._load_and_transform(cams, ida)

        l2i_list, ts_list = [], []
        for cam in cams + prev_cams:
            mats = cam_matrices(cam)
            intr = update_intrinsics_ida(mats["intrinsics"], ida)
            l2i_list.append(compose_lidar2img(intr, mats["extrinsics"]))
            ts = float(cam.get("_ts_ref", 0.0)) - float(cam.get("timestamp", 0.0))
            ts_list.append(ts + float(cam.get("_ts_pad", 0.0)))
        l2i = np.stack(l2i_list)  # (12, 4, 4)

        fh, fw = self.cfg.final_dim
        prev_images = None
        if prime:
            prev_images = np.stack(
                self._load_and_transform(prev_cams, ida)
            ).astype(np.float32)
        return {
            "images": np.stack(images).astype(np.float32),  # (6, H, W, 3)
            "img2lidar": _safe_img2lidar(l2i).astype(np.float32),
            "img_hw": np.full((len(l2i_list), 2), [fh, fw], np.float32),
            "timestamp": np.asarray(ts_list, np.float32),
            "token": info.get("token", str(idx)),
            "cached": matched is not None and not prime,
            "prev_images": prev_images,
        }

    def get(self, idx: int, seed: int = 0) -> Dict[str, np.ndarray]:
        info = self.infos[idx]
        rng = np.random.default_rng(np.random.SeedSequence([seed, idx]))
        cams = self._select_cams(info, rng)

        ida = sample_ida_params(
            rng,
            self.src_hw,
            self.cfg.final_dim,
            self.cfg.resize_lim,
            self.cfg.bot_pct_lim,
            self.cfg.rot_lim,
            self.cfg.rand_flip,
            self.training,
        )

        images = self._load_and_transform(cams, ida)
        l2i_list, ts_list = [], []
        for cam in cams:
            mats = cam_matrices(cam)
            intr = update_intrinsics_ida(mats["intrinsics"], ida)
            l2i_list.append(compose_lidar2img(intr, mats["extrinsics"]))
            # lidar-relative delta, reference sign convention (lidar - img,
            # loading.py:65): prev-frame images get POSITIVE deltas. The
            # sign flows into with_time velocity normalization, so matching
            # it keeps imported torch checkpoints' velocities correct.
            ts = float(cam.get("_ts_ref", 0.0)) - float(cam.get("timestamp", 0.0))
            ts_list.append(ts + float(cam.get("_ts_pad", 0.0)))

        l2i = np.stack(l2i_list)  # (N, 4, 4)

        gt_boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))), np.float64)
        gt_vel = np.asarray(info.get("gt_velocity", np.zeros((len(gt_boxes), 2))), np.float64)
        gt_vel = np.nan_to_num(gt_vel)
        gt_labels = np.asarray(info.get("gt_labels", np.zeros((len(gt_boxes),))), np.int64)
        # sensor-visibility GT filter (mmdet3d NuScenesDataset.get_ann_info):
        # use_valid_flag drops annotations with zero lidar+radar points;
        # the upstream fallback is num_lidar_pts > 0. Every shipped
        # reference config trains with use_valid_flag=True.
        if len(gt_boxes):
            mask = None
            if self.cfg.use_valid_flag and "valid_flag" in info:
                mask = np.asarray(info["valid_flag"], bool)
            elif not self.cfg.use_valid_flag and "num_lidar_pts" in info:
                mask = np.asarray(info["num_lidar_pts"]) > 0
            if mask is not None and len(mask) == len(gt_boxes):
                gt_boxes, gt_vel, gt_labels = gt_boxes[mask], gt_vel[mask], gt_labels[mask]
        boxes9 = np.concatenate([gt_boxes[:, :7], gt_vel], -1) if len(gt_boxes) else np.zeros((0, 9))

        if self.training and len(boxes9):
            l2i, boxes9 = bev_rotate_scale(
                l2i, boxes9, rng, self.cfg.bev_rot_range, self.cfg.bev_scale_range
            )
        # bottom-center z -> gravity center for training targets
        if len(boxes9):
            boxes9 = boxes9.copy()
            boxes9[:, 2] += boxes9[:, 5] * 0.5

        # range + name filtering (ObjectRangeFilter semantics on the BEV range)
        if len(boxes9):
            keep = (
                (boxes9[:, 0] >= PC_RANGE[0]) & (boxes9[:, 0] <= PC_RANGE[3])
                & (boxes9[:, 1] >= PC_RANGE[1]) & (boxes9[:, 1] <= PC_RANGE[4])
            )
            boxes9, gt_labels = boxes9[keep], gt_labels[keep]

        G = self.cfg.max_gt
        gt_out = np.zeros((G, 9), np.float32)
        lab_out = np.zeros((G,), np.int32)
        val_out = np.zeros((G,), bool)
        n = min(len(boxes9), G)
        gt_out[:n] = boxes9[:n]
        lab_out[:n] = gt_labels[:n]
        val_out[:n] = True

        fh, fw = self.cfg.final_dim
        img2lidar = _safe_img2lidar(l2i)
        return {
            "images": np.stack(images).astype(np.float32),
            "img2lidar": img2lidar.astype(np.float32),
            "lidar2img": l2i.astype(np.float32),
            "img_hw": np.full((len(cams), 2), [fh, fw], np.float32),
            "gt_boxes": gt_out,
            "gt_labels": lab_out,
            "gt_valid": val_out,
            "timestamp": np.asarray(ts_list, np.float32),
            "token": info.get("token", str(idx)),
        }


def collate_batch(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = [k for k in samples[0] if k != "token"]
    out = {k: np.stack([s[k] for s in samples]) for k in keys}
    out["tokens"] = [s["token"] for s in samples]
    return out


class Loader:
    """Thread-prefetching batch loader with per-epoch shuffling."""

    def __init__(self, dataset: NuScenesDataset, batch_size: int, seed: int = 0,
                 shuffle: bool = True, num_threads: int = 4, drop_last: bool = True,
                 process_shard: Optional[tuple] = None):
        """``process_shard=(process_id, num_processes)`` makes this loader
        serve a disjoint stride of every epoch's (shared-seed) global order —
        the JAX-SPMD replacement for torch's DistributedSampler: every host
        runs the same script with the same seed, each reads only its own
        samples, and ``batch_size`` is the per-host (local) batch.
        """
        self.ds = dataset
        self.bs = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.num_threads = num_threads
        self.drop_last = drop_last
        self.process_shard = process_shard
        if process_shard is not None:
            pid, nproc = process_shard
            assert 0 <= pid < nproc, process_shard

    def __len__(self):
        n = len(self.ds)
        if self.process_shard is not None:
            # truncate to the floor count so every process runs the SAME
            # number of steps (unequal step counts deadlock the collectives)
            n = n // self.process_shard[1]
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def epoch(self, epoch: int):
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        if self.process_shard is not None:
            pid, nproc = self.process_shard
            order = order[pid::nproc][: len(self.ds) // nproc]
        n_batches = len(self)
        idx_batches = [
            order[i * self.bs : (i + 1) * self.bs] for i in range(n_batches)
        ]
        q: "queue.Queue" = queue.Queue(maxsize=self.num_threads * 2)
        stop = threading.Event()

        def worker(batch_ids):
            for bi in batch_ids:
                if stop.is_set():
                    return
                samples = [self.ds.get(int(i), seed=self.seed + epoch) for i in bi]
                q.put((bi[0], collate_batch(samples)))

        chunks = [idx_batches[t :: self.num_threads] for t in range(self.num_threads)]
        threads = [threading.Thread(target=worker, args=(c,), daemon=True) for c in chunks]
        for t in threads:
            t.start()
        try:
            # preserve deterministic order via reorder buffer
            buf: Dict[int, Dict] = {}
            expected = [b[0] for b in idx_batches]
            ei = 0
            received = 0
            while received < n_batches:
                k, v = q.get()
                buf[k] = v
                received += 1
                while ei < n_batches and expected[ei] in buf:
                    yield buf.pop(expected[ei])
                    ei += 1
            while ei < n_batches:
                yield buf.pop(expected[ei])
                ei += 1
        finally:
            stop.set()
