"""Host-side image/geometry transforms (NumPy + PIL), deterministic per-seed.

The port's copy of `petr_tpu/data/transforms.py`, function for function;
PIL is imported by the functions that resample, never on import.

Behavioral reference: `datasets/pipelines/transform_3d.py` (sty61010/PETR):
  * IDA augmentation (`:362-465`): ONE sampled (resize, crop, flip, rotate)
    applied to all views; the 3x3 ``ida_mat`` is composed into the camera
    intrinsics and lidar2img recomputed as ``intrinsics @ extrinsics.T``.
  * BEV-space rot/scale (`:468-548`): world rotated about z / scaled;
    ``lidar2img``'s are right-multiplied by the inverse transform and GT
    boxes transformed coherently (centers by R/s, yaw += angle, velocity by
    R2). The reference's `reverse_angle` sign convention is absorbed here by
    keeping box and camera transforms mutually consistent (the sampled range
    is symmetric, so the distribution is identical).
  * Normalize (`:80-113`) and pad-to-divisor (`:28-77`).

All functions are pure; randomness comes from an explicit
``np.random.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:
    from PIL import Image


@dataclasses.dataclass
class IdaParams:
    resize: float
    resize_dims: Tuple[int, int]  # (W, H) for PIL
    crop: Tuple[int, int, int, int]  # (left, top, right, bottom)
    flip: bool
    rotate_deg: float


def sample_ida_params(
    rng: np.random.Generator,
    src_hw: Tuple[int, int],
    final_hw: Tuple[int, int],
    resize_lim: Tuple[float, float],
    bot_pct_lim: Tuple[float, float] = (0.0, 0.0),
    rot_lim: Tuple[float, float] = (0.0, 0.0),
    rand_flip: bool = True,
    training: bool = True,
) -> IdaParams:
    H, W = src_hw
    fH, fW = final_hw
    if training:
        resize = float(rng.uniform(*resize_lim))
        newW, newH = int(W * resize), int(H * resize)
        crop_h = int((1 - rng.uniform(*bot_pct_lim)) * newH) - fH
        crop_w = int(rng.uniform(0, max(0, newW - fW)))
        flip = bool(rand_flip and rng.integers(2))
        rot = float(rng.uniform(*rot_lim))
    else:
        resize = max(fH / H, fW / W)
        newW, newH = int(W * resize), int(H * resize)
        crop_h = int((1 - np.mean(bot_pct_lim)) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        flip = False
        rot = 0.0
    crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
    return IdaParams(resize, (newW, newH), crop, flip, rot)


def _rot2(deg: float) -> np.ndarray:
    h = np.deg2rad(deg)
    return np.array([[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]])


def ida_matrix(p: IdaParams) -> np.ndarray:
    """3x3 pixel-space homography matching the image op sequence
    (resize -> crop -> flip -> rotate-about-crop-center)."""
    R = np.eye(2) * p.resize
    t = -np.asarray(p.crop[:2], np.float64)
    if p.flip:
        A = np.array([[-1.0, 0.0], [0.0, 1.0]])
        b = np.array([p.crop[2] - p.crop[0], 0.0])
        R = A @ R
        t = A @ t + b
    A = _rot2(p.rotate_deg)
    b = np.array([p.crop[2] - p.crop[0], p.crop[3] - p.crop[1]]) / 2.0
    b = A @ (-b) + b
    R = A @ R
    t = A @ t + b
    M = np.eye(3)
    M[:2, :2] = R
    M[:2, 2] = t
    return M


def apply_ida(img: Image.Image, p: IdaParams) -> Image.Image:
    from PIL import Image

    img = img.resize(p.resize_dims)
    img = img.crop(p.crop)
    if p.flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if p.rotate_deg:
        img = img.rotate(p.rotate_deg)
    return img


def update_intrinsics_ida(intrinsics4: np.ndarray, p: IdaParams) -> np.ndarray:
    """intrinsics[:3,:3] <- ida_mat @ intrinsics[:3,:3] (4x4 viewpad form)."""
    out = intrinsics4.copy()
    out[:3, :3] = ida_matrix(p) @ intrinsics4[:3, :3]
    return out


def compose_lidar2img(intrinsics4: np.ndarray, extrinsics4: np.ndarray) -> np.ndarray:
    """lidar2img = viewpad @ lidar2cam_rt.T  (nuscenes_dataset.py:56-66)."""
    return intrinsics4 @ extrinsics4.T


def bev_rotate_scale(
    lidar2imgs: np.ndarray,  # (N, 4, 4)
    gt_boxes: np.ndarray,  # (G, 9) (cx,cy,cz,w,l,h,yaw,vx,vy)
    rng: np.random.Generator,
    rot_range: Tuple[float, float] = (-0.3925, 0.3925),
    scale_range: Tuple[float, float] = (0.95, 1.05),
) -> Tuple[np.ndarray, np.ndarray]:
    """World-frame rotation about z + isotropic scaling, applied coherently to
    cameras and boxes: points map p -> s * Rz(a) p."""
    a = float(rng.uniform(*rot_range))
    s = float(rng.uniform(*scale_range))
    c, si = np.cos(a), np.sin(a)
    R4 = np.array(
        [[c, -si, 0, 0], [si, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64
    )
    S4 = np.diag([s, s, s, 1.0])
    T = S4 @ R4  # world transform
    Tinv = np.linalg.inv(T)
    l2i = lidar2imgs @ Tinv[None]

    out = gt_boxes.copy()
    if len(out):
        xyz = out[:, :3] @ (R4[:3, :3].T) * s
        out[:, :3] = xyz
        out[:, 3:6] *= s
        out[:, 6] += a
        if out.shape[1] > 7:
            out[:, 7:9] = out[:, 7:9] @ np.array([[c, -si], [si, c]]).T * s
    return l2i.astype(np.float64), out


def photometric_distortion(
    img: np.ndarray,
    rng: np.random.Generator,
    brightness_delta: float = 32.0,
    contrast_range: Tuple[float, float] = (0.5, 1.5),
    saturation_range: Tuple[float, float] = (0.5, 1.5),
    hue_delta: float = 18.0,
) -> np.ndarray:
    """Photometric distortion per view (PhotoMetricDistortionMultiViewImage,
    transform_3d.py:684-781): random brightness -> random contrast (before or
    after color ops) -> saturation -> hue -> random channel swap. Input/output
    float32 BGR HWC, unnormalized."""
    img = img.astype(np.float32)
    if rng.integers(2):
        img = img + rng.uniform(-brightness_delta, brightness_delta)
    contrast_first = bool(rng.integers(2))
    if contrast_first and rng.integers(2):
        img = img * rng.uniform(*contrast_range)
    # HSV ops via colorsys-free vectorized conversion
    def to_hsv(bgr):
        b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
        maxc = np.maximum(np.maximum(r, g), b)
        minc = np.minimum(np.minimum(r, g), b)
        v = maxc
        s = np.where(maxc > 0, (maxc - minc) / np.maximum(maxc, 1e-6), 0)
        rc = (maxc - r) / np.maximum(maxc - minc, 1e-6)
        gc = (maxc - g) / np.maximum(maxc - minc, 1e-6)
        bc = (maxc - b) / np.maximum(maxc - minc, 1e-6)
        h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
        h = (h / 6.0) % 1.0
        return h, s, v

    def to_bgr(h, s, v):
        i = np.floor(h * 6.0)
        f = h * 6.0 - i
        p = v * (1 - s)
        q = v * (1 - s * f)
        t = v * (1 - s * (1 - f))
        i = i.astype(int) % 6
        r = np.choose(i, [v, q, p, p, t, v])
        g = np.choose(i, [t, v, v, q, p, p])
        b = np.choose(i, [p, p, t, v, v, q])
        return np.stack([b, g, r], -1)

    # mmdet gates saturation and hue independently at 1/2 each (it always
    # round-trips through HSV); skip the conversion only when neither fires
    do_sat, do_hue = bool(rng.integers(2)), bool(rng.integers(2))
    if do_sat or do_hue:
        h, s, v = to_hsv(np.clip(img, 0, 255) / 255.0)
        if do_sat:
            s = np.clip(s * rng.uniform(*saturation_range), 0, 1)
        if do_hue:
            h = (h + rng.uniform(-hue_delta, hue_delta) / 360.0) % 1.0
        img = to_bgr(h, s, v) * 255.0
    if not contrast_first and rng.integers(2):
        img = img * rng.uniform(*contrast_range)
    if rng.integers(2):
        img = img[..., rng.permutation(3)]
    return img.astype(np.float32)


def _box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """k x k box blur, reflect-101 borders (cv2.blur default) via integral
    image — no cv2/scipy dependency."""
    pad = k // 2
    x = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="reflect").astype(np.float64)
    c = np.cumsum(np.cumsum(x, 0), 1)
    c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
    s = c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
    return (s / (k * k)).astype(np.float32)


def albu_native(transforms: Sequence[dict], max_value: float = 255.0):
    """Native NumPy implementations of the commonest albumentations ops —
    the reference's ``AlbuMultiview3D`` capability (transform_3d.py:550-682,
    registered but unused by every shipped config) without the optional
    dependency. Supported specs (mmcv-style dicts):

      {"type": "Blur", "blur_limit": 7, "p": 0.5}
          random odd box-kernel size in [3, blur_limit], reflect-101 borders
      {"type": "RandomBrightnessContrast", "brightness_limit": 0.2,
       "contrast_limit": 0.2, "p": 0.5}
          img * (1 + U(-c, c)) + U(-b, b) * max_value
      {"type": "CoarseDropout" | "Cutout", "max_holes": 8, "max_height": 8,
       "max_width": 8, "fill_value": 0, "p": 0.5}
          random filled rectangles

    Returns a callable ``(img_f32_hwc, rng) -> img_f32_hwc`` for
    ``NuScenesDataset(view_transform=...)``. Unknown types raise at build
    time (fail fast, like the reference's albumentations Compose would).
    """
    specs = []
    for t in transforms:
        t = dict(t)
        kind = t.pop("type")
        if kind not in ("Blur", "RandomBrightnessContrast", "CoarseDropout",
                       "Cutout"):
            raise ValueError(f"albu_native: unsupported transform {kind!r} "
                             "(use albu_multiview with the albumentations "
                             "package, or any per-view callable)")
        if kind == "Blur" and int(t.get("blur_limit", 7)) < 3:
            raise ValueError("albu_native: Blur blur_limit must be >= 3")
        specs.append((kind, t))

    def apply(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        img = img.astype(np.float32)
        for kind, t in specs:
            if rng.random() >= t.get("p", 0.5):
                continue
            if kind == "Blur":
                # odd kernel in [3, blur_limit] inclusive (albumentations
                # semantics: an even limit must not be exceeded)
                lim = int(t.get("blur_limit", 7))
                k = int(rng.integers(1, (lim - 1) // 2 + 1)) * 2 + 1
                img = _box_blur(img, k)
            elif kind == "RandomBrightnessContrast":
                alpha = 1.0 + rng.uniform(-1, 1) * t.get("contrast_limit", 0.2)
                beta = rng.uniform(-1, 1) * t.get("brightness_limit", 0.2)
                img = np.clip(img * alpha + beta * max_value, 0, max_value)
            else:  # CoarseDropout / Cutout
                h, w = img.shape[:2]
                n = int(rng.integers(1, int(t.get("max_holes", 8)) + 1))
                fill = float(t.get("fill_value", 0))
                for _ in range(n):
                    hh = int(rng.integers(1, int(t.get("max_height", 8)) + 1))
                    ww = int(rng.integers(1, int(t.get("max_width", 8)) + 1))
                    y = int(rng.integers(0, max(h - hh, 0) + 1))
                    x = int(rng.integers(0, max(w - ww, 0) + 1))
                    img[y : y + hh, x : x + ww] = fill
        return img

    return apply


def albu_multiview(transforms: Sequence[dict]):
    """Albumentations wrapper per view (reference ``AlbuMultiview3D``,
    transform_3d.py:550-682 — registered but unused by shipped configs).

    Returns a callable ``imgs -> imgs`` applying the composed albumentations
    pipeline to every view independently. Albumentations is an optional
    dependency (not shipped in the TPU image); any plain-python per-view
    callable composes the same way through ``Dataset`` transforms, so this
    shim only exists for config-level drop-in parity.
    """
    try:
        import albumentations
    except ImportError as e:  # pragma: no cover - optional dep
        raise ImportError(
            "albu_multiview needs the optional 'albumentations' package; "
            "use photometric_distortion or any per-view callable instead"
        ) from e

    compose = albumentations.Compose(
        [albumentations.from_dict({"transform": t}) if isinstance(t, dict) else t
         for t in transforms]
    )

    def apply(imgs):
        return [compose(image=np.asarray(img))["image"] for img in imgs]

    return apply


def normalize_image(
    img: np.ndarray,
    mean: Sequence[float],
    std: Sequence[float],
    to_rgb: bool = False,
) -> np.ndarray:
    """Per-channel (x - mean) / std; input HWC uint8/float in BGR order by
    convention (caffe-style pretrained backbones)."""
    img = img.astype(np.float32)
    if to_rgb:
        img = img[..., ::-1]
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def pad_image(img: np.ndarray, target_hw: Tuple[int, int]) -> np.ndarray:
    """Zero-pad bottom/right to the static (H, W)."""
    H, W = target_hw
    h, w = img.shape[:2]
    assert h <= H and w <= W, (img.shape, target_hw)
    out = np.zeros((H, W, img.shape[2]), img.dtype)
    out[:h, :w] = img
    return out
