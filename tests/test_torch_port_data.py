"""The port's data layer against petr_tpu's, on the CPU: bit for bit.

`petr_tpu_torch/data/` is a copy of `petr_tpu/data/` (numpy and PIL, and
the native C++ branch), so for the same records, seed and
config every array must be equal to the last bit: the synthetic renderer's
files and info records, ``NuScenesDataset.get`` in both modes (synth_small,
tiny_debug_v2 with its sweep, synth_small_depthr with lidar2img, a corrupt
camera, ``use_valid_flag`` on and off, a photometric ``view_transform``),
``streaming_sample`` along scenes, ``Loader.epoch`` with and without a
process shard, the transforms, and ``build_infos`` over a fake devkit.

Either dataset takes its native branch when its library has been built
(petr_tpu's `native/dataload`, the port's ``build/libpetrdata-*.so``), and
that branch differs from PIL by pixel noise; each test that loads images
pins both packages to PIL (``pil_only``), so that a library someone built
changes no result. Both packages on the native branch are held to each
other in `tests/test_torch_port_native.py`.
"""

import copy
import dataclasses
import os
import pickle

import numpy as np
import pytest

from petr_tpu.configs import get_config as jax_config
from petr_tpu.data import dataset as jax_dataset
from petr_tpu.data import info as jax_info
from petr_tpu.data import synthetic as jax_synthetic
from petr_tpu.data import transforms as jax_transforms
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.data import dataset, info, synthetic, transforms
from tests.test_info_builder import fake_db  # noqa: F401  (pytest fixture)

SRC_HW = (128, 320)


def assert_same(a, b, where="", roots=None):
    """Nested dicts / lists / arrays / scalars equal exactly; a string under
    ``roots[0]`` must be the same path under ``roots[1]``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}", roots)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]", roots)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, (where, a, b)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, str) and roots and a.startswith(roots[0]):
        assert b == roots[1] + a[len(roots[0]):], (where, a, b)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (where, a, b)


@pytest.fixture
def pil_only(monkeypatch):
    monkeypatch.setattr("petr_tpu.data.native.available", lambda: False)
    monkeypatch.setattr("petr_tpu_torch.data.native.available", lambda: False)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """3 scenes of 2 frames at 128x320, one held out, rendered by the port."""
    out = str(tmp_path_factory.mktemp("synth"))
    return synthetic.generate_synthetic_scenes(out, n_scenes=3, frames_per_scene=2, image_hw=SRC_HW,
                                               n_objects=5, val_scenes=1, seed=3)


@pytest.mark.parametrize("frames,velocity_hue", [(1, True), (2, False), (2, True)])
def test_synthetic_scenes_match(tmp_path, frames, velocity_hue):
    roots = (str(tmp_path / "jax"), str(tmp_path / "port"))
    kw = dict(n_scenes=2, frames_per_scene=frames, image_hw=(48, 96), n_objects=4, val_scenes=1, seed=7,
              velocity_hue=velocity_hue)
    want = jax_synthetic.generate_synthetic_scenes(roots[0], **kw)
    got = synthetic.generate_synthetic_scenes(roots[1], **kw)
    assert_same(want, got, "infos", roots)
    names = sorted(os.listdir(roots[0]))
    assert names == sorted(os.listdir(roots[1]))
    assert sum(n.endswith(".jpg") for n in names) == 2 * (frames + 1) * 6  # a warm-up sweep per scene
    for n in names:
        with open(os.path.join(roots[0], n), "rb") as f, open(os.path.join(roots[1], n), "rb") as g:
            if n.endswith(".pkl"):
                assert_same(pickle.load(f), pickle.load(g), n, roots)
            else:
                assert f.read() == g.read(), n


def _datasets(infos, name, training, overrides=(), **kw):
    jcfg, cfg = jax_config(name, list(overrides)), get_config(name, list(overrides))
    assert dataclasses.asdict(jcfg.data) == dataclasses.asdict(cfg.data)
    return (jax_dataset.NuScenesDataset(infos, jcfg.data, training=training, src_hw=SRC_HW, **kw),
            dataset.NuScenesDataset(infos, cfg.data, training=training, src_hw=SRC_HW, **kw))


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("name", ["synth_small", "tiny_debug_v2", "synth_small_depthr"])
def test_get_matches(pil_only, scenes, name, training):
    want_ds, got_ds = _datasets(scenes["train"] + scenes["val"], name, training)
    for idx in range(len(want_ds)):
        for seed in (0, 5):
            want, got = want_ds.get(idx, seed), got_ds.get(idx, seed)
            assert_same(want, got, f"{name}[{idx}]")
    n_views = 12 if name == "tiny_debug_v2" else 6
    assert got["images"].shape[0] == n_views and "lidar2img" in got


@pytest.mark.parametrize("use_valid_flag", [True, False])
def test_get_matches_with_gt_filters_and_a_corrupt_camera(pil_only, scenes, use_valid_flag):
    infos = copy.deepcopy(scenes["train"][:2])
    infos[0]["valid_flag"][:2] = False
    infos[0]["num_lidar_pts"][1:3] = 0
    infos[0]["cams"]["CAM_BACK"]["sensor2lidar_rotation"] = np.zeros((3, 3))  # singular
    infos[1]["cams"]["CAM_FRONT_LEFT"]["sensor2lidar_translation"] = np.array([np.nan, 0.0, 1.0])
    want_ds, got_ds = _datasets(infos, "synth_small", True, [f"data.use_valid_flag={use_valid_flag}"])
    for idx in range(2):
        assert_same(want_ds.get(idx, 1), got_ds.get(idx, 1), f"[{idx}]")
    far = got_ds.get(0, 1)["img2lidar"][3]
    assert far[0, 3] == 1e4  # the corrupt view back-projects far away
    assert got_ds.get(0, 1)["gt_valid"].sum() == len(infos[0]["gt_boxes"]) - 2


def test_get_matches_with_photometric_view_transform(pil_only, scenes):
    infos = scenes["train"][:2]
    cfg, jcfg = get_config("synth_small"), jax_config("synth_small")
    want_ds = jax_dataset.NuScenesDataset(infos, jcfg.data, training=True, src_hw=SRC_HW,
                                          view_transform=jax_transforms.photometric_distortion)
    got_ds = dataset.NuScenesDataset(infos, cfg.data, training=True, src_hw=SRC_HW,
                                     view_transform=transforms.photometric_distortion)
    assert_same(want_ds.get(1, 2), got_ds.get(1, 2))


def test_streaming_sample_matches_along_scenes(pil_only, scenes):
    selfpad = copy.deepcopy(scenes["train"][2])
    selfpad["sweeps_cams"] = []  # no stored sweep: the previous frame self-pads
    infos = scenes["val"] + scenes["train"][:2] + [selfpad]  # a held-out scene, a training one, no sweep
    want_ds, got_ds = _datasets(infos, "tiny_debug_v2", False)
    # (sample, previous sample or None) -> what the previous frame should be
    steps = [(0, None, "prime"), (1, 0, "cached"), (2, 1, "prime"), (3, 2, "cached"), (4, None, "pad")]
    for idx, prev, kind in steps:
        prev_info = None if prev is None else infos[prev]
        want, got = want_ds.streaming_sample(idx, prev_info), got_ds.streaming_sample(idx, prev_info)
        assert_same(want, got, f"[{idx}]")
        seen = "cached" if got["cached"] else "prime" if got["prev_images"] is not None else "pad"
        assert seen == kind, (idx, seen, kind)


@pytest.mark.parametrize("shard", [None, (1, 2)])
def test_loader_epoch_matches(pil_only, scenes, shard):
    infos = scenes["train"] + scenes["val"]
    want_ds, got_ds = _datasets(infos, "tiny_debug_v2", True)
    kw = dict(batch_size=2, seed=4, shuffle=True, num_threads=2, drop_last=False, process_shard=shard)
    want_loader, got_loader = jax_dataset.Loader(want_ds, **kw), dataset.Loader(got_ds, **kw)
    assert len(want_loader) == len(got_loader)
    for epoch in (0, 1):
        want, got = list(want_loader.epoch(epoch)), list(got_loader.epoch(epoch))
        assert len(got) == len(got_loader)
        assert_same(want, got, f"epoch {epoch}")
    assert sum(len(b["tokens"]) for b in got) == (len(infos) if shard is None else len(infos) // 2)


def _ida_params(rng, training):
    return jax_transforms.sample_ida_params(rng, (900, 1600), (320, 800), (0.47, 0.625), (0.0, 0.1),
                                            (-5.4, 5.4), True, training)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transforms_match(seed):
    for training in (True, False):
        want = _ida_params(np.random.default_rng(seed), training)
        got = transforms.sample_ida_params(np.random.default_rng(seed), (900, 1600), (320, 800), (0.47, 0.625),
                                           (0.0, 0.1), (-5.4, 5.4), True, training)
        assert dataclasses.asdict(want) == dataclasses.asdict(got)
        assert_same(jax_transforms.ida_matrix(want), transforms.ida_matrix(got))
    rng = np.random.default_rng(seed)
    l2i, boxes = rng.normal(size=(6, 4, 4)), rng.normal(size=(5, 9))
    assert_same(jax_transforms.bev_rotate_scale(l2i, boxes, np.random.default_rng(seed)),
                transforms.bev_rotate_scale(l2i, boxes, np.random.default_rng(seed)))
    img = rng.uniform(0, 255, (24, 40, 3)).astype(np.float32)
    specs = [{"type": "Blur", "blur_limit": 7, "p": 0.7}, {"type": "RandomBrightnessContrast", "p": 0.7},
             {"type": "CoarseDropout", "max_holes": 4, "max_height": 5, "max_width": 6, "fill_value": 3, "p": 0.7}]
    assert_same(jax_transforms.albu_native(specs)(img, np.random.default_rng(seed)),
                transforms.albu_native(specs)(img, np.random.default_rng(seed)))
    assert_same(jax_transforms.photometric_distortion(img, np.random.default_rng(seed)),
                transforms.photometric_distortion(img, np.random.default_rng(seed)))
    mean, std = (103.53, 116.28, 123.675), (57.375, 57.12, 58.395)
    assert_same(jax_transforms.pad_image(jax_transforms.normalize_image(img, mean, std, True), (32, 48)),
                transforms.pad_image(transforms.normalize_image(img, mean, std, True), (32, 48)))


def test_albu_multiview_raises_without_albumentations(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "albumentations", None)  # import raises ImportError
    with pytest.raises(ImportError, match="albumentations"):
        transforms.albu_multiview([{"type": "Blur"}])


@pytest.mark.parametrize("split", ["train", "val"])
def test_build_infos_matches(fake_db, split):  # noqa: F811
    kw = dict(nusc=fake_db, train_scenes=["scene-0001"] if split == "train" else [],
              val_scenes=["scene-0001"] if split == "val" else [])
    want = jax_info.build_infos("", **kw)
    got = info.build_infos("", **kw)
    assert_same(want, got)
    assert len(got[split]) == 1 and got[split][0]["gt_boxes"].shape == (1, 7)
    assert info.NAME_MAPPING == jax_info.NAME_MAPPING and info.CAM_NAMES == jax_info.CAM_NAMES
