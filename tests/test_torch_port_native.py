"""The port's native C++ loader (``data/native.py``, ``csrc/dataload.cpp``)
against petr_tpu's (`petr_tpu/data/native.py`, `native/dataload/`) and
against the PIL path, on the CPU.

Both libraries are built here with g++ (the port's ``compile_command``)
into temporary directories, never into the shared ``build/``: the port's
through ``native.build(tmp)``, petr_tpu's from its own source, bound by
setting ``petr_tpu.data.native``'s module state for the test. Built with
one command from the same code, the two give identical arrays, and both
datasets on the native branch give identical batches. The native path
against PIL is held to petr_tpu's limits (`tests/test_native_dataload.py`:
median error < 0.05, 99% of pixels < 0.25).
"""

import io
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from petr_tpu.configs import get_config as jax_config
from petr_tpu.data import dataset as jax_dataset
from petr_tpu.data import native as jax_native
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.data import dataset, native
from petr_tpu_torch.data import generate_synthetic_scenes
from petr_tpu_torch.data.transforms import IdaParams, apply_ida, normalize_image, pad_image

ROOT = Path(__file__).resolve().parents[1]
MEAN, STD = (103.53, 116.28, 123.675), (57.375, 57.12, 58.395)
SRC_HW = (90, 160)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None or not Path("/usr/include/jpeglib.h").exists(),
                                reason="needs g++ and libjpeg's headers")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """(the port's library, petr_tpu's library), built in temporary directories."""
    port_lib = native.library_path(tmp_path_factory.mktemp("port_build"))
    native_state = native._LIB, native._TRIED
    assert native.build(port_lib.parent) == port_lib and native.available()
    native._LIB, native._TRIED = native_state  # each test binds what it uses
    jax_lib = tmp_path_factory.mktemp("jax_build") / "libpetrdata.so"
    subprocess.run(native.compile_command(ROOT / "native" / "dataload" / "dataload.cpp", jax_lib), check=True)
    return port_lib, jax_lib


@pytest.fixture
def both_native(monkeypatch, libs):
    """Both packages bound to their libraries for one test."""
    port_lib, jax_lib = libs
    monkeypatch.setattr(native, "_LIB", native._load(port_lib))
    monkeypatch.setattr(native, "_TRIED", True)
    monkeypatch.setattr(jax_native, "_SO_PATHS", [str(jax_lib)])
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", False)
    assert native.available() and jax_native.available()


def make_jpeg(h, w, seed=0):
    rng = np.random.RandomState(seed)
    # smooth image so JPEG loss doesn't dominate the comparison
    base = rng.rand(h // 8 + 1, w // 8 + 1, 3) * 255
    img = np.asarray(Image.fromarray(base.astype(np.uint8)).resize((w, h), Image.BILINEAR))
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def _process(module, jpegs, p, out_hw, **kw):
    return module.process_images(jpegs, resize_wh=p.resize_dims, crop=p.crop, flip=p.flip, out_hw=out_hw,
                                 mean=MEAN, std=STD, **kw)


# (resize, resize_dims (W, H), crop (left, top, right, bottom)) from 90x160
IDA = [(0.5, (80, 45), (0, 13, 80, 45)), (0.55, (88, 49), (5, 17, 85, 49)), (0.6, (96, 54), (9, 8, 89, 40))]


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("ida", IDA)
def test_port_library_is_petr_tpus(both_native, flip, ida):
    jpegs = [make_jpeg(*SRC_HW, seed=v) for v in range(6)]
    p = IdaParams(*ida, flip, 0.0)
    got = _process(native, jpegs, p, (32, 80), n_threads=3)
    want = _process(jax_native, jpegs, p, (32, 80), n_threads=2)
    assert got.shape == (6, 32, 80, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flip", [False, True])
def test_native_matches_pil_path(both_native, flip):
    jpeg = make_jpeg(*SRC_HW)
    p = IdaParams(*IDA[0], flip, 0.0)
    out = _process(native, [jpeg], p, (32, 80))[0]
    arr = np.asarray(apply_ida(Image.open(io.BytesIO(jpeg)), p), np.float32)[..., ::-1]  # RGB -> BGR
    want = pad_image(normalize_image(arr, MEAN, STD, False), (32, 80))
    err = np.abs(out - want)
    # bicubic fp32 vs PIL's fixed-point intermediate: small pixel noise
    assert np.median(err) < 0.05, np.median(err)
    assert (err < 0.25).mean() > 0.99, err.max()


def test_native_batch_parallel_and_bad_jpeg(both_native):
    jpegs = [make_jpeg(90, 160, seed=s) for s in range(12)]
    out = native.process_images(jpegs, resize_wh=(80, 45), crop=(0, 13, 80, 45), flip=False, out_hw=(32, 80),
                                mean=(0, 0, 0), std=(1, 1, 1), n_threads=4)
    assert out.shape == (12, 32, 80, 3) and not np.allclose(out[0], out[1])
    with pytest.raises(RuntimeError, match="failed to decode"):
        native.process_images([b"not a jpeg"], resize_wh=(10, 10), crop=(0, 0, 10, 10), flip=False,
                              out_hw=(10, 10), mean=(0, 0, 0), std=(1, 1, 1))


def test_available_means_built(monkeypatch, tmp_path, libs):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert not native.available()
    with pytest.raises(RuntimeError, match="not built"):
        native.process_images([make_jpeg(16, 16)], resize_wh=(16, 16), crop=(0, 0, 16, 16), flip=False,
                              out_hw=(16, 16), mean=(0, 0, 0), std=(1, 1, 1))
    shutil.copy(libs[0], native.library_path(tmp_path))
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.available()  # found in BUILD_DIR under the source's hash


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("synth"))
    return generate_synthetic_scenes(out, n_scenes=2, frames_per_scene=2, image_hw=SRC_HW, n_objects=4,
                                     val_scenes=1, seed=5)


def _datasets(infos, training):
    jcfg, cfg = jax_config("tiny_debug_v2"), get_config("tiny_debug_v2")
    return (jax_dataset.NuScenesDataset(infos, jcfg.data, training=training, src_hw=SRC_HW),
            dataset.NuScenesDataset(infos, cfg.data, training=training, src_hw=SRC_HW))


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_datasets_on_the_native_branch_match(both_native, monkeypatch, scenes, training):
    """Both datasets on their native branch: the same samples and the same
    loader batches, bit for bit."""
    want_ds, got_ds = _datasets(scenes["train"] + scenes["val"], training)
    calls = []
    real = native.process_images
    monkeypatch.setattr(native, "process_images", lambda *a, **k: calls.append(1) or real(*a, **k))
    for idx in range(len(got_ds)):
        want, got = want_ds.get(idx, 3), got_ds.get(idx, 3)
        assert list(want) == list(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(calls) == len(got_ds)  # every sample took the native branch
    batches = zip(jax_dataset.Loader(want_ds, 2, seed=1).epoch(0), dataset.Loader(got_ds, 2, seed=1).epoch(0))
    for n, (want, got) in enumerate(batches, 1):
        assert list(want) == list(got)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert n == len(got_ds) // 2


def test_native_branch_is_within_limits_of_pil(both_native, monkeypatch, scenes):
    _, ds = _datasets(scenes["val"], False)
    got = ds.get(0, 0)["images"]
    monkeypatch.setattr(native, "available", lambda: False)
    want = ds.get(0, 0)["images"]
    err = np.abs(got - want)
    assert err.max() > 0.0  # the two branches did run
    assert np.median(err) < 0.05, np.median(err)
    assert (err < 0.25).mean() > 0.99, err.max()


def test_corrupt_jpeg_raises_pils_error(both_native, tmp_path, scenes):
    infos = [dict(scenes["val"][0], cams=dict(scenes["val"][0]["cams"]))]
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    infos[0]["cams"]["CAM_BACK"] = dict(infos[0]["cams"]["CAM_BACK"], data_path=str(bad))
    _, ds = _datasets(infos, False)
    with pytest.raises(Exception) as exc:
        ds.get(0, 0)
    assert "cannot identify image file" in str(exc.value)  # PIL's UnidentifiedImageError
