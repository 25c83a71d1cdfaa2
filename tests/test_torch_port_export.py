"""The port's AOT serving artifacts against its eager serving, and against
petr_tpu's artifacts on the same weights, on the CPU.

``export_serving`` / ``save_artifact`` / ``load_artifact`` with the weights
embedded and passed in, on tiny_debug in fp32 and with its int8 backbone
(``cli.export --quant-scales``); the artifact replayed in a process that
imports no model module; the streaming pair on tiny_debug_v2 against
``StreamingPETRv2`` frame by frame; Depthr refused; ``cli.export``. The
port's artifacts replay the same aten ops and the same kernels' plain
versions as the eager step, so they are held to it bit for bit. petr_tpu's
artifact is a separate XLA compilation; its decoded boxes are held to the
port's as ``tests/test_torch_port_eval.py`` holds the two packages'
decodes (tolerances at the test).
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petr_tpu.configs import get_config as jax_config
from petr_tpu.models import PETRDetector as JDetector
from petr_tpu.serve import export_serving as jax_export_serving
from petr_tpu.serve import load_artifact as jax_load_artifact
from petr_tpu.serve import save_artifact as jax_save_artifact
from petr_tpu.utils.torch_convert import convert_state_dict
from petr_tpu_torch.cli import export as cli_export
from petr_tpu_torch.cli.quantize import synthetic_batch
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.models.layers import FrozenBatchNorm
from petr_tpu_torch.ops import conv_int8
from petr_tpu_torch.quant import calibrate_detector, save_scales, set_quant
from petr_tpu_torch.serve import (
    StreamingArtifactRunner,
    StreamingPETRv2,
    build_detector,
    export_serving,
    load_artifact,
    make_serving_fn,
    save_artifact,
)

KEYS = ("images", "img2lidar", "img_hw")
SCORE_TOL = 2e-7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tiny_debug (random weights from seed 0, fp32), its eager serving
    outputs, and its artifact exported once with the weights embedded and
    once without."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("export")
    cfg = get_config("tiny_debug")
    model = build_detector(cfg, seed=0, device="cpu")
    randomize_bn(model, np.random.RandomState(0))  # scores spread apart, as trained ones are
    batch = synthetic_batch(cfg, 1, 3)
    inputs = [batch[k] for k in KEYS]
    paths, metas = {}, {}
    for embed in (True, False):
        paths[embed] = str(root / f"tiny_{embed}.petrx")
        metas[embed] = save_artifact(paths[embed], export_serving(cfg, model, embed_params=embed), cfg, model,
                                     batch_size=1, embed_params=embed)
    yield types.SimpleNamespace(cfg=cfg, model=model, inputs=inputs, paths=paths, metas=metas,
                                want=make_serving_fn(cfg, model, "cpu")(*inputs))
    torch.set_num_threads(threads)


def randomize_bn(model, rng):
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k].cpu() if torch.is_tensor(got[k]) else got[k]), v, err_msg=k)


@pytest.mark.parametrize("embed", [True, False], ids=["embedded", "external"])
def test_serving_artifact_replays_the_serving_step(tiny, embed):
    path, meta = tiny.paths[embed], tiny.metas[embed]
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == ["meta.json", "program.pt2"]
        assert json.loads(z.read("meta.json")) == meta
    assert meta["format"] == "petr_tpu_torch.serve/1" and meta["ops"] == "petr_tpu_torch.ops"
    assert meta["op_names"] == ["petr_tpu_torch.flash_cross_attention_fwd.default"]
    assert (meta["config"], meta["quant"], meta["device"], meta["batch_size"]) == ("tiny_debug", "none", "cpu", 1)
    assert list(meta["input_spec"]) == list(KEYS)
    params = None if embed else list(tiny.model.state_dict().values())
    fn, _ = load_artifact(path, params)
    _equal(fn(*tiny.inputs), tiny.want)
    if not embed:
        with pytest.raises(ValueError, match="params"):
            load_artifact(path)
        # other weights through the same program: the eager step on them
        sd = {k: v * 1.01 if v.is_floating_point() else v for k, v in tiny.model.state_dict().items()}
        twin = build_detector(tiny.cfg, device="cpu")
        twin.load_state_dict(sd)
        fn2, _ = load_artifact(path, list(sd.values()))
        _equal(fn2(*tiny.inputs), make_serving_fn(tiny.cfg, twin, "cpu")(*tiny.inputs))


def test_serving_artifact_matches_petr_tpus(tiny, tmp_path):
    """The same weights exported by both packages; petr_tpu's replay against
    the port's (a separate XLA compilation): the decoded scores sorted within
    2e-7 (fp32; random weights put them 1e-7 to 1e-6 apart), labels and boxes
    at the ranks whose scores stand 4e-7 apart. petr_tpu's export runs its
    plain attention branch (``use_flash_attention=False``; its Pallas kernel
    in interpret mode would cost most of this file's time), which equals the
    flash semantics where no row is fully masked, as here."""
    jcfg = jax_config("tiny_debug")
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, use_flash_attention=False))
    one = [jnp.asarray(a) for a in tiny.inputs]
    shapes = jax.eval_shape(JDetector(jcfg.model, deterministic=True).init, jax.random.PRNGKey(0), *one)["params"]
    params, stats = convert_state_dict({k: v.numpy().copy() for k, v in tiny.model.state_dict().items()},
                                       jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    assert stats["skipped"] == 0 and stats["unfilled"] == 0
    jpath = str(tmp_path / "jax.petrx")
    jax_save_artifact(jpath, jax_export_serving(jcfg, params, embed_params=True), jcfg, batch_size=1,
                      embed_params=True)
    call, jmeta = jax_load_artifact(jpath)
    want = {k: np.asarray(v) for k, v in call(*one).items()}
    path, meta = tiny.paths[True], tiny.metas[True]
    assert {k: meta[k] for k in ("config", "batch_size", "embed_params", "input_spec", "quant")} == {
        k: jmeta[k] for k in ("config", "batch_size", "embed_params", "input_spec", "quant")}
    got = {k: v.numpy() for k, v in load_artifact(path)[0](*tiny.inputs).items()}
    s_w, s_g = want["scores"][0], got["scores"][0]
    np.testing.assert_allclose(np.sort(s_g)[::-1], np.sort(s_w)[::-1], rtol=0, atol=SCORE_TOL)
    order_w, order_g = np.argsort(-s_w, kind="stable"), np.argsort(-s_g, kind="stable")
    s = s_w[order_w]
    apart = np.ones(len(s), bool)
    apart[1:] &= (s[:-1] - s[1:]) > 2 * SCORE_TOL
    apart[:-1] &= (s[:-1] - s[1:]) > 2 * SCORE_TOL
    assert apart.mean() > 0.2, apart.mean()
    np.testing.assert_array_equal(got["labels"][0][order_g][apart], want["labels"][0][order_w][apart])
    np.testing.assert_allclose(got["boxes"][0][order_g][apart], want["boxes"][0][order_w][apart], rtol=0, atol=1e-4)


def test_artifact_replays_without_model_code(tiny, tmp_path):
    """A fresh process that imports the runtime and the op library and no
    model module replays the artifact to the same outputs."""
    path = tiny.paths[True]
    np.savez(str(tmp_path / "inputs.npz"), *tiny.inputs)
    code = f"""
import sys, numpy as np, torch
torch.set_num_threads(1)  # the parent's: the CPU's sum order depends on it
import petr_tpu_torch.runtime as runtime
fn, meta = runtime.load_artifact({path!r})
d = np.load({str(tmp_path / 'inputs.npz')!r})
out = fn(*[d[f"arr_{{i}}"] for i in range(3)])
np.savez({str(tmp_path / 'out.npz')!r}, **{{k: v.numpy() for k, v in out.items()}})
print(sorted(m for m in sys.modules if m.startswith("petr_tpu_torch.models") or m.startswith("petr_tpu_torch.serve")))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout
    got = dict(np.load(str(tmp_path / "out.npz")))
    _equal(got, tiny.want)


def test_streaming_artifact_matches_streaming_petrv2(tmp_path, capsys):
    """``cli.export --streaming --embed-params`` on tiny_debug_v2 (random
    weights from seed 0); three frames (the first self-padded) through the
    replayed pair, each equal to ``StreamingPETRv2.step`` bit for bit."""
    cfg = get_config("tiny_debug_v2")
    path = str(tmp_path / "s.petrx")
    meta = cli_export.main(["--config", "tiny_debug_v2", "--out", path, "--device", "cpu", "--embed-params",
                            "--streaming"])
    assert "exported tiny_debug_v2" in capsys.readouterr().out
    assert meta["format"] == "petr_tpu_torch.serve/streaming-1" and meta["quant"] == "none"
    assert list(meta["input_spec"]) == ["images", "img2lidar", "img_hw", "timestamp"]
    runner = StreamingArtifactRunner(path)
    assert runner.meta == meta
    stream = StreamingPETRv2(cfg, build_detector(cfg, seed=0, device="cpu"), device="cpu")
    rng = np.random.RandomState(0)
    N, (H, W) = 2 * cfg.data.num_views, cfg.data.image_size
    cams = synthetic_batch(cfg, 1, 0)["img2lidar"]
    for frame in range(3):
        images = rng.randn(1, cfg.data.num_views, H, W, 3).astype(np.float32)
        ts = np.concatenate([np.zeros((1, 6)), np.full((1, 6), 0.5 + 0.1 * frame)], 1).astype(np.float32)
        hw = np.full((1, N, 2), [H, W], np.float32)
        got, want = runner.step(images, cams, hw, ts), stream.step(images, cams, hw, ts)
        for k in want:
            assert torch.equal(got[k], want[k]), (frame, k)
    runner.reset()
    assert runner._prev is None


def test_depthr_has_no_artifact():
    cfg = get_config("synth_small_depthr")
    model = build_detector(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="no serving path"):
        export_serving(cfg, model)
    with pytest.raises(NotImplementedError, match="no serving path"):
        make_serving_fn(cfg, model, "cpu")


def test_cli_export_int8(tmp_path, capsys):
    """``cli.export --quant-scales`` on the CPU (random weights from seed 0,
    as the eager reference draws them): the scales go into the program,
    which runs the int8 conv's op (here its plain version, which counts no
    launch) as the eager int8 step does, bit for bit."""
    cfg = get_config("tiny_debug")
    model = build_detector(cfg, seed=0, device="cpu")
    scales = calibrate_detector(cfg, model, [synthetic_batch(cfg, 1, 0)])
    save_scales(str(tmp_path / "s.npz"), scales)
    out = str(tmp_path / "x.petrx")
    meta = cli_export.main(["--config", "tiny_debug", "--out", out, "--device", "cpu",
                            "--quant-scales", str(tmp_path / "s.npz")])
    assert "exported tiny_debug" in capsys.readouterr().out
    assert meta["quant"] == "int8" and "petr_tpu_torch.conv_int8_bn_act.default" in meta["op_names"]
    before = conv_int8.LAUNCHES
    inputs = [synthetic_batch(cfg, 1, 1)[k] for k in KEYS]
    want = make_serving_fn(cfg, model, "cpu", quant_scales=scales)(*inputs)
    _equal(load_artifact(out, list(model.state_dict().values()))[0](*inputs), want)
    assert conv_int8.LAUNCHES == before
    set_quant(model, "none")
    assert not np.array_equal(make_serving_fn(cfg, model, "cpu")(*inputs)["scores"], want["scores"])
