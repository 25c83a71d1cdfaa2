"""The port's evaluation, checkpoints and evaluation CLI against petr_tpu, on
the CPU, at tiny_debug size over rendered synthetic scenes.

One set of weights serves both packages: a seeded ``tiny_debug`` model of
the port (its frozen BN statistics drawn from a seed, so that features are
neither 0 nor huge) goes to a petr_tpu tree through petr_tpu's checkpoint
converter. petr_tpu's ``evaluate_model`` jits its eval step, which on the
CPU runs the Pallas flash attention in interpret mode; the port's runs the
plain version of K1. Tolerances: fp32 on both sides, so the decoded scores
are held within 1e-7 (sorted, so a near-tie that swaps two ranks costs
nothing; measured 1.3e-8 on scores of 0.005-0.023, whose median gap is
6e-7), the labels and boxes at every rank whose score stands 2e-7 apart
from its neighbours (about 60% of the ranks) equal and within 1e-4
(measured 1e-5), and the metric dicts within 1e-6. With random weights the
metrics are 0 (AP) and 1 (TP errors) on both sides: no near-tie moved one.

Checkpoints: a save and restore round trip and a restored train step are
equal bit for bit; rotation keeps the same ``step_*`` directories as
petr_tpu's orbax ``save_checkpoint``; ``load_params`` names a missing or an
unexpected key. The CLI's ``main`` on ``--device cpu`` prints petr_tpu's
metric lines, also with ``--tta``, ``--quant-scales`` and
``--fuse-conv-bn``; ``--streaming`` on ``tiny_debug_v2`` gives petr_tpu's
detections.
"""

import contextlib
import dataclasses
import json
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petr_tpu.cli import test as jax_cli
from petr_tpu.configs import get_config as jax_config
from petr_tpu.data import NuScenesDataset as JDataset
from petr_tpu.metrics import nuscenes as jax_nuscenes
from petr_tpu.models import PETRDetector as JDetector
from petr_tpu.train import checkpoint as jax_checkpoint
from petr_tpu.train import evaluate as jax_evaluate
from petr_tpu.utils.torch_convert import convert_state_dict
from petr_tpu_torch.cli import test as cli
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.data import Loader, NuScenesDataset, generate_synthetic_scenes
from petr_tpu_torch.models import PETRDetector, init_weights
from petr_tpu_torch.models.layers import FrozenBatchNorm
from petr_tpu_torch.train import create_train_state, make_train_step
from petr_tpu_torch.train import checkpoint, evaluate

SRC_HW = (64, 160)
CLASSES = ("car", "bus", "pedestrian")
SCORE_TOL, BOX_TOL, METRIC_TOL = 1e-7, 1e-4, 1e-6


def _port_model(cfg, seed):
    model = init_weights(PETRDetector(cfg.model), seed).eval()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))
    return model


def _jax_params(model, jcfg, ds, **convert_kw):
    batch = ds.get(0)
    one = [jnp.asarray(batch[k][None]) for k in ("images", "img2lidar", "img_hw")]
    ts = jnp.asarray(batch["timestamp"][None]) if jcfg.data.num_frames > 1 else None
    jmodel = JDetector(jcfg.model, deterministic=True)
    shapes = jax.eval_shape(lambda i, c, h: jmodel.init(jax.random.PRNGKey(0), i, c, h, timestamp=ts), *one)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
    params, stats = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, zeros,
                                       **convert_kw)
    assert stats["skipped"] == 0 and stats["unfilled"] == 0, stats
    return jax.tree.map(jnp.asarray, params)


@contextlib.contextmanager
def recording(module, name, into):
    """Record what ``module.name`` returns while it runs under the caller."""
    fn = getattr(module, name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, name, lambda *a, **k: into.setdefault(name, fn(*a, **k)))
        yield


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("petr_tpu.data.native.available", lambda: False)  # both sides decode through PIL
        val = generate_synthetic_scenes(str(root / "synth"), n_scenes=2, frames_per_scene=2, image_hw=SRC_HW,
                                        n_objects=6, val_scenes=2, seed=1)["val"]
        jcfg, cfg = jax_config("tiny_debug"), get_config("tiny_debug")
        jds = JDataset(val, jcfg.data, training=False, src_hw=SRC_HW)
        ds = NuScenesDataset(val, cfg.data, training=False, src_hw=SRC_HW)
        model = _port_model(cfg, seed=0)
        params = _jax_params(model, jcfg, jds)
        want, got = {}, {}
        with recording(jax_evaluate, "_decode_dataset", want):
            want["metrics"] = jax_evaluate.evaluate_model(jcfg, params, jds, batch_size=2, classes=CLASSES)
        with recording(evaluate, "_decode_dataset", got):
            got["metrics"] = evaluate.evaluate_model(cfg, model, ds, batch_size=2, classes=CLASSES)
    return types.SimpleNamespace(root=root, val=val, cfg=cfg, jcfg=jcfg, ds=ds, jds=jds, model=model,
                                 want=want, got=got)


def same_decode(want_boxes, want_scores, want_labels, got_boxes, got_scores, got_labels):
    """Sorted scores within SCORE_TOL; labels and boxes at every rank whose
    score stands 2 x SCORE_TOL apart from its neighbours'; returns their share."""
    np.testing.assert_allclose(np.sort(got_scores)[::-1], np.sort(want_scores)[::-1], rtol=0, atol=SCORE_TOL)
    order_w, order_g = np.argsort(-want_scores, kind="stable"), np.argsort(-got_scores, kind="stable")
    s = want_scores[order_w]
    apart = np.ones(len(s), bool)
    apart[1:] &= (s[:-1] - s[1:]) > 2 * SCORE_TOL
    apart[:-1] &= (s[:-1] - s[1:]) > 2 * SCORE_TOL
    np.testing.assert_array_equal(got_labels[order_g][apart], want_labels[order_w][apart])
    np.testing.assert_allclose(got_boxes[order_g][apart], want_boxes[order_w][apart], rtol=0, atol=BOX_TOL)
    return apart.mean()


def test_evaluate_model_matches(run):
    (jtok, jdet), (tok, det) = run.want["_decode_dataset"], run.got["_decode_dataset"]
    assert jtok == tok == [info["token"] for info in run.val]
    for i in range(len(tok)):
        assert det["valid"][i].all() == np.asarray(jdet["valid"][i]).all()
        share = same_decode(np.asarray(jdet["boxes"][i]), np.asarray(jdet["scores"][i]),
                            np.asarray(jdet["labels"][i]), det["boxes"][i], det["scores"][i], det["labels"][i])
        assert share > 0.5, share
    assert list(run.got["metrics"]) == list(run.want["metrics"])
    for k, v in run.want["metrics"].items():
        assert abs(run.got["metrics"][k] - v) <= METRIC_TOL, (k, run.got["metrics"][k], v)


def test_evaluate_model_multiprocess_is_not_ported(run):
    """Several processes are ported (tests/test_torch_port_parallel_cli.py);
    without a process group it is ``evaluate_model`` itself."""
    got = evaluate.evaluate_model_multiprocess(run.cfg, run.model, run.ds, 2, classes=CLASSES)
    np.testing.assert_equal(got, run.got["metrics"])


# --------------------------------------------------------------- checkpoints
def _train_batches(run, n):
    train_ds = NuScenesDataset(run.val, run.cfg.data, training=True, src_hw=SRC_HW)
    batches = list(Loader(train_ds, 2, seed=3, num_threads=1).epoch(0))
    return [{k: v for k, v in b.items() if k != "tokens"} for b in batches[:n]]


def _state_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in s.items()})
    return out


def assert_states_equal(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert a.step == b.step and list(ta) == list(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    ga, gb = a.optimizer.state_dict()["param_groups"], b.optimizer.state_dict()["param_groups"]
    assert ga == gb


def test_restored_train_step_is_bit_for_bit(run, tmp_path):
    cfg = run.cfg
    step_fn = make_train_step(cfg)
    b1, b2 = _train_batches(run, 2)
    state = create_train_state(cfg, 0, 10, device="cpu")
    gen = torch.Generator().manual_seed(0)
    step_fn(state, b1, gen)
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpts"), state.step, state, meta={"config": cfg.name})
    assert sorted(os.listdir(path)) == ["meta.json", checkpoint.STATE_FILE]
    assert checkpoint.latest_checkpoint(str(tmp_path / "ckpts")) == path
    fresh = create_train_state(cfg, 1, 10, device="cpu")
    restored = checkpoint.restore_checkpoint(path, fresh)
    assert restored is fresh
    assert_states_equal(state, restored)  # the round trip
    assert any(len(s) for s in restored.optimizer.state_dict()["state"].values())
    gen2 = torch.Generator()
    gen2.set_state(gen.get_state())
    _, m_a = step_fn(state, b2, gen)
    _, m_b = step_fn(restored, b2, gen2)
    assert m_a["skipped"] == m_b["skipped"] == 0
    for k in m_a:
        assert torch.equal(torch.as_tensor(m_a[k]), torch.as_tensor(m_b[k])), k
    assert_states_equal(state, restored)


def test_rotation_keeps_petr_tpu_directories(tmp_path):
    jbase, base = str(tmp_path / "jax"), str(tmp_path / "port")
    model = torch.nn.Linear(3, 2)
    port = types.SimpleNamespace(model=model, optimizer=torch.optim.AdamW(model.parameters()), step=0)
    for step in (1, 2, 3, 4, 6, 5, 7, 4):
        jstate = types.SimpleNamespace(params={"w": np.full(3, step, np.float32)},
                                       opt_state={"m": np.zeros(3, np.float32)}, step=np.asarray(step, np.int32))
        jax_checkpoint.save_checkpoint(jbase, step, jstate, max_keep=3, meta={"step": step})
        port.step = step
        checkpoint.save_checkpoint(base, step, port, max_keep=3, meta={"step": step})
        assert sorted(os.listdir(base)) == sorted(os.listdir(jbase)), step
    assert os.path.basename(checkpoint.latest_checkpoint(base)) == os.path.basename(
        jax_checkpoint.latest_checkpoint(jbase)) == "step_00000007"
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None


@pytest.mark.parametrize("fault", ["missing", "unexpected"])
def test_load_params_names_a_wrong_key(tmp_path, fault):
    model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
    state = types.SimpleNamespace(model=model, optimizer=torch.optim.AdamW(model.parameters()), step=0)
    path = checkpoint.save_checkpoint(str(tmp_path), 0, state)
    payload = torch.load(os.path.join(path, checkpoint.STATE_FILE), weights_only=True)
    if fault == "missing":
        del payload["model"]["1.bias"]
    else:
        payload["model"]["2.weight"] = torch.zeros(1)
    torch.save(payload, os.path.join(path, checkpoint.STATE_FILE))
    with pytest.raises(KeyError, match=r"1\.bias" if fault == "missing" else r"2\.weight"):
        checkpoint.load_params(path, torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Linear(2, 1)))


# ----------------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def val_pkl(run):
    path = run.root / "val.pkl"
    with open(path, "wb") as f:
        pickle.dump({"infos": run.val, "metadata": {"version": "synthetic"}}, f)
    return str(path)


def _args(config, pkl, *extra):
    return ["--config", config, "--infos", pkl, "--device", "cpu", "--classes", ",".join(CLASSES),
            "--set", f"data.src_hw={SRC_HW}", *extra]


def test_cli_prints_petr_tpu_metrics_from_a_checkpoint(run, val_pkl, tmp_path, capsys):
    state = create_train_state(run.cfg, 5, 10, device="cpu")
    state.model.load_state_dict(run.model.state_dict())  # the weights the parity run used
    ckpt = checkpoint.save_checkpoint(str(tmp_path / "ckpts"), 0, state)
    out = str(tmp_path / "sub.json")
    results = cli.main(_args("tiny_debug", val_pkl, "--ckpt", ckpt, "--batch-size", "2", "--out", out))
    printed = capsys.readouterr().out
    metric_lines = [line for line in printed.splitlines() if ": " in line and not line.startswith("inference")]
    want = [f"{k}: {v:.4f}" for k, v in sorted(run.want["metrics"].items())]  # petr_tpu's cli.test lines
    assert metric_lines == want, printed
    assert results == run.got["metrics"]
    with open(out) as f:
        sub = json.load(f)
    assert sorted(sub["results"]) == sorted(info["token"] for info in run.val)


def _jax_cli_metrics(run, params, tta="none", scales=None):
    """petr_tpu's ``cli.test`` evaluation loop (`petr_tpu/cli/test.py:170-196`)
    over the val split: ``apply_tta`` on the images, ``make_eval_step`` with
    the scales on the int8 config, the devkit metrics. Its attention runs
    the plain branch (``use_flash_attention=False``; the interpret-mode
    Pallas kernel would triple this test's time), equal to the flash
    semantics where no row is fully masked, as here."""
    from petr_tpu.data import Loader as JLoader
    from petr_tpu.train import make_eval_step as jax_eval_step

    model = dataclasses.replace(run.jcfg.model, use_flash_attention=False)
    if scales is not None:
        model = dataclasses.replace(model, backbone=dataclasses.replace(model.backbone, quant="int8"))
    step = jax.jit(jax_eval_step(dataclasses.replace(run.jcfg, model=model), scales))
    info = {i["token"]: i for i in run.val}
    preds = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("petr_tpu.data.native.available", lambda: False)
        for batch in JLoader(run.jds, 2, shuffle=False, drop_last=False).epoch(0):
            tokens = batch.pop("tokens")
            batch["images"] = jax_cli.apply_tta(batch["images"], tta)
            det = jax.device_get(step(params, {k: jnp.asarray(v) for k, v in batch.items()}))
            for i, tok in enumerate(tokens):
                preds[tok] = jax_nuscenes.boxes_from_arrays(tok, det["boxes"][i], det["scores"][i], det["labels"][i],
                                                            det["valid"][i], info=info.get(tok))
    return jax_nuscenes.evaluate_detections(jax_nuscenes.ground_truth_from_infos(run.val), preds, classes=CLASSES)


@pytest.mark.parametrize("extra", [["--tta", "hflip"], ["--quant-scales", "scales.npz"], ["--fuse-conv-bn"]],
                         ids=["tta", "quant_scales", "fuse_conv_bn"])
def test_cli_refuses_unported_options(run, val_pkl, tmp_path, capsys, extra):
    """Named for when these options raised; they are ported: each runs from
    the parity run's weights and prints petr_tpu's metric dict for the same
    option within METRIC_TOL. For ``--quant-scales`` the port calibrates on
    the val split and writes the file, which both CLIs' evaluations read
    (petr_tpu's through its ``load_scales``)."""
    from petr_tpu.quant import load_scales as jax_load_scales
    from petr_tpu.utils.fuse import fold_frozen_bn as jax_fold
    from petr_tpu_torch.quant import calibrate_detector, save_scales

    params = _jax_params(run.model, run.jcfg, run.jds)
    scales = None
    if extra[0] == "--quant-scales":
        extra = ["--quant-scales", str(tmp_path / "scales.npz")]
        batches = [{k: v[None] for k, v in run.ds.get(i).items() if k in ("images", "img2lidar", "img_hw")}
                   for i in range(len(run.val))]
        save_scales(extra[1], calibrate_detector(run.cfg, run.model, batches))
        scales = jax_load_scales(extra[1])
    want = _jax_cli_metrics(run, jax.tree.map(jnp.asarray, jax_fold(params)) if extra[0] == "--fuse-conv-bn"
                            else params, tta=extra[1] if extra[0] == "--tta" else "none", scales=scales)
    state = create_train_state(run.cfg, 5, 10, device="cpu")
    state.model.load_state_dict(run.model.state_dict())
    ckpt = checkpoint.save_checkpoint(str(tmp_path / "ckpts"), 0, state)
    results = cli.main(_args("tiny_debug", val_pkl, "--ckpt", ckpt, "--batch-size", "2", *extra))
    capsys.readouterr()
    assert list(results) == list(want)
    for k, v in want.items():
        assert abs(results[k] - v) <= METRIC_TOL, (k, results[k], v)


def test_cli_raises_when_the_card_is_absent(val_pkl):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--config", "tiny_debug", "--infos", val_pkl])


def test_cli_streaming_matches_petr_tpu(run, val_pkl, capsys):
    jcfg, cfg = jax_config("tiny_debug_v2"), get_config("tiny_debug_v2")
    jds = JDataset(run.val, jcfg.data, training=False, src_hw=SRC_HW)
    ds = NuScenesDataset(run.val, cfg.data, training=False, src_hw=SRC_HW)
    model = init_weights(PETRDetector(cfg.model), 0).eval()  # what cli.main builds without --ckpt
    params = _jax_params(model, jcfg, jds, shared_branches=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("petr_tpu.data.native.available", lambda: False)
        want, _, _ = jax_cli.run_streaming_inference(jcfg, params, jds)
    got, n, _ = cli.run_streaming_inference(cfg, model, ds, device="cpu")
    assert n == len(run.val) and list(got) == list(want)
    for tok in want:
        field = lambda bs, k: np.array([getattr(b, k) for b in bs])  # noqa: E731
        names = {c: i for i, c in enumerate(sorted({b.name for b in want[tok] + got[tok]}))}
        label = lambda bs: np.array([names[b.name] for b in bs])  # noqa: E731
        boxes = lambda bs: np.concatenate([field(bs, "center"), field(bs, "size"), field(bs, "yaw")[:, None],  # noqa: E731
                                           field(bs, "velocity")], 1)
        same_decode(boxes(want[tok]), field(want[tok], "score"), label(want[tok]),
                    boxes(got[tok]), field(got[tok], "score"), label(got[tok]))
    capsys.readouterr()
    results = cli.main(_args("tiny_debug_v2", val_pkl, "--streaming"))
    printed = capsys.readouterr().out
    assert "streaming: 2/4 frames served from the feature cache" in printed, printed
    jres = jax_nuscenes.evaluate_detections(jax_nuscenes.ground_truth_from_infos(run.val), want, classes=CLASSES)
    assert list(results) == list(jres)
    for k, v in jres.items():
        assert abs(results[k] - v) <= METRIC_TOL, (k, results[k], v)
