"""The port's training diagnostics and divergence forensics on the CPU:
``train/diagnostics.py::make_velocity_probe`` against petr_tpu's,
``train/forensics.py`` and ``python -m petr_tpu_torch.tools.nan_replay``.

The velocity probe: petr_tpu's weights for ``tiny_debug`` (drawn from a
seed, carried over by ``utils/convert.py``) on a rendered synthetic val
set, both packages on the plain attention in fp32 and decoding through
PIL, with a score threshold of 0 and a 60 m match radius so that every
detection counts and the statistics are not trivially empty: the same
stats within rtol 1e-4 (the decoded boxes agree to ~1e-5, see
tests/test_torch_port_eval.py). Forensics: a snapshot round-trips; a
planted NaN is counted under its top-level module; the forward hooks name
the module whose weight holds it first; the replay stops at the planted
bad step.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petr_tpu.configs import get_config as jax_config
from petr_tpu.data import NuScenesDataset as JDataset
from petr_tpu.models import PETRDetector as JDetector
from petr_tpu.train.diagnostics import make_velocity_probe as jax_make_velocity_probe
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.data import Loader, NuScenesDataset, generate_synthetic_scenes
from petr_tpu_torch.models import PETRDetector, init_weights
from petr_tpu_torch.tools import nan_replay
from petr_tpu_torch.train import create_train_state, make_train_step, step_generator
from petr_tpu_torch.train.diagnostics import make_velocity_probe
from petr_tpu_torch.train.forensics import (
    first_nonfinite_intermediates,
    host_copy,
    load_snapshot,
    nonfinite_by_subtree,
    save_snapshot,
)
from petr_tpu_torch.utils import state_dict_from_jax
from tests.test_torch_port_depthr import init_params

HW = (32, 80)
PLAIN = ("data.src_hw=(32,80)", "model.use_flash_attention=False")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs, as it was after: its
    CPU train steps, in a run of several test processes at once, otherwise
    contend for every core with the others."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """3 scenes of 2 frames at 32x80, 1 held out (2 val samples with moving objects)."""
    root = tmp_path_factory.mktemp("synth")
    splits = generate_synthetic_scenes(str(root), n_scenes=3, frames_per_scene=2, image_hw=HW, n_objects=6,
                                       val_scenes=1, seed=4)
    return root, splits


def test_velocity_probe_matches_petr_tpu(synth, monkeypatch):
    monkeypatch.setattr("petr_tpu.data.native.available", lambda: False)  # both decode through PIL
    _, splits = synth
    jcfg, cfg = jax_config("tiny_debug", PLAIN), get_config("tiny_debug", PLAIN)
    jds = JDataset(splits["val"], jcfg.data, training=False)
    ds = NuScenesDataset(splits["val"], cfg.data, training=False)
    sample = jds.get(0)
    params = init_params(JDetector(jcfg.model, deterministic=True), 6,
                         *[jnp.asarray(sample[k][None]) for k in ("images", "img2lidar", "img_hw")])
    model = PETRDetector(cfg.model)
    model.load_state_dict(state_dict_from_jax(params, model))
    kw = dict(batch_size=2, score_thr=0.0, dist_thr=60.0)
    want = jax_make_velocity_probe(jcfg, jds, **kw)(jax.tree.map(jnp.asarray, params))
    got = make_velocity_probe(cfg, ds, **kw)(model.eval())
    assert set(got) == set(want) == {"tp", "vel_err", "zero_err", "pred_std", "gt_std", "corr_vx", "corr_vy"}
    assert got["tp"] == want["tp"] >= 3
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_velocity_probe_with_no_matches_counts_them():
    cfg = get_config("tiny_debug", PLAIN)
    probe = make_velocity_probe(cfg, NuScenesDataset([], cfg.data, training=False))
    assert probe(init_weights(PETRDetector(cfg.model), 0).eval()) == {"tp": 0.0}


# ----------------------------------------------------------------- forensics
def small_state():
    cfg = get_config("tiny_debug", PLAIN)
    return cfg, create_train_state(cfg, 0, 10, "cpu")


def test_snapshot_round_trips(tmp_path):
    cfg, state = small_state()
    snap = host_copy(state)
    with torch.no_grad():  # later changes to the state leave the copy alone
        next(state.model.parameters()).add_(1.0)
    path = save_snapshot(str(tmp_path), snap, 7, cfg, loader_args={"batch_size": 2, "seed": 3})
    assert os.path.basename(path) == "healthy_step_00000007.pkl"
    back = load_snapshot(path)
    assert back["step"] == 7 and back["cfg"] == cfg and back["loader_args"] == {"batch_size": 2, "seed": 3}
    assert set(back["model"]) == set(state.model.state_dict())
    for k, v in back["model"].items():
        assert v.device.type == "cpu" and torch.equal(v, snap["model"][k])
    fresh = create_train_state(cfg, 1, 10, "cpu")
    fresh.model.load_state_dict(back["model"])
    fresh.optimizer.load_state_dict(back["optimizer"])
    assert not torch.equal(next(fresh.model.parameters()), next(state.model.parameters()))


def test_nonfinite_by_subtree_counts_a_planted_nan():
    _, state = small_state()
    named = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert nonfinite_by_subtree(named) == {}
    named["img_neck.fpn_convs.0.conv.weight"].view(-1)[:3] = float("nan")
    named["pts_bbox_head.query_embedding.0.bias"].view(-1)[0] = float("inf")
    assert nonfinite_by_subtree(named) == {"img_neck": 3, "pts_bbox_head": 1}


def test_first_nonfinite_intermediate_names_the_planted_module():
    cfg, state = small_state()
    name = "img_backbone.stage3.OSA3_1.layers.2.OSA3_1_2/conv"
    with torch.no_grad():
        dict(state.model.named_modules())[name].weight.view(-1)[5] = float("nan")
    N, (H, W) = cfg.data.num_views, cfg.data.image_size
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(1, N, H, W, 3).astype(np.float32))
    cams = torch.eye(4).repeat(1, N, 1, 1)
    hw = torch.tensor([[H, W]], dtype=torch.float32).repeat(1, N, 1)
    model = state.model.eval()
    outputs, bad = first_nonfinite_intermediates(model, images, cams, hw)
    assert bad[0][0] == name and bad[0][1] > 0
    assert {"cls_logits", "bbox_codes"} <= set(outputs)  # the model's outputs (the head nan_to_num's them)
    assert not model._forward_hooks and all(not m._forward_hooks for m in model.modules())
    # a finite forward reports nothing
    _, clean = first_nonfinite_intermediates(small_state()[1].model.eval(), images, cams, hw)
    assert clean == []


def test_nan_replay_finds_a_planted_bad_step(tmp_path, monkeypatch, capsys):
    """A run's healthy snapshot at step 1, then one train sample's images
    turned to NaN: the replay names the first step whose batch holds it."""
    cfg = get_config("tiny_debug", PLAIN + ("data.image_size=(32,80)", "data.final_dim=(32,80)",
                                            "data.resize_lim=(1.0,1.0)"))
    generate_synthetic_scenes(str(tmp_path), n_scenes=4, frames_per_scene=2, image_hw=HW, val_scenes=1, seed=5)
    ds = NuScenesDataset.from_pkl(str(tmp_path / "synth_infos_train.pkl"), cfg.data, training=True)
    loader = Loader(ds, 1, seed=3)
    state = create_train_state(cfg, 3, 20, "cpu")
    step = make_train_step(cfg)
    batches = iter(loader.epoch(0))
    batch = next(batches)
    batch.pop("tokens")
    step(state, batch, step_generator(4, 0))
    path = save_snapshot(str(tmp_path / "forensics"), host_copy(state), 1, cfg,
                         loader_args=dict(batch_size=1, seed=3, steps=20))
    order = np.arange(len(ds))
    np.random.default_rng(3).shuffle(order)  # the loader's order of epoch 0
    planted, bad_step = int(order[3]), 4
    get = NuScenesDataset.get

    def poisoned(self, idx, seed=0):
        out = get(self, idx, seed)
        if idx == planted:
            out["images"][0, 0, 0, 0] = np.nan
        return out

    monkeypatch.setattr(NuScenesDataset, "get", poisoned)
    assert nan_replay.main(["--snapshot", path, "--out-dir", str(tmp_path), "--max-steps", "10",
                            "--device", "cpu"]) == bad_step
    out = capsys.readouterr().out
    assert f"FIRST BAD STEP: {bad_step}" in out and "nonfinite grads by subtree:" in out
    assert "nonfinite FORWARD activations" in out
    assert "img_backbone.stem.stem_1/conv" in out.split("nonfinite FORWARD activations")[1].splitlines()[1]
    assert os.path.exists(tmp_path / "forensics" / "bad_step.pkl")
