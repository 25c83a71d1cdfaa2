"""Importing a reference (mmdet3d) checkpoint: the port's ``utils.torch_convert``
and ``cli.convert`` against petr_tpu's ``convert_state_dict``, at tiny_debug size.

A reference-shaped state dict is made from a seed: a port model's random
weights (random frozen-BN statistics too), whose names are the reference's,
as current keys, as legacy keys (``.self_attn.``, ``.multihead_attn.``,
``.decoder.norm.``), and as mmcv saves it, with BatchNorm's
``num_batches_tracked`` beside. It goes into petr_tpu by
``convert_state_dict`` and into the port by ``load_reference_weights``;
both report the same counts, and both models give the same outputs under
the detector tolerances of `tests/test_torch_port_models.py`.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petr_tpu.configs import get_config as jax_config
from petr_tpu.models import PETRDetector as JDetector
from petr_tpu.utils.torch_convert import convert_state_dict as jax_convert
from petr_tpu_torch.cli import convert as convert_cli
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.models import PETRDetector, init_weights
from petr_tpu_torch.models.layers import FrozenBatchNorm
from petr_tpu_torch.train import create_train_state
from petr_tpu_torch.train.checkpoint import load_params, restore_checkpoint
from petr_tpu_torch.utils.torch_convert import LEGACY_MAP, convert_state_dict, load_reference_weights
from tests.test_heads import make_cams

KEYS = ("images", "img2lidar", "img_hw")
UNSHARED = ["model.head.shared_branches=False"]


def _reference_model(overrides=(), seed=7):
    model = init_weights(PETRDetector(get_config("tiny_debug", list(overrides)).model), seed=seed).eval()
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))
                m.weight.copy_(torch.from_numpy(rng.normal(1.0, 0.2, c)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, c)))
    return model


def _legacy(sd):
    back = {new: old for old, new in LEGACY_MAP.items()}
    out = {}
    for k, v in sd.items():
        for new, old in back.items():
            k = k.replace(new, old)
        out[k] = v
    return out


def _with_bn_counts(sd):
    out = dict(sd)
    for k in [k for k in sd if k.endswith("running_var")]:
        out[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(100)
    return out


@functools.lru_cache(maxsize=None)
def _jax_params_zeros(overrides=()):
    """petr_tpu's config, model and zero params; its attention on the plain
    branch (the same params as flash, and quicker on the CPU than
    interpret-mode Pallas)."""
    cfg = jax_config("tiny_debug", [*overrides, "model.use_flash_attention=False"])
    model = JDetector(cfg.model, deterministic=True)
    N, (H, W) = cfg.data.num_views, cfg.data.image_size
    one = [jnp.zeros((1, N, H, W, 3)), jnp.asarray(make_cams(1, N, seed=0)), jnp.full((1, N, 2), float(H))]
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *one)["params"]
    return cfg, model, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@functools.lru_cache(maxsize=None)
def _reference_sd(overrides=()):
    return {k: v.clone() for k, v in _reference_model(overrides).state_dict().items()}


@pytest.fixture(scope="module")
def ref():
    source = _reference_model()
    return source, _reference_sd()


def _port_target(overrides=()):
    return PETRDetector(get_config("tiny_debug", list(overrides)).model).eval()


@pytest.mark.parametrize("keys", ["current", "legacy", "mmcv"])
@pytest.mark.parametrize("overrides", [(), tuple(UNSHARED)], ids=["shared", "unshared"])
def test_counts_match_petr_tpu(keys, overrides):
    sd = _reference_sd(tuple(overrides))
    if keys == "legacy":
        sd = _legacy(sd)
        assert any(".self_attn." in k for k in sd) and any(".decoder.norm." in k for k in sd)
    elif keys == "mmcv":
        sd = _with_bn_counts(_legacy(sd))
    jcfg, _, zeros = _jax_params_zeros(tuple(overrides))
    _, want = jax_convert({k: v.float().numpy() for k, v in sd.items()}, zeros,
                          shared_branches=jcfg.model.head.shared_branches)
    model = _port_target(overrides)
    got = load_reference_weights(model, sd, shared_branches=model.pts_bbox_head.shared_branches)
    assert got == want, (got, want)
    assert got["unfilled"] == 0 and got["skipped"] == (0 if keys != "mmcv" else
                                                        sum(k.endswith("num_batches_tracked") for k in sd))
    for k, v in _reference_sd(tuple(overrides)).items():
        assert torch.equal(model.state_dict()[k], v), k


def test_outputs_match_petr_tpu(ref):
    """The same legacy-keyed file into both packages: the same detector."""
    source, sd = ref
    sd = _legacy(sd)
    jcfg, jmodel, zeros = _jax_params_zeros()
    params, stats = jax_convert({k: v.numpy() for k, v in sd.items()}, zeros)
    assert stats["skipped"] == 0 and stats["unfilled"] == 0
    model = _port_target()
    assert load_reference_weights(model, sd) == stats
    cfg = get_config("tiny_debug")
    N, (H, W) = cfg.data.num_views, cfg.data.image_size
    rng = np.random.RandomState(1)
    batch = {"images": rng.randn(2, N, H, W, 3).astype(np.float32), "img2lidar": make_cams(2, N, seed=2),
             "img_hw": np.tile(np.array([H, W], np.float32), (2, N, 1))}
    batch["img_hw"][1, 3] = [24, 64]
    want = jax.jit(jmodel.apply)({"params": params}, *[jnp.asarray(batch[k]) for k in KEYS])
    with torch.no_grad():
        got = model(*[torch.from_numpy(batch[k]) for k in KEYS])
        same = source(*[torch.from_numpy(batch[k]) for k in KEYS])
    for k in ("cls_logits", "bbox_codes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-3, atol=2e-3)
        assert torch.equal(got[k], same[k]), k  # the import changed no bit


def test_partial_and_mismatched_files():
    """A backbone-only file leaves the rest unfilled (counted as petr_tpu
    counts), and a wrong shape is skipped, not loaded."""
    sd = _reference_sd()
    backbone = {k: v for k, v in sd.items() if k.startswith("img_backbone.")}
    bad = dict(sd)
    bad["pts_bbox_head.input_proj.weight"] = torch.zeros(3, 3, 1, 1)
    _, _, zeros = _jax_params_zeros()
    for part in (backbone, bad):
        _, want = jax_convert({k: v.numpy() for k, v in part.items()}, zeros)
        filled, got = convert_state_dict(part, _port_target().state_dict())
        assert got == want and got["unfilled"] > 0, (got, want)
        assert "pts_bbox_head.input_proj.weight" not in filled
    with pytest.raises(ValueError, match="not covered"):
        load_reference_weights(_port_target(), backbone)
    model = _port_target()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    load_reference_weights(model, backbone, allow_partial=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k] if k.startswith("img_backbone.") else init[k]), k


def test_convert_cli_writes_a_checkpoint_that_loads(tmp_path, capsys, ref):
    source, sd = ref
    pth = tmp_path / "petr_tiny.pth"
    torch.save({"meta": {"epoch": 24, "mmdet3d_version": "0.17.1", "CLASSES": ["car"]},
                "state_dict": _with_bn_counts(_legacy(sd))}, pth)
    out = tmp_path / "imported"
    stats = convert_cli.main(["--config", "tiny_debug", "--torch-ckpt", str(pth), "--out", str(out), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"matched {stats['matched']} / skipped {stats['skipped']} reference keys; 0 target leaves "
                     "unfilled", f"wrote {out}"]
    assert sorted(os.listdir(out)) == ["meta.json", "state.pt"]
    model = load_params(str(out), _port_target())  # what cli.test --ckpt and cli.train --load-from read
    for k, v in source.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    with pytest.raises(KeyError, match="weights only"):
        restore_checkpoint(str(out), create_train_state(get_config("tiny_debug"), 0, 10, device="cpu"))

    backbone = tmp_path / "backbone.pth"
    torch.save({"state_dict": {k: v for k, v in sd.items() if k.startswith("img_backbone.")}}, backbone)
    argv = ["--config", "tiny_debug", "--torch-ckpt", str(backbone), "--out", str(tmp_path / "b"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="--allow-partial"):
        convert_cli.main(argv)
    partial = convert_cli.main(argv + ["--allow-partial", "--verbose"])
    assert partial["unfilled"] > 0 and os.path.exists(tmp_path / "b" / "state.pt")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converted_model_serves_like_the_source(ref, dtype):
    """The converted weights in a bf16 model (the flagship's compute dtype)
    give the source model's outputs bit for bit."""
    source, sd = ref
    mc = dataclasses.replace(get_config("tiny_debug").model, compute_dtype=dtype)
    a = init_weights(PETRDetector(mc), seed=0).eval()
    load_reference_weights(a, _legacy(sd))
    b = PETRDetector(mc).eval()
    b.load_state_dict(source.state_dict())
    cfg = get_config("tiny_debug")
    N, (H, W) = cfg.data.num_views, cfg.data.image_size
    x = [torch.from_numpy(np.random.RandomState(4).randn(1, N, H, W, 3).astype(np.float32)),
         torch.from_numpy(make_cams(1, N, seed=5)), torch.full((1, N, 2), 0.0) + torch.tensor([H, W])]
    with torch.no_grad():
        for k in ("cls_logits", "bbox_codes"):
            assert torch.equal(a(*x)[k], b(*x)[k]), k
