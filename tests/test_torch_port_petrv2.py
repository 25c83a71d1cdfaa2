"""The port's PETRv2 modules, head, converter and serving against petr_tpu
at tiny_debug_v2 size, on the CPU.

One set of weights serves both packages: a seeded port model with random
frozen-BN statistics goes to a petr_tpu param tree through petr_tpu's own
checkpoint converter (``shared_branches=False``), and back into the port
through ``state_dict_from_jax``. ``tiny_debug_v2`` runs the plain
regression branch; ``dataclasses.replace`` gives the same preset with
``with_multi_reg=True`` (the flagship's RegLayer). petr_tpu runs its Pallas
flash attention in interpret mode, the port the plain version. Inputs are
seeded numpy arrays fed to both.

Tolerances: fp32 forwards within atol 1e-4 (as the v1 port tests,
`tests/test_torch_port_models.py`); bf16 as the v1 head's bf16 case (atol
3e-2, rtol 1e-2); the decoded boxes as the v1 serving test.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petr_tpu.configs import get_config as jax_config
from petr_tpu.models import PETRDetector as JDetector
from petr_tpu.models.layers import SELayer as JSELayer
from petr_tpu.models.petrv2_head import PETRv2Head as JPETRv2Head
from petr_tpu.models.petrv2_head import RegLayer as JRegLayer
from petr_tpu.serve.export import make_serving_fn as jax_serving_fn
from petr_tpu.utils.torch_convert import convert_state_dict
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.models import PETRDetector, PETRHead, PETRv2Head, RegLayer, init_weights
from petr_tpu_torch.models.layers import FrozenBatchNorm, SELayer
from petr_tpu_torch.models.petr_head import FOCAL_PRIOR_BIAS
from petr_tpu_torch.models.petrv2_head import mean_frame_dt
from petr_tpu_torch.serve import InferenceServer, make_serving_fn, serving_input_spec
from petr_tpu_torch.utils import state_dict_from_jax
from tests.test_heads import make_cams

KEYS = ("images", "img2lidar", "img_hw", "timestamp")
VARIANTS = {"plain_reg": False, "multi_reg": True}


def _with_multi_reg(cfg, on):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, head=dataclasses.replace(cfg.model.head, with_multi_reg=on)))


def _timestamps(rng, B, dt=0.5):
    """(B, 12): the current 6 views near 0, the previous 6 near ``dt``."""
    cur = rng.uniform(-0.02, 0.02, (B, 6))
    return np.concatenate([cur, cur + dt + rng.uniform(-0.01, 0.01, (B, 6))], 1).astype(np.float32)


def _to_jax(model, jcfg, batch):
    """The port model's weights as a petr_tpu param tree, every key used."""
    port_sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    jmodel = JDetector(jcfg.model, deterministic=True)
    one = [jnp.asarray(batch[k][:1]) for k in KEYS[:3]]
    shapes = jax.eval_shape(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a, timestamp=jnp.asarray(
        batch["timestamp"][:1])), *one)["params"]
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats = convert_state_dict(port_sd, zeros, shared_branches=jcfg.model.head.shared_branches)
    assert stats["skipped"] == 0 and stats["unfilled"] == 0, stats
    return port_sd, jmodel, params


@pytest.fixture(scope="module")
def v2():
    base_j, base = jax_config("tiny_debug_v2"), get_config("tiny_debug_v2")
    assert not base.model.head.with_multi_reg and not base.model.head.shared_branches
    N = base.data.num_views * base.data.num_frames
    H, W = base.data.image_size
    rng = np.random.RandomState(0)
    batch = {
        "images": rng.randn(3, N, H, W, 3).astype(np.float32),
        "img2lidar": make_cams(3, N, seed=1),
        "img_hw": np.tile(np.array([H, W], np.float32), (3, N, 1)),
        "timestamp": _timestamps(rng, 3),
    }
    batch["img_hw"][0, 1] = [24, 64]  # padded views: masked decoder keys
    batch["img_hw"][1, 8] = [16, 48]
    nets = {}
    for name, on in VARIANTS.items():
        cfg, jcfg = _with_multi_reg(base, on), _with_multi_reg(base_j, on)
        model = init_weights(PETRDetector(cfg.model), seed=0).eval()
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, FrozenBatchNorm):
                    c = m.weight.shape[0]
                    m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, c)))
                    m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))
        port_sd, jmodel, params = _to_jax(model, jcfg, batch)
        model.load_state_dict(state_dict_from_jax(params, model))
        nets[name] = types.SimpleNamespace(cfg=cfg, jcfg=jcfg, model=model, port_sd=port_sd, jmodel=jmodel,
                                           params=params)
    return types.SimpleNamespace(batch=batch, **nets)


def _jhead(cfg, in_channels, dtype="float32"):
    hc = cfg.model.head
    return JPETRv2Head(
        num_classes=hc.num_classes, in_channels=in_channels, embed_dim=hc.embed_dim,
        num_query=hc.num_query, num_layers=hc.num_layers, num_heads=hc.num_heads, ffn_dim=hc.ffn_dim,
        depth_num=hc.depth_num, position_range=hc.position_range, pc_range=hc.pc_range,
        with_fpe=hc.with_fpe, with_time=hc.with_time, with_multi_reg=hc.with_multi_reg,
        shared_branches=hc.shared_branches, remat=False, use_flash=True, dtype=jnp.dtype(dtype),
    )


def _head_inputs(cfg, seed, B=1):
    rng = np.random.RandomState(seed)
    N = cfg.data.num_views * cfg.data.num_frames
    pad_hw = (64, 160)
    img_hw = np.tile(np.array(pad_hw, np.float32), (B, N, 1))
    img_hw[0, 2] = [40, 100]
    return (rng.randn(B, N, 4, 10, cfg.model.backbone.fpn_out_channels).astype(np.float32),
            make_cams(B, N, seed=seed + 1), img_hw, pad_hw, _timestamps(rng, B))


# ------------------------------------------------------------------ modules
def test_se_layer_matches(v2):
    C = v2.multi_reg.cfg.model.head.embed_dim
    rng = np.random.RandomState(2)
    x, gate = rng.randn(2, 12, 3, 5, C).astype(np.float32), rng.randn(2, 12, 3, 5, C).astype(np.float32)
    want = JSELayer(C).apply({"params": v2.multi_reg.params["head"]["fpe"]}, jnp.asarray(x), jnp.asarray(gate))
    se = v2.multi_reg.model.pts_bbox_head.fpe
    assert isinstance(se, SELayer)
    with torch.no_grad():
        got = se(torch.from_numpy(x), torch.from_numpy(gate))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("layer", [0, 1])
def test_reg_layer_matches(v2, layer):
    hc = v2.multi_reg.cfg.model.head
    x = np.random.RandomState(3 + layer).randn(2, hc.num_query, hc.embed_dim).astype(np.float32)
    want = JRegLayer(hc.embed_dim, 2).apply({"params": v2.multi_reg.params["head"][f"reg_branch_{layer}"]},
                                            jnp.asarray(x))
    reg = v2.multi_reg.model.pts_bbox_head.reg_branches[layer]
    assert isinstance(reg, RegLayer)
    with torch.no_grad():
        got = reg(torch.from_numpy(x))
    assert got.shape[-1] == hc.code_size == sum(v2.multi_reg.model.pts_bbox_head.reg_branches[0].task_heads[g][-1]
                                                .out_features for g in range(5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# --------------------------------------------------------------------- head
@pytest.mark.parametrize("variant,dtype", [("plain_reg", "float32"), ("multi_reg", "float32"),
                                           ("multi_reg", "bfloat16")])
def test_petrv2_head_matches_at_every_layer(v2, variant, dtype):
    net = getattr(v2, variant)
    hc = net.cfg.model.head
    feats, img2lidar, img_hw, pad_hw, ts = _head_inputs(net.cfg, seed=5)
    want = jax.jit(_jhead(net.jcfg, feats.shape[-1], dtype).apply, static_argnums=4)(
        {"params": net.params["head"]}, jnp.asarray(feats), jnp.asarray(img2lidar), jnp.asarray(img_hw), pad_hw,
        timestamp=jnp.asarray(ts))
    model = net.model
    if dtype == "bfloat16":
        model = PETRDetector(dataclasses.replace(net.cfg.model, compute_dtype=dtype)).eval()
        model.load_state_dict(net.model.state_dict())
    head = model.pts_bbox_head
    assert isinstance(head, PETRv2Head) and not head.shared_branches
    with torch.no_grad():
        got = head(torch.from_numpy(feats), torch.from_numpy(img2lidar), torch.from_numpy(img_hw), pad_hw,
                   timestamp=torch.from_numpy(ts))
    atol, rtol = (1e-4, 0) if dtype == "float32" else (3e-2, 1e-2)
    for k in ("cls_logits", "bbox_codes"):
        assert got[k].shape == want[k].shape == (hc.num_layers, 1, hc.num_query, got[k].shape[-1])
        for layer in range(hc.num_layers):
            np.testing.assert_allclose(got[k][layer].numpy(), np.asarray(want[k][layer]), atol=atol, rtol=rtol,
                                       err_msg=f"{k}, layer {layer}")


@pytest.mark.parametrize("dt", [0.0, -1e-4, 0.5, -0.3])
def test_with_time_clamp_matches(v2, dt):
    """dt = 0 and |dt| < 1e-3 clamp to +-1e-3 with the sign kept; the
    velocity codes follow petr_tpu's at each."""
    net = v2.multi_reg
    feats, img2lidar, img_hw, pad_hw, _ = _head_inputs(net.cfg, seed=7)
    ts = np.concatenate([np.full((1, 6), 0.25), np.full((1, 6), 0.25 + dt)], 1).astype(np.float32)
    got_dt = mean_frame_dt(torch.from_numpy(ts)).item()
    want_dt = dt if abs(dt) >= 1e-3 else (-1e-3 if dt < 0 else 1e-3)
    np.testing.assert_allclose(got_dt, want_dt, rtol=1e-6)
    want = jax.jit(_jhead(net.jcfg, feats.shape[-1]).apply, static_argnums=4)(
        {"params": net.params["head"]}, jnp.asarray(feats), jnp.asarray(img2lidar), jnp.asarray(img_hw), pad_hw,
        timestamp=jnp.asarray(ts))
    with torch.no_grad():
        got = net.model.pts_bbox_head(torch.from_numpy(feats), torch.from_numpy(img2lidar),
                                      torch.from_numpy(img_hw), pad_hw, timestamp=torch.from_numpy(ts))
    vel, want_vel = got["bbox_codes"][..., 8:].numpy(), np.asarray(want["bbox_codes"])[..., 8:]
    # velocities are raw codes / dt: up to 1e3x the codes at the clamp
    np.testing.assert_allclose(vel, want_vel, atol=1e-4 / abs(want_dt), rtol=1e-5)
    np.testing.assert_allclose(got["bbox_codes"][..., :8].numpy(), np.asarray(want["bbox_codes"])[..., :8],
                               atol=1e-4)


def test_with_time_needs_timestamps(v2):
    feats, img2lidar, img_hw, pad_hw, _ = _head_inputs(v2.plain_reg.cfg, seed=8)
    with pytest.raises(ValueError, match="timestamps"):
        v2.plain_reg.model.pts_bbox_head(torch.from_numpy(feats), torch.from_numpy(img2lidar),
                                         torch.from_numpy(img_hw), pad_hw)


# ---------------------------------------------------------------- converter
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_converter_fills_every_key_and_round_trips(v2, variant):
    net = getattr(v2, variant)
    sd = state_dict_from_jax(net.params, net.model)  # raises on a missing, extra or misshapen key
    assert set(sd) == set(net.port_sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), net.port_sd[k], err_msg=k)
    back, stats = convert_state_dict({k: v.numpy() for k, v in sd.items()}, net.params, shared_branches=False)
    assert stats["skipped"] == 0 and stats["unfilled"] == 0, stats
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(net.params):
        np.testing.assert_array_equal(np.asarray(flat_back[path]), np.asarray(leaf), err_msg=str(path))
    head = net.params["head"]
    L = net.cfg.model.head.num_layers
    assert {f"cls_branch_{i}" for i in range(L)} | {f"reg_branch_{i}" for i in range(L)} | {"fpe"} <= set(head)
    assert not {"cls_branch", "reg_branch"} & set(head)


def test_converter_maps_unshared_petr_branches():
    """PETRHead with shared_branches=False (a v1 head with per-layer branches)."""
    jcfg = jax_config("tiny_debug", ["model.head.shared_branches=False"])
    cfg = get_config("tiny_debug", ["model.head.shared_branches=False"])
    model = init_weights(PETRDetector(cfg.model), seed=1).eval()
    assert isinstance(model.pts_bbox_head, PETRHead) and not isinstance(model.pts_bbox_head, PETRv2Head)
    N, (H, W) = cfg.data.num_views, cfg.data.image_size
    rng = np.random.RandomState(9)
    batch = {"images": rng.randn(1, N, H, W, 3).astype(np.float32), "img2lidar": make_cams(1, N, seed=2),
             "img_hw": np.tile(np.array([H, W], np.float32), (1, N, 1))}
    port_sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    jmodel = JDetector(jcfg.model, deterministic=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *[jnp.asarray(batch[k]) for k in KEYS[:3]])
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
    params, stats = convert_state_dict(port_sd, zeros, shared_branches=False)
    assert stats["skipped"] == 0 and stats["unfilled"] == 0, stats
    sd = state_dict_from_jax(params, model)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), port_sd[k], err_msg=k)
    want = jax.jit(jmodel.apply)({"params": params}, *[jnp.asarray(batch[k]) for k in KEYS[:3]])
    with torch.no_grad():
        got = model(*[torch.from_numpy(batch[k]) for k in KEYS[:3]])
    for k in ("cls_logits", "bbox_codes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-3, rtol=1e-3)


# ----------------------------------------------------------------- detector
def test_presets_build_with_their_own_branches():
    for name in ("petrv2_vov_p4_800x320", "tiny_debug_v2", "synth_small_v2"):
        cfg = get_config(name)
        model = init_weights(PETRDetector(cfg.model), seed=0)
        head = model.pts_bbox_head
        hc = cfg.model.head
        assert isinstance(head, PETRv2Head) and (head.fpe is not None) == hc.with_fpe, name
        assert len({id(b) for b in head.cls_branches}) == len({id(b) for b in head.reg_branches}) == hc.num_layers
        assert all(isinstance(b, RegLayer) == hc.with_multi_reg for b in head.reg_branches), name
        for b in head.cls_branches:  # the focal prior on every layer's last cls bias
            assert torch.all(b[-1].bias == FOCAL_PRIOR_BIAS), name
        # each layer's branches drawn on their own
        assert not torch.equal(head.cls_branches[0][0].weight, head.cls_branches[1][0].weight), name


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tiny_debug_v2_detector_matches(v2, variant):
    net = getattr(v2, variant)
    want = jax.jit(lambda p, i, c, h, t: net.jmodel.apply({"params": p}, i, c, h, timestamp=t))(
        net.params, *[jnp.asarray(v2.batch[k]) for k in KEYS])
    with torch.no_grad():
        got = net.model(*[torch.from_numpy(v2.batch[k]) for k in KEYS[:3]],
                        timestamp=torch.from_numpy(v2.batch["timestamp"]))
    for k in ("cls_logits", "bbox_codes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-3, atol=2e-3)


def test_extract_feats_then_forward_head_is_the_forward(v2):
    model, b = v2.multi_reg.model, v2.batch
    args = [torch.from_numpy(b[k]) for k in KEYS]
    with torch.no_grad():
        whole = model(*args[:3], timestamp=args[3])
        feats = model.extract_feats(args[0])
        parts = model.forward_head(feats, args[1], args[2], tuple(b["images"].shape[2:4]), timestamp=args[3])
    for k in whole:
        assert torch.equal(whole[k], parts[k]), k


# ------------------------------------------------------------------ serving
def _gap_ranks(scores, gap=1e-7):
    keep = np.ones_like(scores, bool)
    keep[1:] &= (scores[:-1] - scores[1:]) > gap
    keep[:-1] &= (scores[:-1] - scores[1:]) > gap
    return keep


def test_serving_with_timestamps_matches_jax(v2):
    net = v2.multi_reg
    spec = serving_input_spec(net.cfg, batch_size=2)
    assert tuple(spec) == KEYS and spec["timestamp"][0] == (2, 12)
    want = jax.jit(jax_serving_fn(net.jcfg))(net.params, *[jnp.asarray(v2.batch[k]) for k in KEYS])
    want = {k: np.asarray(v) for k, v in want.items()}
    fn = make_serving_fn(net.cfg, net.model, device="cpu")
    with pytest.raises(TypeError, match="timestamp"):
        fn(*[v2.batch[k] for k in KEYS[:3]])
    calls = []

    def counted(*args):
        calls.append(tuple(a.shape[0] for a in args))
        return fn(*args)

    requests = [{k: v2.batch[k][i] for k in KEYS} for i in range(3)]
    with InferenceServer(counted, batch_size=2, input_keys=tuple(spec), max_delay_ms=200.0) as server:
        results = [f.result(timeout=120) for f in [server.submit(r) for r in requests]]
    assert calls == [(2,) * 4, (2,) * 4], "3 requests at batch 2: one full batch, one padded, timestamps too"
    for i, res in enumerate(results):
        np.testing.assert_allclose(res["scores"], want["scores"][i], atol=1e-6)
        keep = _gap_ranks(want["scores"][i])
        assert keep.sum() > 100
        np.testing.assert_array_equal(res["labels"][keep], want["labels"][i][keep])
        np.testing.assert_allclose(res["boxes"][keep], want["boxes"][i][keep], atol=2e-3, rtol=1e-3)
