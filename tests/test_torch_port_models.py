"""petr_tpu_torch models and serving against petr_tpu at tiny_debug size.

One set of weights serves both packages: a seeded port model (with random
frozen-BN statistics, so that the folding is exercised) goes to a petr_tpu
param tree through petr_tpu's own checkpoint converter, and back into the
port through ``state_dict_from_jax``. The JAX side runs its flash attention
in interpret mode on the CPU. Inputs are seeded numpy arrays fed to both.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petr_tpu.configs import get_config as jax_config
from petr_tpu.models import CPFPN as JCPFPN
from petr_tpu.models import PETRDetector as JDetector
from petr_tpu.models import PETRHead as JHead
from petr_tpu.models import VoVNet as JVoVNet
from petr_tpu.models.grid_mask import grid_mask as jax_grid_mask
from petr_tpu.models.layers import MultiheadAttention as JMHA
from petr_tpu.train.train_step import make_eval_step
from petr_tpu.utils.torch_convert import convert_state_dict
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.models import PETRDetector, TrainNoise, draw_train_noise, init_weights
from petr_tpu_torch.models.grid_mask import FloatGridParams
from petr_tpu_torch.models.layers import FrozenBatchNorm
from petr_tpu_torch.serve import InferenceServer, build_detector, make_serving_fn
from petr_tpu_torch.train import create_train_state, make_train_step
from petr_tpu_torch.utils import state_dict_from_jax
from tests.test_heads import make_cams
from tests.test_torch_port_misc_models import jax_float_draws

KEYS = ("images", "img2lidar", "img_hw")


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = jax_config("tiny_debug"), get_config("tiny_debug")
    N, (H, W) = cfg.data.num_views, cfg.data.image_size
    rng = np.random.RandomState(0)
    batch = {
        "images": rng.randn(3, N, H, W, 3).astype(np.float32),
        "img2lidar": make_cams(3, N, seed=1),
        "img_hw": np.tile(np.array([H, W], np.float32), (3, N, 1)),
    }
    batch["img_hw"][0, 1] = [24, 64]  # one column of feature tokens padded
    batch["img_hw"][1, 4] = [16, 48]  # a row and two columns padded

    model = init_weights(PETRDetector(cfg.model), seed=0).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))
                m.weight.copy_(torch.from_numpy(rng.normal(1.0, 0.2, c)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, c)))
    port_sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}

    jmodel = JDetector(jcfg.model, deterministic=True)
    one = [jnp.asarray(batch[k][:1]) for k in KEYS]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *one)["params"]
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats = convert_state_dict(port_sd, zeros)
    assert stats["skipped"] == 0 and stats["unfilled"] == 0, stats
    model.load_state_dict(state_dict_from_jax(params, model))
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=cfg, batch=batch, model=model, port_sd=port_sd,
        jmodel=jmodel, params=params,
    )


@pytest.fixture(scope="module")
def bf16_model(tiny):
    model = PETRDetector(dataclasses.replace(tiny.cfg.model, compute_dtype="bfloat16")).eval()
    model.load_state_dict(tiny.model.state_dict())
    return model


# ------------------------------------------------------------------ weights
def test_weights_round_trip_exactly(tiny):
    sd = state_dict_from_jax(tiny.params, tiny.model)
    assert set(sd) == set(tiny.port_sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), tiny.port_sd[k], err_msg=k)
    back, stats = convert_state_dict({k: v.numpy() for k, v in sd.items()}, tiny.params)
    assert stats["skipped"] == 0 and stats["unfilled"] == 0
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(tiny.params))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_b[path]), err_msg=str(path))
    # a reference checkpoint also carries BatchNorm's num_batches_tracked
    with_counts = dict(sd)
    for k in [k for k in sd if k.endswith("running_var")]:
        with_counts[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    tiny.model.load_state_dict(with_counts, strict=True)


@pytest.mark.parametrize("fault", ["leftover", "missing"])
def test_state_dict_from_jax_raises_on_unmatched_leaves(tiny, fault):
    params = jax.tree.map(lambda a: a, tiny.params)
    if fault == "leftover":
        params["head"]["bogus"] = {"kernel": np.zeros((2, 2), np.float32)}
    else:
        del params["neck"]["fpn_conv0"]
    with pytest.raises(KeyError):
        state_dict_from_jax(params, tiny.model)


# ------------------------------------------------------------------ modules
def test_vovnet_v39_matches(tiny):
    x = np.random.RandomState(2).randn(2, 64, 96, 3).astype(np.float32)
    spec, out_indices = tiny.cfg.model.backbone.spec, tiny.cfg.model.backbone.out_indices
    want = JVoVNet(spec=spec, out_indices=out_indices, remat=False).apply(
        {"params": tiny.params["backbone"]}, jnp.asarray(x)
    )
    with torch.no_grad():
        got = tiny.model.img_backbone(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert len(got) == len(want) == len(out_indices)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(w), atol=1e-4, rtol=0)


def test_cpfpn_matches_with_half_pixel_nearest_upsample(tiny):
    rng = np.random.RandomState(3)
    # V-39 features of a 32x80 image: 2x5 at stride 16, 1x3 at stride 32, so
    # the top-down path upsamples 1x3 -> 2x5 (a non-integer ratio)
    inputs = [rng.randn(2, 2, 5, 768).astype(np.float32), rng.randn(2, 1, 3, 1024).astype(np.float32)]
    bb = tiny.cfg.model.backbone
    want = JCPFPN(out_channels=bb.fpn_out_channels, num_outs=bb.fpn_num_outs).apply(
        {"params": tiny.params["neck"]}, [jnp.asarray(a) for a in inputs]
    )
    with torch.no_grad():
        got = tiny.model.img_neck([torch.from_numpy(a.transpose(0, 3, 1, 2)) for a in inputs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(w), atol=1e-4, rtol=0)


@pytest.mark.parametrize("use_flash", [True, False])
def test_multihead_attention_matches(tiny, use_flash):
    hc = tiny.cfg.model.head
    rng = np.random.RandomState(4)
    B, Q, L, C = 3, hc.num_query, 60, hc.embed_dim
    query, key, value = (rng.randn(B, n, C).astype(np.float32) for n in (Q, L, L))
    mask = rng.rand(B, L) < 0.3
    if use_flash:
        mask[2] = True  # a fully masked row: zero attention output, then out_proj
    name = "cross_attn" if use_flash else "self_attn"
    jp = tiny.params["head"]["transformer"]["decoder"]["layer0"][name]
    want = JMHA(C, hc.num_heads, use_flash=use_flash).apply(
        {"params": jp}, jnp.asarray(query), jnp.asarray(key), jnp.asarray(value),
        key_padding_mask=jnp.asarray(mask),
    )
    port = tiny.model.pts_bbox_head.transformer.decoder.layers[0].attentions[1 if use_flash else 0]
    assert port.use_flash == use_flash
    with torch.no_grad():
        got = port(torch.from_numpy(query), torch.from_numpy(key), torch.from_numpy(value),
                   key_padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_petr_head_matches_flash(tiny, bf16_model, dtype):
    hc = tiny.cfg.model.head
    rng = np.random.RandomState(5)
    B, N, H, W, Cin = 1, 6, 4, 10, tiny.cfg.model.backbone.fpn_out_channels
    pad_hw = (64, 160)
    feats = rng.randn(B, N, H, W, Cin).astype(np.float32)
    img2lidar = make_cams(B, N, seed=6)
    img_hw = np.tile(np.array(pad_hw, np.float32), (B, N, 1))
    img_hw[0, 2] = [40, 100]
    jhead = JHead(
        num_classes=hc.num_classes, in_channels=Cin, embed_dim=hc.embed_dim,
        num_query=hc.num_query, num_layers=hc.num_layers, num_heads=hc.num_heads,
        ffn_dim=hc.ffn_dim, depth_num=hc.depth_num, position_range=hc.position_range,
        pc_range=hc.pc_range, remat=False, use_flash=True, dtype=jnp.dtype(dtype),
    )
    want = jax.jit(jhead.apply, static_argnums=4)(
        {"params": tiny.params["head"]}, jnp.asarray(feats), jnp.asarray(img2lidar),
        jnp.asarray(img_hw), pad_hw,
    )
    head = (tiny.model if dtype == "float32" else bf16_model).pts_bbox_head
    with torch.no_grad():
        got = head(torch.from_numpy(feats), torch.from_numpy(img2lidar), torch.from_numpy(img_hw), pad_hw)
    for k in ("cls_logits", "bbox_codes"):
        assert got[k].shape == want[k].shape == (hc.num_layers, B, hc.num_query, got[k].shape[-1])
        # bf16 observed: max abs error 2.2e-2 on logits (|max| 5.2, where one
        # bf16 step is 3.1e-2), 4.6e-2 on box codes; at rtol 1e-2 the codes
        # need atol 6.8e-3
        atol, rtol = (1e-4, 0) if dtype == "float32" else (3e-2, 1e-2)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=rtol)


# ----------------------------------------------------------------- detector
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_debug_detector_matches(tiny, bf16_model, dtype):
    """In bf16, as the flagship serves, both packages cast at the same points."""
    jmodel, model = tiny.jmodel, tiny.model
    if dtype == "bfloat16":
        jmodel = JDetector(dataclasses.replace(tiny.jcfg.model, compute_dtype=dtype), deterministic=True)
        model = bf16_model
    want = jax.jit(jmodel.apply)({"params": tiny.params}, *[jnp.asarray(tiny.batch[k]) for k in KEYS])
    with torch.no_grad():
        got = model(*[torch.from_numpy(tiny.batch[k]) for k in KEYS])
    # bf16 observed: max abs error 2.3e-2 on logits (|max| 5.1), 3.7e-2 on
    # box codes (|max| 51); at rtol 1e-2 the codes need atol 1.4e-2
    atol, rtol = (2e-3, 1e-3) if dtype == "float32" else (3e-2, 1e-2)
    for k in ("cls_logits", "bbox_codes"):
        assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "name,overrides",
    [
        # GridMask's grid_mask_exact=False (per-sample float masks) in every
        # family and mode; each of these configs was refused before the
        # float mode was ported
        ("petrv2_vov_p4_800x320", ("model.grid_mask_exact=False",)),
        ("tiny_debug_v2", ("model.use_grid_mask=True", "model.grid_mask_exact=False")),
        ("depthr_r50_c5_512x1408_gtdepth", ("model.use_grid_mask=True", "model.grid_mask_exact=False")),
        ("petr_vov_p4_800x320", ("model.head.kind=depthr", "model.grid_mask_exact=False")),
        ("petr_vov_p4_800x320", ("model.backbone.quant=int8", "model.grid_mask_exact=False")),
        ("petr_vov_p4_800x320", ("model.grid_mask_exact=False", "model.backbone.bn_mode=batch")),
    ],
)
def test_detector_builds_float_grid_mask_configs(name, overrides):
    cfg = get_config(name, overrides)
    assert cfg.model.use_grid_mask and not cfg.model.grid_mask_exact
    model = PETRDetector(cfg.model)
    assert model.config is cfg.model
    noise = draw_train_noise(cfg.model, cfg.data.image_size[0], torch.Generator().manual_seed(0), batch=2)
    assert isinstance(noise.grid, FloatGridParams) and noise.grid.d.shape == (2,)
    assert (noise.grid.d >= 2.0).all() and (noise.grid.d < cfg.data.image_size[0]).all()


def test_tiny_debug_float_grid_mask_train_forward_and_step(tiny):
    """A train-mode forward masks the images the backbone sees by petr_tpu's
    float masks for the same parameters, bit for bit; a train step runs."""
    cfg = get_config("tiny_debug", ["model.use_grid_mask=True", "model.grid_mask_exact=False"])
    images = tiny.batch["images"][:2]
    B, N, H, W, _ = images.shape
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jax_grid_mask(rng, jnp.asarray(images), exact=False))
    grid = jax_float_draws(rng, B, H)
    model = PETRDetector(cfg.model)
    model.load_state_dict(tiny.model.state_dict())
    model.train()
    seen = []
    model.img_backbone.register_forward_pre_hook(lambda m, args: seen.append(args[0].detach().clone()))
    noise = TrainNoise(grid, draw_train_noise(cfg.model, H, torch.Generator().manual_seed(0), B).layer_seeds)
    with torch.no_grad():
        out = model(*[torch.from_numpy(tiny.batch[k][:2]) for k in KEYS], noise=noise)
    assert np.isfinite(out["bbox_codes"].numpy()).all()
    # the backbone folds the views into the batch, channels first
    got = seen[0].reshape(B, N, *seen[0].shape[1:]).permute(0, 1, 3, 4, 2).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and not (got == 0).all()

    state = create_train_state(cfg, 0, 10, "cpu")
    batch = dict(tiny.batch, gt_boxes=np.zeros((3, cfg.data.max_gt, 9), np.float32),
                 gt_labels=np.zeros((3, cfg.data.max_gt), np.int32), gt_valid=np.zeros((3, cfg.data.max_gt), bool))
    batch["gt_boxes"][:, 0] = [1.0, 2.0, 0.0, 2.0, 4.0, 1.5, 0.3, 0.0, 0.0]
    batch["gt_valid"][:, 0] = True
    state, metrics = make_train_step(cfg)(state, batch, torch.Generator().manual_seed(1))
    assert np.isfinite(float(metrics["loss"])) and not metrics["skipped"]


# ------------------------------------------------------------------ serving
def _gap_ranks(scores, gap=1e-7):
    """Ranks whose score is more than ``gap`` from both neighbours. Random
    weights give scores ~6e-7 apart (median); the port's fp32 logits are
    within ~1e-6 of petr_tpu's, i.e. scores within ~2e-8, so only closer
    neighbours may trade places."""
    keep = np.ones_like(scores, bool)
    keep[1:] &= (scores[:-1] - scores[1:]) > gap
    keep[:-1] &= (scores[:-1] - scores[1:]) > gap
    return keep


def test_server_and_serving_fn_match_eval_step(tiny):
    want = jax.jit(make_eval_step(tiny.jcfg))(
        tiny.params, {k: jnp.asarray(v) for k, v in tiny.batch.items()}
    )
    want = {k: np.asarray(v) for k, v in want.items()}
    fn = make_serving_fn(tiny.cfg, tiny.model, device="cpu")
    calls = []

    def counted(*args):
        calls.append(args[0].shape[0])
        return fn(*args)

    requests = [{k: tiny.batch[k][i] for k in KEYS} for i in range(3)]
    with InferenceServer(counted, batch_size=2, max_delay_ms=200.0) as server:
        results = [f.result(timeout=120) for f in [server.submit(r) for r in requests]]
    assert calls == [2, 2], "3 requests at batch 2: one full batch, one padded"
    direct = fn(*[tiny.batch[k] for k in KEYS])
    for i, res in enumerate(results):
        assert res["boxes"].shape == (tiny.cfg.max_det, 9) and res["labels"].dtype == np.int32
        for got in (res, {k: v[i] for k, v in direct.items()}):
            np.testing.assert_allclose(got["scores"], want["scores"][i], atol=1e-6)
            keep = _gap_ranks(want["scores"][i])
            assert keep.sum() > 100
            np.testing.assert_array_equal(got["labels"][keep], want["labels"][i][keep])
            np.testing.assert_array_equal(got["valid"][keep], want["valid"][i][keep])
            np.testing.assert_allclose(got["boxes"][keep], want["boxes"][i][keep], atol=2e-3, rtol=1e-3)


def test_server_resolves_every_future_on_error():
    def broken(*args):
        raise ValueError("serving failed")

    sample = {k: np.zeros((2, 2), np.float32) for k in KEYS}
    with InferenceServer(broken, batch_size=2, max_delay_ms=100.0) as server:
        futures = [server.submit(sample) for _ in range(3)]
        for f in futures:
            with pytest.raises(ValueError, match="serving failed"):
                f.result(timeout=30)
    with pytest.raises(KeyError):
        InferenceServer(broken).submit({"images": np.zeros(1)})


def test_build_detector_is_seeded():
    cfg = get_config("tiny_debug")
    a = build_detector(cfg, seed=3, device="cpu").state_dict()
    b = build_detector(cfg, seed=3, device="cpu").state_dict()
    c = build_detector(cfg, seed=4, device="cpu").state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert any(not torch.equal(a[k], c[k]) for k in a if "running" not in k)


def test_entry_points_refuse_cuda_without_a_card(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serving_fn(tiny.cfg, tiny.model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_detector(tiny.cfg, seed=0)
