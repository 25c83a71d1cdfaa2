"""The r50dcn slice of petr_tpu_torch against petr_tpu, on the CPU.

Bilinear sampling, the plain DCNv2 (against petr_tpu's XLA formulation and
its Pallas kernel in interpret mode), its gradients, the ResNet-50-DCN
backbone, and the ``petr_r50_p4_1408x512`` / ``petr_r50_c5_1408x512``
detectors, shrunk with ``dataclasses.replace`` to 2 views of 64x160 and a
small head. One set of weights serves both packages: a seeded port model
with random frozen-BN statistics and its offset convs redrawn (both
packages initialise those to zeros, which would leave every offset 0 and
every mask 0.5) goes to a petr_tpu param tree through petr_tpu's own
converter, and back through ``state_dict_from_jax``. Inputs are seeded
numpy arrays fed to both. Tolerances are stated at each check.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from petr_tpu.configs import get_config as jax_config
from petr_tpu.models import PETRDetector as JDetector
from petr_tpu.models.resnet import ResNet as JResNet
from petr_tpu.ops.dcn import modulated_deform_conv as jax_dcn
from petr_tpu.ops.pallas.dcn import modulated_deform_conv_pallas
from petr_tpu.ops.sampling import bilinear_sample as jax_bilinear
from petr_tpu.ops.sampling import grid_sample_normalized as jax_grid_sample
from petr_tpu.utils.torch_convert import convert_state_dict
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.models import PETRDetector, init_weights
from petr_tpu_torch.models.layers import FrozenBatchNorm
from petr_tpu_torch.models.resnet import ModulatedDeformConv2dPack, redraw_offset_convs
from petr_tpu_torch.ops import dcn
from petr_tpu_torch.ops.sampling import bilinear_sample, bilinear_sample_batched, grid_sample_normalized
from petr_tpu_torch.utils import state_dict_from_jax
from tests.test_heads import make_cams

KEYS = ("images", "img2lidar", "img_hw")
N_VIEWS, IMG_H, IMG_W = 2, 64, 160


def small(cfg, dtype="float32"):
    """A preset cut to a small head and image; widths of the backbone kept."""
    head = dataclasses.replace(cfg.model.head, num_query=32, embed_dim=64, num_layers=2, num_heads=4,
                               ffn_dim=128, depth_num=8)
    model = dataclasses.replace(cfg.model, head=head, compute_dtype=dtype)
    data = dataclasses.replace(cfg.data, num_views=N_VIEWS, image_size=(IMG_H, IMG_W), max_gt=16)
    return dataclasses.replace(cfg, model=model, data=data)


def randomize_bn(model, rng):
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))
                m.weight.copy_(torch.from_numpy(rng.normal(1.0, 0.2, c)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, c)))


def to_jax(model, jcfg, batch):
    """The port model's weights as a petr_tpu param tree, through petr_tpu's
    converter, which must fill every leaf and skip no key."""
    port_sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    one = [jnp.asarray(batch[k][:1]) for k in KEYS]
    shapes = jax.eval_shape(JDetector(jcfg.model, deterministic=True).init, jax.random.PRNGKey(0), *one)["params"]
    params, stats = convert_state_dict(port_sd, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    return port_sd, params, stats


@pytest.fixture(scope="module")
def r50():
    rng = np.random.RandomState(0)
    batch = {
        "images": rng.randn(2, N_VIEWS, IMG_H, IMG_W, 3).astype(np.float32),
        "img2lidar": make_cams(2, N_VIEWS, seed=1),
        "img_hw": np.tile(np.array([IMG_H, IMG_W], np.float32), (2, N_VIEWS, 1)),
    }
    batch["img_hw"][1, 1] = [40, 112]  # a padded view: masked decoder keys
    nets = {}
    for name in ("p4", "c5"):
        cfg = small(get_config(f"petr_r50_{name}_1408x512"))
        jcfg = small(jax_config(f"petr_r50_{name}_1408x512"))
        model = init_weights(PETRDetector(cfg.model), seed=0).eval()
        if name == "c5":  # the same backbone as p4's; its own head over C5
            model.img_backbone.load_state_dict(nets["p4"].model.img_backbone.state_dict())
        else:
            assert redraw_offset_convs(model, seed=1) == 9
            randomize_bn(model, rng)
        port_sd, params, stats = to_jax(model, jcfg, batch)
        model.load_state_dict(state_dict_from_jax(params, model))
        nets[name] = types.SimpleNamespace(cfg=cfg, jcfg=jcfg, model=model, port_sd=port_sd,
                                           params=params, stats=stats)
    return types.SimpleNamespace(batch=batch, **nets)


# ------------------------------------------------------------------ sampling
def test_bilinear_sample_matches_with_points_outside_the_plane():
    rng = np.random.RandomState(0)
    feat = rng.randn(5, 7, 3).astype(np.float32)
    # points over and past every edge, plus the exact half-pixel cases
    # above and left of the plane, where a corner at -1 must count as 0
    xy = rng.uniform(-2.5, 8.5, (40, 2)).astype(np.float32)
    xy = np.concatenate([xy, [[-0.5, 2.0], [3.0, -0.5], [-0.5, -0.5], [6.5, 4.5], [-1.0, -1.0]]]).astype(np.float32)
    got = bilinear_sample(torch.from_numpy(feat), torch.from_numpy(xy)).numpy()
    want = np.asarray(jax_bilinear(jnp.asarray(feat), jnp.asarray(xy)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)  # the same fp32 ops
    np.testing.assert_allclose(got[40], 0.5 * feat[2, 0], rtol=1e-6)  # half of the edge pixel
    assert (got[-1] == 0).all()
    grid = rng.uniform(-1.2, 1.2, (3, 4, 2)).astype(np.float32)
    for align in (False, True):
        got = grid_sample_normalized(torch.from_numpy(feat), torch.from_numpy(grid), align).numpy()
        want = np.asarray(jax_grid_sample(jnp.asarray(feat), jnp.asarray(grid), align))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ----------------------------------------------------------------------- DCN
def dcn_case(stride, B=2, H=9, W=11, Cin=8, Cout=16, seed=0):
    """NHWC inputs in petr_tpu's layout: offsets of a few pixels (std 3), so
    that taps reach past every edge, and mask logits of std 1.5."""
    rng = np.random.RandomState(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    off_mask = np.concatenate([rng.randn(B, Ho, Wo, 18) * 3.0, rng.randn(B, Ho, Wo, 9) * 1.5], -1).astype(np.float32)
    w = (rng.randn(3, 3, Cin, Cout) * 0.1).astype(np.float32)
    return x, off_mask, w


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("stride", [1, 2])
def test_plain_dcn_matches_xla_formulation_and_pallas_kernel(stride):
    x, off_mask, w = dcn_case(stride)
    got = dcn.modulated_deform_conv(nchw(x), nchw(off_mask), oihw(w), stride).numpy().transpose(0, 2, 3, 1)
    xla = np.asarray(jax_dcn(jnp.asarray(x), jnp.asarray(off_mask), jnp.asarray(w), stride=stride, impl="xla"))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(modulated_deform_conv_pallas(
            jnp.asarray(x), jnp.asarray(off_mask), jnp.asarray(w), stride, 1, "onehot"))
    scale = np.abs(xla).max()
    # fp32 both ways, sums in other orders: within 1e-5 of the largest output
    for want in (xla, pallas):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    assert np.abs(got).max() > 0.5  # not a zero-sample degenerate case


# The bf16 K4 rounds the modulated samples and the weight to bf16 before
# their products (petr_tpu's Pallas kernel multiplies in x's dtype too); the
# plain version with operand_dtype=bfloat16 is that rounding floor. In bf16
# the floor, petr_tpu's XLA formulation (fp32 inside, one rounding) and its
# interpreted Pallas kernel (the interpolation matrix and the weight in bf16)
# agree within atol * max|ref| + rtol * |ref| for (atol, rtol) = (4e-3,
# 1.6e-2), chip_smoke.py's OPERAND_TOL; the floor took 0.33-0.51 of it here.
OPERAND_TOL = (4e-3, 1.6e-2)


@pytest.mark.parametrize("stride,shape", [(1, {}), (2, {}), (1, dict(B=1, H=12, W=17, Cin=40, Cout=24, seed=3))],
                         ids=["stride1", "stride2", "c40"])
def test_bf16_rounding_floor_matches_xla_formulation_and_pallas_kernel(stride, shape):
    x, off_mask, w = dcn_case(stride, **shape)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = dcn.modulated_deform_conv_reference(nchw(x).bfloat16(), nchw(off_mask), oihw(w), stride,
                                              operand_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().transpose(0, 2, 3, 1)
    xla = jax_dcn(xb, jnp.asarray(off_mask), jnp.asarray(w), stride=stride, impl="xla")
    with pltpu.force_tpu_interpret_mode():
        pallas = modulated_deform_conv_pallas(xb, jnp.asarray(off_mask), jnp.asarray(w), stride, 1, "onehot")
    plain = dcn.modulated_deform_conv_reference(nchw(x).bfloat16(), nchw(off_mask), oihw(w), stride)
    atol, rtol = OPERAND_TOL
    for want in (np.asarray(xla.astype(jnp.float32)), np.asarray(pallas.astype(jnp.float32))):
        err = np.abs(got - want)
        assert (err <= atol * np.abs(want).max() + rtol * np.abs(want)).all(), err.max()
    # the unrounded plain version is the XLA formulation (fp32 inside): one bf16 step at most
    np.testing.assert_allclose(plain.float().numpy().transpose(0, 2, 3, 1), np.asarray(xla.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-5 * np.abs(got).max())
    assert np.abs(got - plain.float().numpy().transpose(0, 2, 3, 1)).max() > 0  # the operands were rounded


@pytest.mark.parametrize("Cin", [5, 8, 40])
def test_bf16_weight_repack_times_sample_im2col_is_the_plain_conv(Cin):
    """The bf16 kernel's operands: its weight image (bf16, chunks of 64
    channels of one tap) read back in K order, (Cout, 9, Cp64) with j = tap *
    Cp64 + c and zeros past Cin, times the (P, 9 * Cp64) matrix of the
    modulated samples in the same j order, is the plain version with
    operand_dtype=bfloat16 (fp32 sums in another order: 1e-5 of the largest
    output)."""
    x, off_mask, w = dcn_case(1, B=2, H=7, W=10, Cin=Cin, Cout=12, seed=Cin)
    xt, om, wt = nchw(x).bfloat16(), nchw(off_mask), oihw(w)
    B, _, H, W = xt.shape
    image = dcn.weight_image(wt)
    tiles, chunks = image.shape[:2]
    Cp = chunks // 9 * dcn.CHUNK_CHANNELS
    assert image.dtype == torch.bfloat16 and tiles == 1 and Cp == 64
    wr = image.permute(0, 3, 1, 2, 4).reshape(dcn.TILE_CHANNELS, 9, Cp)[:12]  # (Cout, tap, c)
    # the modulated samples (B, P, 9, Cin) as the plain version takes them
    K = 9
    o = om.permute(0, 2, 3, 1)
    off = o[..., :2 * K].reshape(B, H, W, K, 2)
    ty, tx = torch.meshgrid(torch.arange(3.0) - 1, torch.arange(3.0) - 1, indexing="ij")
    sy = torch.arange(H, dtype=torch.float32)[None, :, None, None] + ty.reshape(K) + off[..., 0]
    sx = torch.arange(W, dtype=torch.float32)[None, None, :, None] + tx.reshape(K) + off[..., 1]
    samples = bilinear_sample_batched(xt.float().permute(0, 2, 3, 1), torch.stack([sx, sy], -1))
    samples = (samples * torch.sigmoid(o[..., 2 * K:])[..., None]).bfloat16().float()
    col = torch.zeros(B, H * W, K, Cp)
    col[..., :Cin] = samples.reshape(B, H * W, K, Cin)
    got = torch.matmul(col.reshape(B, H * W, K * Cp), wr.float().reshape(12, K * Cp).t())
    want = dcn.modulated_deform_conv_reference(xt, om, wt, operand_dtype=torch.bfloat16).float()
    want = want.permute(0, 2, 3, 1).reshape(B, H * W, 12)
    scale = want.abs().max()
    # want was rounded once to bf16: one bf16 step of |want| plus fp32 noise
    assert ((got - want).abs() <= 2.0 ** -8 * want.abs() + 1e-5 * scale).all()
    assert (wr[..., Cin:] == 0).all()


@pytest.mark.parametrize("C", [5, 8, 16])
def test_channels_last_copy_pads_with_zeros(C):
    x = torch.randn(2, C, 3, 4).bfloat16()
    Cp = -(-C // 8) * 8
    xc = dcn.channels_last(x, Cp)
    assert xc.shape == (2, 3, 4, Cp) and xc.is_contiguous()
    assert torch.equal(xc[..., :C], x.permute(0, 2, 3, 1)) and (xc[..., C:] == 0).all()


@pytest.mark.parametrize("stride", [1, 2])
def test_dcn_gradients_match_jax_vjp(stride):
    x, off_mask, w = dcn_case(stride, B=1, H=7, W=8, Cin=4, Cout=6, seed=1)
    out_shape = np.asarray(jax_dcn(jnp.asarray(x), jnp.asarray(off_mask), jnp.asarray(w), stride=stride)).shape
    g = np.random.RandomState(2).randn(*out_shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, o, k: jax_dcn(a, o, k, stride=stride, impl="xla"),
                     jnp.asarray(x), jnp.asarray(off_mask), jnp.asarray(w))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    ins = [t.requires_grad_() for t in (nchw(x), nchw(off_mask), oihw(w))]
    dcn.modulated_deform_conv(*ins, stride).backward(nchw(g))
    got = [ins[0].grad.numpy().transpose(0, 2, 3, 1), ins[1].grad.numpy().transpose(0, 2, 3, 1),
           ins[2].grad.numpy().transpose(2, 3, 1, 0)]
    for name, a, b in zip(("x", "off_mask", "weight"), got, want):
        # fp32 autograd of the same formulation both ways: within 1e-5 of
        # each gradient's largest entry
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_backward_never_enters_the_forward(monkeypatch):
    """The backward differentiates the plain version directly: the
    Function's forward (which launches K4 on the card) runs once per call,
    never again from the backward (petr_tpu's round-3 recursion)."""
    entered = []
    forward = dcn._ModulatedDeformConv.forward

    def counting(ctx, *args):
        entered.append(torch.is_grad_enabled())
        return forward(ctx, *args)

    monkeypatch.setattr(dcn._ModulatedDeformConv, "forward", staticmethod(counting))
    x, off_mask, w = dcn_case(1, B=1, H=5, W=6, Cin=4, Cout=4)
    ins = [t.requires_grad_() for t in (nchw(x), nchw(off_mask), oihw(w))]
    out = dcn.modulated_deform_conv(*ins)
    assert len(entered) == 1
    out.square().sum().backward()
    assert len(entered) == 1, "the backward re-entered the Function's forward"
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in ins)


# ------------------------------------------------------------------ weights
@pytest.mark.parametrize("name", ["p4", "c5"])
def test_weights_round_trip_exactly(r50, name):
    net = getattr(r50, name)
    assert net.stats["skipped"] == 0 and net.stats["unfilled"] == 0, net.stats
    sd = state_dict_from_jax(net.params, net.model)
    assert set(sd) == set(net.port_sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), net.port_sd[k], err_msg=k)
    offsets = [k for k in sd if k.endswith("conv2.conv_offset.weight")]
    assert len(offsets) == 9 and all(np.abs(sd[k].numpy()).max() > 0 for k in offsets)


# ----------------------------------------------------------------- backbone
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet50_dcn_backbone_matches(r50, dtype):
    x = np.random.RandomState(3).randn(2, IMG_H, IMG_W, 3).astype(np.float32)
    bb = r50.p4.cfg.model.backbone
    jnet = JResNet(depth=50, out_indices=bb.out_indices, dcn_stages=bb.dcn_stages, remat_stages=False,
                   dtype=jnp.dtype(dtype))
    want = jax.jit(jnet.apply)({"params": r50.p4.params["backbone"]}, jnp.asarray(x).astype(dtype))
    with torch.no_grad():
        got = r50.p4.model.img_backbone(torch.from_numpy(x.transpose(0, 3, 1, 2)).to(getattr(torch, dtype)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        g = g.float().numpy().transpose(0, 2, 3, 1)
        w = np.asarray(w.astype(jnp.float32))
        scale = np.abs(w).max()
        err = np.abs(g - w)
        if dtype == "float32":
            # 16 bottlenecks in fp32, sums in other orders
            assert err.max() <= 1e-5 * scale, (err.max(), scale)
        else:
            # each package's bf16 output is 1.3-1.8% (mean) from its fp32
            # output here, and the two bf16 outputs are 0.8-1.2% apart (sums
            # in other orders, rounded to bf16 after every layer): held to
            # 2% of the mean |ref| on average and 5% of the max |ref| at most
            assert err.max() <= 0.05 * scale and err.mean() <= 0.02 * np.abs(w).mean(), (err.max(), err.mean(), scale)


# ----------------------------------------------------------------- detector
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["p4", "c5"])
def test_r50_detector_matches(r50, name, dtype):
    net = getattr(r50, name)
    jcfg = dataclasses.replace(net.jcfg.model, compute_dtype=dtype)
    want = jax.jit(JDetector(jcfg, deterministic=True).apply)(
        {"params": net.params}, *[jnp.asarray(r50.batch[k]) for k in KEYS])
    model = net.model
    if dtype == "bfloat16":
        model = PETRDetector(dataclasses.replace(net.cfg.model, compute_dtype=dtype)).eval()
        model.load_state_dict(net.model.state_dict())
    with torch.no_grad():
        got = model(*[torch.from_numpy(r50.batch[k]) for k in KEYS])
    hc = net.cfg.model.head
    for k in ("cls_logits", "bbox_codes"):
        assert got[k].shape == want[k].shape == (hc.num_layers, 2, hc.num_query, got[k].shape[-1])
        g, w = got[k].numpy(), np.asarray(want[k])
        if dtype == "float32":  # ResNet-50 and 2 decoder layers, sums in other orders
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=2e-3, err_msg=k)
            continue
        # bf16: the head takes features of magnitude ~100 (the random-weight
        # ResNet's), so each package's bf16 outputs lie 0.011-0.033 (mean)
        # from its own fp32 outputs, and the two bf16 outputs as far from
        # each other (observed: max 0.24 on logits of |max| 5.3; mean 0.033).
        # A centre code is sigmoid(logit) x 102.4 m: one bf16 step of a
        # logit near 4 moves it by up to 0.8 (observed max 1.4). Fed the same
        # bf16 features, the two heads agree twice as closely as either does
        # with fp32.
        err = np.abs(g - w)
        atol = 0.3 if k == "cls_logits" else 2.0
        assert (err <= atol + 3e-2 * np.abs(w)).all(), (k, err.max())
        assert err.mean() <= 5e-2, (k, err.mean())


def test_c5_head_reads_the_2048_channel_stage(r50):
    assert r50.c5.model.img_neck is None
    assert r50.c5.model.pts_bbox_head.input_proj.weight.shape[1] == 2048
    assert isinstance(r50.c5.model.img_backbone.layer4[0].conv2, ModulatedDeformConv2dPack)


def test_init_weights_zeroes_every_offset_conv():
    model = init_weights(PETRDetector(small(get_config("petr_r50_p4_1408x512")).model), seed=0)
    packs = [m for m in model.modules() if isinstance(m, ModulatedDeformConv2dPack)]
    assert len(packs) == 9  # stages 3 and 4 of ResNet-50: 6 + 3 bottlenecks
    for m in packs:
        assert (m.conv_offset.weight == 0).all() and (m.conv_offset.bias == 0).all()
        assert m.weight.abs().max() > 0
