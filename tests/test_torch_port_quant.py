"""The int8 PTQ slice of petr_tpu_torch against petr_tpu, on the CPU.

``ConvBNReLU`` in "calib" and "int8" modes against petr_tpu's at small
shapes (3x3 and 1x1, stride 1 and 2, Cin = 3, ReLU on and off); the
tiny_debug detector's calibration, its scales files in both directions,
its int8 forward, test-time augmentation, conv-BN folding (VoVNet and
ResNet naming) and ``cli.quantize --synthetic``. One set of weights serves
both packages: a seeded port model with random frozen-BN statistics goes
to a petr_tpu param tree through petr_tpu's converter. The int8 operands
and int32 sums are compared bit for bit with petr_tpu's expressions
(`petr_tpu/models/layers.py:202-229`) evaluated by XLA; tolerances are
stated at each check. On the CPU the port's int8 conv is the plain version
of K6 (float64 sums of the int8 operands, exact). petr_tpu's detector runs
its plain attention branch here (``use_flash_attention=False``: its
interpret-mode Pallas kernel would cost most of this file's time); the
attention reads no quantised value, and no row of these inputs is fully
masked, where the two branches differ.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from petr_tpu.configs import get_config as jax_config
from petr_tpu.models import PETRDetector as JDetector
from petr_tpu.models.layers import ConvBNReLU as JConvBNReLU
from petr_tpu.quant import calibrate_detector as jax_calibrate
from petr_tpu.quant import load_scales as jax_load_scales
from petr_tpu.quant import save_scales as jax_save_scales
from petr_tpu.utils.fuse import fold_frozen_bn as jax_fold
from petr_tpu.utils.torch_convert import convert_state_dict
from petr_tpu_torch.cli import quantize as cli_quantize
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.models import PETRDetector, init_weights
from petr_tpu_torch.models.layers import ConvBNReLU, FrozenBatchNorm
from petr_tpu_torch.ops import conv_int8
from petr_tpu_torch.quant import apply_scales, calibrate_detector, load_scales, quant_convs, save_scales, set_quant
from petr_tpu_torch.utils.fuse import fold_frozen_bn

KEYS = ("images", "img2lidar", "img_hw")


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
    one = [jnp.asarray(batch[k][:1]) for k in KEYS]
    shapes = jax.eval_shape(JDetector(jcfg.model, deterministic=True).init, jax.random.PRNGKey(0), *one)["params"]
    params, stats = convert_state_dict({k: v.numpy().copy() for k, v in model.state_dict().items()},
                                       jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    assert stats["skipped"] == 0 and stats["unfilled"] == 0, stats
    return jax.tree.map(jnp.asarray, params)


def jax_tiny():
    cfg = jax_config("tiny_debug")
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_flash_attention=False))


def with_quant(cfg, mode):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=dataclasses.replace(cfg.model.backbone, quant=mode)))


@pytest.fixture(scope="module")
def tiny():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg, jcfg = get_config("tiny_debug"), jax_tiny()
    model = init_weights(PETRDetector(cfg.model), seed=0).eval()
    randomize_bn(model, np.random.RandomState(0))
    batches = [cli_quantize.synthetic_batch(cfg, 1, s) for s in range(2)]
    params = to_jax(model, jcfg, batches[0])
    jscales = jax.tree.map(np.asarray, jax_calibrate(jcfg, params, batches))
    scales = calibrate_detector(cfg, model, batches)
    yield types.SimpleNamespace(cfg=cfg, jcfg=jcfg, model=model, batches=batches, params=params,
                                jscales=jscales, scales=scales)
    torch.set_num_threads(threads)


# ------------------------------------------------------------- ConvBNReLU
CONV_CASES = [  # (cin, cout, kernel, stride, relu)
    (3, 16, 3, 2, True),  # the stem's first conv
    (16, 24, 3, 1, True),
    (32, 16, 3, 2, False),
    (48, 32, 1, 1, True),
    (40, 8, 1, 1, False),
]


def _conv_pair(cin, cout, k, s, relu, mode, seed):
    """Seeded inputs, weights and BN for both packages. The BN variances are
    4^j - eps, so that rsqrt(var + eps) is a power of two in both: XLA's CPU
    rsqrt and torch's differ in the last bit on about 37% of inputs (measured
    over 1e5 uniform draws), which moves the folded weight wf = w * mul by an
    ulp and may move a rounding of wf / sw; ``test_quantize_weight_matches_
    petr_tpu`` holds that arithmetic to petr_tpu's on any mul."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 9, 11, cin).astype(np.float32)  # NHWC for petr_tpu
    w = (rng.randn(k, k, cin, cout) * (2.0 / (k * k * cin)) ** 0.5).astype(np.float32)  # HWIO
    var = np.float32(4.0) ** rng.randint(-1, 2, cout).astype(np.float32) - np.float32(1e-5)
    bn = {"scale": rng.normal(1, 0.2, cout), "bias": rng.normal(0, 0.2, cout),
          "mean": rng.normal(0, 0.5, cout), "var": var}
    bn = {key: v.astype(np.float32) for key, v in bn.items()}
    jmod = JConvBNReLU(cout, k, s, relu=relu, quant=mode)
    jparams = {"conv": {"kernel": jnp.asarray(w)}, "bn": {key: jnp.asarray(v) for key, v in bn.items()}}
    port = ConvBNReLU("c", cin, cout, k, s, relu=relu, quant=mode)
    with torch.no_grad():
        port[0].weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        for key, name in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"), ("var", "running_var")):
            getattr(port[1], name).copy_(torch.from_numpy(bn[key]))
    return x, w, bn, jmod, jparams, port


@pytest.mark.parametrize("cin,cout,k,s,relu", CONV_CASES)
def test_conv_bn_relu_calib_matches_petr_tpu(cin, cout, k, s, relu):
    """calib keeps the numerics and records max |x| over two inputs, as petr_tpu's."""
    x, _, _, jmod, jparams, port = _conv_pair(cin, cout, k, s, relu, "calib", seed=cin)
    x2 = (x * 1.7)[:, ::-1].copy()
    quant = None
    for xi in (x, x2):
        variables = {"params": jparams} if quant is None else {"params": jparams, "quant": quant}
        want, upd = jmod.apply(variables, jnp.asarray(xi), mutable=["quant"])
        quant = upd["quant"]
        with torch.no_grad():
            got = port(torch.from_numpy(xi.transpose(0, 3, 1, 2).copy()))
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert port[0].act_amax.item() == float(quant["act_amax"]) == np.abs(x2).max()


@pytest.mark.parametrize("cin,cout,k,s,relu", CONV_CASES)
def test_conv_bn_relu_int8_matches_petr_tpu(cin, cout, k, s, relu):
    """The int8 weight and activation, the int32 sums bit for bit (petr_tpu's
    expressions under XLA); the output within 1e-6 relative (fp32)."""
    x, w, bn, jmod, jparams, port = _conv_pair(cin, cout, k, s, relu, "int8", seed=cin + 1)
    amax = np.float32(np.abs(x).max() * 0.8)  # some inputs saturate at +-127
    want = np.asarray(jmod.apply({"params": jparams, "quant": {"act_amax": jnp.asarray(amax)}}, jnp.asarray(x)))
    # petr_tpu's _int8_forward, step by step
    mul = jnp.asarray(bn["scale"]) * jax.lax.rsqrt(jnp.asarray(bn["var"]) + 1e-5)
    wf = jnp.asarray(w) * mul
    sw = jnp.maximum(jnp.max(jnp.abs(wf), axis=(0, 1, 2)), 1e-12) / 127.0
    wi = jnp.clip(jnp.round(wf / sw), -127, 127).astype(jnp.int8)
    sa = jnp.maximum(jnp.asarray(amax), 1e-6) / 127.0
    xi = jnp.clip(jnp.round(jnp.asarray(x) / sa), -127.0, 127.0).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(xi, wi, (s, s), [(k // 2, k // 2)] * 2,
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32)
    with torch.no_grad():
        port[0].act_amax.fill_(float(amax))
        pmul = port[1].weight * torch.rsqrt(port[1].running_var + port[1].eps)
        pwi, psw = conv_int8.quantize_weight(port[0].weight, pmul)
        psa = conv_int8.act_scale(port[0].act_amax)
        tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        pxi = conv_int8.quantize_activation(tx, psa)
        pacc = conv_int8.conv_int8_accumulate_reference(pxi, pwi, s)
        got = port(tx).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(pwi.numpy().transpose(2, 3, 1, 0), np.asarray(wi))
    np.testing.assert_array_equal(pxi.numpy().transpose(0, 2, 3, 1), np.asarray(xi))
    assert (np.abs(np.asarray(xi)) == 127).any()
    np.testing.assert_array_equal(pacc.numpy().transpose(0, 2, 3, 1), np.asarray(acc))
    assert psa.item() == float(sa)
    np.testing.assert_array_equal(psw.numpy(), np.asarray(sw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("k", [1, 3])
def test_quantize_weight_matches_petr_tpu(k):
    """wi and sw bit for bit from the same BN scale ``mul`` (any value):
    petr_tpu's ``wf = w * mul``, ``sw = max(max|wf|, 1e-12) / 127``,
    ``wi = clip(round(wf / sw), +-127)``."""
    rng = np.random.RandomState(k)
    w = (rng.randn(k, k, 24, 40) * 0.1).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero channel takes the 1e-12 floor
    mul = (rng.uniform(0.3, 3.0, 40)).astype(np.float32)
    wf = jnp.asarray(w) * jnp.asarray(mul)
    sw = jnp.maximum(jnp.max(jnp.abs(wf), axis=(0, 1, 2)), 1e-12) / 127.0
    wi = jnp.clip(jnp.round(wf / sw), -127, 127).astype(jnp.int8)
    pwi, psw = conv_int8.quantize_weight(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(mul))
    np.testing.assert_array_equal(psw.numpy(), np.asarray(sw))
    np.testing.assert_array_equal(pwi.numpy().transpose(2, 3, 1, 0), np.asarray(wi))


def test_quant_modes_refuse_batch_bn_and_resnet():
    port = ConvBNReLU("c", 4, 8, quant="int8", bn_mode="batch")
    with pytest.raises(ValueError, match="frozen BN"):
        port(torch.zeros(1, 4, 5, 5))
    with pytest.raises(NotImplementedError, match="VoVNet"):
        PETRDetector(with_quant(get_config("petr_r50_c5_1408x512"), "int8").model)
    model = init_weights(PETRDetector(get_config("tiny_debug").model), seed=0)
    with pytest.raises(KeyError, match="missing"):
        apply_scales(model, {"backbone": {}})


# --------------------------------------------------------------- detector
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: np.asarray(v)})
    return out


def test_calibrate_detector_matches_petr_tpu(tiny):
    """The same 39 leaves (V-39: 3 + 6 per block), amax within fp32 rounding."""
    want, got = _flat(tiny.jscales), _flat(tiny.scales)
    assert sorted(got) == sorted(want) and len(got) == len(quant_convs(tiny.model)) == 39
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=2e-6, err_msg=key)
        assert got[key].dtype == np.float32 and got[key].shape == ()


def test_scales_files_cross_over(tiny, tmp_path):
    """petr_tpu's file loads into the port and the port's into petr_tpu, key for
    key and bit for bit."""
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_save_scales(jpath, tiny.jscales)
    save_scales(ppath, tiny.scales)
    assert sorted(np.load(jpath).files) == sorted(np.load(ppath).files)
    for key, v in _flat(load_scales(jpath)).items():
        np.testing.assert_array_equal(v, _flat(tiny.jscales)[key])
    for key, v in _flat(jax.tree.map(np.asarray, jax_load_scales(ppath))).items():
        np.testing.assert_array_equal(v, _flat(tiny.scales)[key])


def test_int8_detector_matches_petr_tpu(tiny):
    """The tiny_debug detector with petr_tpu's scales against petr_tpu's int8
    apply: within the fp32 detector test's limits (atol 2e-3, rtol 1e-3;
    the backbone's fp32 ops outside the int8 convs round apart by an ulp,
    which may move an activation across a quantisation step)."""
    jq = JDetector(with_quant(tiny.jcfg, "int8").model, deterministic=True)
    b = tiny.batches[1]
    want = jax.jit(jq.apply)({"params": tiny.params, "quant": tiny.jscales}, *[jnp.asarray(b[k]) for k in KEYS])
    apply_scales(tiny.model, tiny.jscales)
    try:
        with torch.no_grad():
            got = tiny.model(*[torch.from_numpy(b[k]) for k in KEYS])
            set_quant(tiny.model, "none")
            full = tiny.model(*[torch.from_numpy(b[k]) for k in KEYS])
    finally:
        set_quant(tiny.model, "none")
    for k in ("cls_logits", "bbox_codes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-3, atol=2e-3, err_msg=k)
        rel = np.linalg.norm(got[k].numpy() - full[k].numpy()) / np.linalg.norm(full[k].numpy())
        assert 0 < rel < 0.05, (k, rel)  # petr_tpu's int8-versus-float bound (tests/test_quant.py)


@pytest.mark.parametrize("mode", ["identity", "hflip"])
def test_tta_matches_petr_tpu(tiny, mode):
    """6-d images: features averaged over the variants, the first one's
    geometry; against petr_tpu's 6-d apply (fp32 limits as above)."""
    from petr_tpu.cli.test import apply_tta as jax_tta
    from petr_tpu_torch.cli.test import apply_tta

    b = tiny.batches[0]
    images = apply_tta(b["images"], mode)
    np.testing.assert_array_equal(images, np.asarray(jax_tta(b["images"], mode)))
    assert images.shape == (1, 2, *b["images"].shape[1:])
    jm = JDetector(tiny.jcfg.model, deterministic=True)
    want = jax.jit(jm.apply)({"params": tiny.params}, jnp.asarray(images), jnp.asarray(b["img2lidar"]),
                             jnp.asarray(b["img_hw"]))
    with torch.no_grad():
        got = tiny.model(torch.from_numpy(images), torch.from_numpy(b["img2lidar"]), torch.from_numpy(b["img_hw"]))
        plain = tiny.model(*[torch.from_numpy(b[k]) for k in KEYS])
    for k in ("cls_logits", "bbox_codes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-3, atol=2e-3, err_msg=k)
        if mode == "identity":  # the mean of two equal features is the feature
            torch.testing.assert_close(got[k], plain[k], rtol=0, atol=0)


# ---------------------------------------------------------------- folding
@pytest.mark.parametrize("preset", ["tiny_debug", "petr_r50_p4_1408x512"])
def test_fold_frozen_bn_matches_petr_tpu(tiny, preset):
    """The folded state_dict, carried to petr_tpu by its converter, equals
    petr_tpu's fold of the unfolded tree leaf for leaf (VoVNet's
    ``{name}/conv`` + ``/norm``; ResNet's conv/bn and downsample pairs, the
    DCN conv2 left alone as petr_tpu leaves it)."""
    if preset == "tiny_debug":
        cfg, jcfg, model = tiny.cfg, tiny.jcfg, tiny.model
    else:
        small = lambda c: dataclasses.replace(c, model=dataclasses.replace(  # noqa: E731
            c.model, head=dataclasses.replace(c.model.head, num_query=8, embed_dim=32, num_layers=1,
                                              num_heads=2, ffn_dim=32, depth_num=4)),
            data=dataclasses.replace(c.data, num_views=1, image_size=(32, 64)))
        cfg, jcfg = small(get_config(preset)), small(jax_config(preset))
        model = init_weights(PETRDetector(cfg.model), seed=0)
        randomize_bn(model, np.random.RandomState(1))
    batch = {"images": np.zeros((1, cfg.data.num_views, *cfg.data.image_size, 3), np.float32),
             "img2lidar": np.tile(np.eye(4, dtype=np.float32), (1, cfg.data.num_views, 1, 1)),
             "img_hw": np.full((1, cfg.data.num_views, 2), cfg.data.image_size, np.float32)}
    want = _flat(jax.tree.map(np.asarray, jax_fold(to_jax(model, jcfg, batch))))
    folded = fold_frozen_bn(model.state_dict())
    changed = [k for k, v in model.state_dict().items() if not torch.equal(v, folded[k])]
    twin = PETRDetector(cfg.model)
    twin.load_state_dict(folded)
    got = _flat(jax.tree.map(np.asarray, to_jax(twin, jcfg, batch)))
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)
    assert len(changed) > (100 if preset == "tiny_debug" else 200)
    assert not any("conv_offset" in k or k.endswith("conv2.weight") and "layer3" in k for k in changed)


def test_folded_detector_matches_unfolded(tiny):
    """Folding keeps the forward within fp32 rounding (the BN still divides by
    sqrt(1 + eps), as petr_tpu's), and ``cli.test --fuse-conv-bn`` runs it."""
    twin = PETRDetector(tiny.cfg.model).eval()
    twin.load_state_dict(fold_frozen_bn(tiny.model.state_dict()))
    b = tiny.batches[0]
    with torch.no_grad():
        got = twin(*[torch.from_numpy(b[k]) for k in KEYS])
        want = tiny.model(*[torch.from_numpy(b[k]) for k in KEYS])
    for k in ("cls_logits", "bbox_codes"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-3, atol=2e-3, err_msg=k)


# --------------------------------------------------------------------- CLI
def test_cli_quantize_synthetic_matches_petr_tpu(tmp_path):
    """``cli.quantize --synthetic`` on the CPU: petr_tpu's synthetic batches
    (``__graft_entry__._batch``'s images and cameras, drawn by the port's own
    code) and petr_tpu's calibration of the same weights, leaf for leaf."""
    cfg, jcfg = get_config("tiny_debug"), jax_tiny()
    N, (H, W) = cfg.data.num_views, cfg.data.image_size
    for s in range(2):
        mine, theirs = cli_quantize.synthetic_batch(cfg, 1, s), ge._batch(1, N, H, W, 4, seed=s)
        for k in KEYS:
            np.testing.assert_array_equal(mine[k], np.asarray(theirs[k]), err_msg=k)
    out = str(tmp_path / "scales.npz")
    scales = cli_quantize.main(["--config", "tiny_debug", "--synthetic", "--num-batches", "2", "--out", out,
                                "--device", "cpu"])
    model = init_weights(PETRDetector(cfg.model), seed=0).eval()  # what the CLI draws without --ckpt
    batches = [cli_quantize.synthetic_batch(cfg, 1, s) for s in range(2)]
    want = _flat(jax.tree.map(np.asarray, jax_calibrate(jcfg, to_jax(model, jcfg, batches[0]), batches)))
    got = _flat(load_scales(out))
    assert sorted(got) == sorted(want) == sorted(_flat(scales))
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=2e-6, err_msg=key)
