"""K5's plain version and ConvBNReLU's opt-in route against petr_tpu, on the CPU.

``conv3x3_bn_relu`` (the port's fused conv3x3 + folded BN + ReLU, which
runs its plain version on CPU tensors) against petr_tpu's Pallas kernel in
interpret mode and its ``_xla_reference``; its gradients against
``jax.vjp``; ``ConvBNReLU`` with ``PETR_TPU_TORCH_CONV_IMPL=cuda`` against
petr_tpu's ``ConvBNReLU`` with ``PETR_TPU_CONV_IMPL=pallas`` (interpret
mode, as `tests/test_pallas_conv.py` runs it); the switch's refusal of an
unknown value; and the number of convs the route takes in a V-99 forward,
which ``chip_smoke.py`` expects as K5's launches. Inputs are seeded numpy
arrays in petr_tpu's NHWC layout, transposed for the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from petr_tpu.models.layers import ConvBNReLU as JConvBNReLU
from petr_tpu.ops.pallas.conv3x3 import _xla_reference
from petr_tpu.ops.pallas.conv3x3 import conv3x3_bn_relu as jax_conv3x3
from petr_tpu_torch.models import layers
from petr_tpu_torch.models.layers import ConvBNReLU
from petr_tpu_torch.models.vovnet import VoVNet
from petr_tpu_torch.ops import conv3x3
from petr_tpu_torch.ops.conv3x3 import conv3x3_bn_relu, conv3x3_bn_relu_reference

ENV = "PETR_TPU_TORCH_CONV_IMPL"


def case(dtype, B=2, H=10, W=24, C=16, Co=24, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, Co) * (2.0 / (9 * C)) ** 0.5).astype(np.float32)
    mul = rng.uniform(0.5, 1.5, Co).astype(np.float32)
    add = rng.normal(0.0, 0.3, Co).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jw = jnp.asarray(w).astype(dtype)
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(getattr(torch, dtype))
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(getattr(torch, dtype))
    return (jx, jw, jnp.asarray(mul), jnp.asarray(add)), (tx, tw, torch.from_numpy(mul), torch.from_numpy(add))


def nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_version_matches_pallas_kernel_and_xla_reference(dtype, affine, relu):
    (jx, jw, jm, ja), (tx, tw, tm, ta) = case(dtype, seed=int(affine) + 2 * int(relu))
    if not affine:
        jm = ja = tm = ta = None
    got = nhwc(conv3x3_bn_relu(tx, tw, tm, ta, relu))
    assert conv3x3_bn_relu(tx, tw, tm, ta, relu).dtype == tx.dtype
    xla = np.asarray(_xla_reference(jx, jw, jm, ja, relu).astype(jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_conv3x3(jx, jw, jm, ja, relu).astype(jnp.float32))
    scale = np.abs(xla).max()
    if dtype == "float32":
        # fp32 sums in other orders: within 1e-5 of the largest output
        for want in (xla, pallas):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        # the same bf16 products summed in fp32 and rounded once: the sums
        # differ in their last fp32 bits, which may round to neighbouring
        # bf16 values, one step (2^-8 relative) apart, on a few outputs
        for want in (xla, pallas):
            np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6 * scale)
            assert np.mean(got != want) < 0.02
    if relu:
        assert (got >= 0).all()


def test_gradients_match_jax_vjp():
    (jx, jw, jm, ja), (tx, tw, tm, ta) = case("float32", B=1, H=6, W=9, C=8, Co=8, seed=5)
    g = np.random.RandomState(6).randn(1, 6, 9, 8).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _xla_reference(*a, True), jx, jw, jm, ja)
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    ins = [t.clone().requires_grad_() for t in (tx, tw, tm, ta)]
    conv3x3_bn_relu(*ins, True).backward(torch.from_numpy(g.transpose(0, 3, 1, 2).copy()))
    got = [nhwc(ins[0].grad), ins[1].grad.numpy().transpose(2, 3, 1, 0), ins[2].grad.numpy(), ins[3].grad.numpy()]
    for name, a, b in zip(("x", "weight", "mul", "add"), got, want):
        # fp32 autograd of the same function: 1e-5 of each gradient's largest entry
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(), err_msg=name)


def _port_block(jparams, C, Co, relu):
    block = ConvBNReLU("b", C, Co, kernel=3, stride=1, relu=relu)
    conv, bn = jparams["conv"], jparams["bn"]
    with torch.no_grad():
        block[0].weight.copy_(torch.from_numpy(np.array(conv["kernel"]).transpose(3, 2, 0, 1).copy()))
        for leaf, name in (("scale", "weight"), ("bias", "bias")):
            getattr(block[1], name).copy_(torch.from_numpy(np.array(bn[leaf])))
        block[1].running_mean.copy_(torch.from_numpy(np.array(bn["mean"])))
        block[1].running_var.copy_(torch.from_numpy(np.array(bn["var"])))
    return block


@pytest.mark.parametrize("relu", [True, False])
def test_convbnrelu_route_matches_petr_tpu_pallas_route(monkeypatch, relu):
    rng = np.random.RandomState(7)
    C, Co = 8, 16
    x = rng.randn(2, 8, 12, C).astype(np.float32)
    jm = JConvBNReLU(Co, 3, relu=relu, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(np.asarray, params)
    params["bn"] = {"scale": rng.normal(1.0, 0.2, Co), "bias": rng.normal(0, 0.2, Co),
                    "mean": rng.normal(0, 0.5, Co), "var": rng.uniform(0.5, 2.0, Co)}
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    monkeypatch.setenv("PETR_TPU_CONV_IMPL", "pallas")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    block = _port_block(params, C, Co, relu)
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    routed = []
    monkeypatch.setattr(layers, "conv3x3_bn_relu", lambda *a, **k: routed.append(1) or conv3x3_bn_relu(*a, **k))
    monkeypatch.setenv(ENV, "cuda")
    with torch.no_grad():
        got = nhwc(block(tx))
    assert routed == [1]
    monkeypatch.setenv(ENV, "cudnn")
    with torch.no_grad():
        default = nhwc(block(tx))
    assert routed == [1]
    # fp32 both ways: within 1e-5 of the largest output
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(default, got, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("value", ["pallas", "CUDA", ""])
def test_unknown_switch_value_raises(monkeypatch, value):
    block = ConvBNReLU("b", 4, 4)
    monkeypatch.setenv(ENV, value)
    with pytest.raises(ValueError, match=ENV):
        block(torch.zeros(1, 4, 5, 5))
    with pytest.raises(ValueError, match=ENV):
        conv3x3.conv_impl()


def test_route_takes_the_80_osa_convs_of_v99(monkeypatch):
    """V-99-eSE has 16 OSA blocks of 5 stride-1 3x3 convs; the stem's convs
    (a flat Sequential, not ConvBNReLU modules) and the 1x1 concat convs
    stay on cuDNN. So K5 launches 80 times per forward on the route."""
    routed = []
    monkeypatch.setattr(layers, "conv3x3_bn_relu", lambda *a, **k: routed.append(a[0].shape) or conv3x3_bn_relu(*a, **k))
    monkeypatch.setenv(ENV, "cuda")
    net = VoVNet("V-99-eSE", (2, 3)).eval()
    with torch.no_grad():
        net(torch.zeros(1, 3, 64, 64))
    assert len(routed) == 80
    assert sorted({s[1] for s in routed}) == [128, 160, 192, 224, 256, 512, 768, 1024]


def test_reference_is_the_plain_route_on_cpu():
    _, (tx, tw, tm, ta) = case("bfloat16", seed=9)
    before = conv3x3.LAUNCHES
    torch.testing.assert_close(conv3x3_bn_relu(tx, tw, tm, ta), conv3x3_bn_relu_reference(tx, tw, tm, ta), rtol=0, atol=0)
    assert conv3x3.LAUNCHES == before  # a CPU tensor launches nothing
