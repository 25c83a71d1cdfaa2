"""The port's small modules against petr_tpu on the CPU: rotated IoU and
BEV NMS, the learned 3D positional encoding, NormedLinear and the normed
ClsBranch, and GridMask's float mode.

Inputs come from seeded numpy and go to both packages; weights cross
through ``utils.convert.state_dict_from_jax``, which raises on any leaf it
cannot place and any port key it leaves unfilled. Tolerances: ``iou3d`` is
the same float64 host arithmetic, so it must match bit for bit; the
positional encoding is a concatenation of the carried tables, exact;
NormedLinear and the branch in fp32 within 1e-5 (outputs) and 1e-5
relative to the largest entry (input gradients: both sum in fp32, in other
orders); the float GridMask masks exactly, given the same drawn parameters.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petr_tpu.models.grid_mask import grid_mask as jax_grid_mask
from petr_tpu.models.petr_head import ClsBranch as JClsBranch
from petr_tpu.models.petr_head import NormedLinear as JNormedLinear
from petr_tpu.models.positional import LearnedPositionalEncoding3D as JPE
from petr_tpu.ops import iou3d as jiou
from petr_tpu_torch.models.grid_mask import FloatGridParams, draw_grid_params, float_masks, grid_mask
from petr_tpu_torch.models.petr_head import FOCAL_PRIOR_BIAS, ClsBranch, NormedLinear
from petr_tpu_torch.models.positional import LearnedPositionalEncoding3D
from petr_tpu_torch.ops import iou3d
from petr_tpu_torch.utils import state_dict_from_jax

OUT_TOL = 1e-5
GRAD_RTOL = 1e-5


def _boxes(rng, n):
    boxes = np.concatenate([rng.uniform(-3, 3, (n, 3)), rng.uniform(0.5, 4, (n, 3)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    boxes[1] = boxes[0]  # identical boxes
    boxes[2, 6] = boxes[0, 6] + np.pi / 2  # a quarter turn of one
    boxes[2, :6] = boxes[0, :6]
    boxes[3, :2] = boxes[0, :2] + 50.0  # far from every other
    return boxes


# ------------------------------------------------------------------- iou3d
@pytest.mark.parametrize("fn", ["bev_iou", "iou_3d"])
def test_iou_matches_bit_for_bit(fn):
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 12), _boxes(rng, 9)
    got, want = getattr(iou3d, fn)(a, b), getattr(jiou, fn)(a, b)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert 0.0 < got.max() <= 1.0 + 1e-12 and got.min() == 0.0


def test_bev_overlap_matches_bit_for_bit():
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 10)
    for i in range(10):
        for j in range(10):
            assert iou3d.bev_overlap(boxes[i], boxes[j]) == jiou.bev_overlap(boxes[i], boxes[j])
    np.testing.assert_allclose(iou3d.bev_overlap(boxes[0], boxes[1]), boxes[0, 3] * boxes[0, 4], rtol=1e-12)


@pytest.mark.parametrize("thr,max_out", [(0.5, 500), (0.1, 500), (0.5, 3)])
def test_nms_bev_matches(thr, max_out):
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, 30)
    scores = rng.rand(30)
    got = iou3d.nms_bev(boxes, scores, thr, max_out)
    want = jiou.nms_bev(boxes, scores, thr, max_out)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert len(got) <= max_out and len(set(got.tolist())) == len(got)


# ------------------------------------------------------ learned positional
def test_learned_pe_matches():
    masks = np.zeros((2, 3, 5, 7), bool)
    jmod = JPE(num_feats=16, row_num_embed=8, col_num_embed=9, cam_num_embed=4)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(masks))["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(masks)))
    model = LearnedPositionalEncoding3D(16, 8, 9, 4)
    model.load_state_dict(state_dict_from_jax(params, model))
    got = model(torch.from_numpy(masks))
    assert got.shape == (2, 3, 5, 7, 48)
    np.testing.assert_array_equal(got.detach().numpy(), want)


def test_learned_pe_draws_uniform_like_petr_tpu():
    """U[0, 1), flax's ``uniform(1.0)``, not nn.Embedding's N(0, 1)."""
    torch.manual_seed(0)
    model = LearnedPositionalEncoding3D()
    jparams = JPE().init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 4, 4), bool))["params"]
    for name in ("row_embed", "col_embed", "cam_embed"):
        got, want = getattr(model, name).detach().numpy(), np.asarray(jparams[name])
        assert got.shape == want.shape
        for x in (got, want):
            assert x.min() >= 0.0 and x.max() < 1.0
            np.testing.assert_allclose(x.mean(), 0.5, atol=0.03)
            np.testing.assert_allclose(x.std(), 1.0 / math.sqrt(12.0), rtol=0.05)


# ------------------------------------------------------------- NormedLinear
def _grad_close(got, want, what):
    err = np.abs(got - want).max()
    assert err <= GRAD_RTOL * np.abs(want).max(), f"{what}: {err:.3e}"


@pytest.mark.parametrize("normed_branch", [False, True], ids=["normed_linear", "cls_branch_normed"])
def test_normed_classifier_matches(normed_branch):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 32).astype(np.float32)
    if normed_branch:
        jmod, model = JClsBranch(32, 2, 10, normed=True), ClsBranch(32, 2, 10, normed=True)
    else:
        jmod, model = JNormedLinear(10), NormedLinear(32, 10)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    model.load_state_dict(state_dict_from_jax(params, model))
    want, vjp = jax.vjp(lambda v: jmod.apply({"params": params}, v), jnp.asarray(x))
    cot = rng.randn(*want.shape).astype(np.float32)
    (jgrad,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = model(xt)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=OUT_TOL, rtol=OUT_TOL)
    _grad_close(xt.grad.numpy(), np.asarray(jgrad), "dx")
    with torch.no_grad():  # a zero feature: eps keeps it finite (its norm's gradient is not)
        zero = model(torch.zeros(1, 32)).numpy()
    np.testing.assert_allclose(zero, np.asarray(jmod.apply({"params": params}, jnp.zeros((1, 32)))), atol=OUT_TOL)
    assert np.isfinite(zero).all()


def test_normed_branch_init_holds_the_focal_prior():
    jparams = JClsBranch(32, 2, 10, normed=True).init(jax.random.PRNGKey(0), jnp.zeros((1, 32)))["params"]
    model = ClsBranch(32, 2, 10, normed=True)
    assert isinstance(model[-1], NormedLinear) and model[-1].tempearture == 20.0 and model[-1].eps == 1e-6
    np.testing.assert_array_equal(model[-1].bias.detach().numpy(), np.full(10, FOCAL_PRIOR_BIAS, np.float32))
    np.testing.assert_array_equal(np.asarray(jparams["out"]["bias"]), model[-1].bias.detach().numpy())
    bound = 1.0 / math.sqrt(32)  # torch's default kernel, petr_tpu's torch_kernel_init
    assert np.abs(model[-1].weight.detach().numpy()).max() <= bound
    assert np.abs(np.asarray(jparams["out"]["kernel"])).max() <= bound


# ------------------------------------------------------- float GridMask
def jax_float_draws(rng, B, H, ratio=0.5, max_angle_deg=0.0):
    """The parameters petr_tpu's float GridMask draws from ``rng``
    (`grid_mask.py:74-81`), as FloatGridParams."""
    k_apply, k_d, k_off, k_ang = jax.random.split(rng, 4)
    apply = jax.random.uniform(k_apply, (B,)) < 0.7
    d = jax.random.uniform(k_d, (B,), minval=2.0, maxval=float(H))
    keep = jnp.maximum(jnp.minimum(jnp.round(d * ratio), d - 1.0), 1.0)
    off = jax.random.uniform(k_off, (B, 2)) * d[:, None]
    ang = jax.random.uniform(k_ang, (B,), minval=0.0, maxval=max_angle_deg) * (jnp.pi / 180.0)
    return FloatGridParams(*(torch.from_numpy(np.array(a)) for a in (apply, d, keep, off, ang)))


@pytest.mark.parametrize("H,W,angle", [(32, 80, 0.0), (37, 61, 0.0), (37, 61, 30.0), (320, 800, 0.0)])
def test_float_masks_match_petr_tpu(H, W, angle):
    B, N = 6, 2
    for seed in range(3):
        rng = jax.random.PRNGKey(seed)
        images = np.random.RandomState(seed).randn(B, N, H, W, 3).astype(np.float32)
        want = np.asarray(jax_grid_mask(rng, jnp.asarray(images), exact=False, max_angle_deg=angle))
        got = grid_mask(torch.from_numpy(images), jax_float_draws(rng, B, H, max_angle_deg=angle))
        np.testing.assert_array_equal(got.numpy(), want)


def test_float_draws_and_zero_fraction():
    gen = torch.Generator().manual_seed(0)
    H = W = 96
    p = draw_grid_params(gen, H, exact=False, batch=400)
    assert p.d.shape == p.keep.shape == p.ang.shape == (400,) and p.off.shape == (400, 2)
    assert (p.d >= 2.0).all() and (p.d < H).all()
    assert (p.keep >= 1.0).all() and (p.keep <= torch.clamp(p.d - 1.0, min=1.0)).all()
    assert torch.equal(p.keep, torch.clamp(torch.minimum(torch.round(p.d * 0.5), p.d - 1.0), min=1.0))
    assert (p.off >= 0.0).all() and (p.off < p.d[:, None]).all() and (p.ang == 0.0).all()
    assert 0.63 < p.apply.float().mean() < 0.77  # Bernoulli(0.7)
    masks = float_masks(H, W, p.d, p.keep, p.off, p.ang)
    zeros = 1.0 - masks.mean().item()
    assert abs(zeros - (1 - 0.5) ** 2) < 0.02, zeros  # both bands kept about half the time
