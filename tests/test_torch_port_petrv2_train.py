"""The port's PETRv2 train step and streaming runtime against petr_tpu at
tiny_debug_v2 size, on the CPU; and the fixed-order backward of the
bilinear sampler's corner gather.

The train step: ``tiny_debug_v2`` with ``with_multi_reg=True`` (the
flagship's RegLayer), fp32, dropout 0 and no GridMask on both sides, flash
attention on (petr_tpu's Pallas kernels in interpret mode, the port's plain
versions), remat as the preset says, a batch of 2 with timestamps. One set
of weights serves both: the port's seeded model goes to a petr_tpu tree
through petr_tpu's checkpoint converter. Checked as
`tests/test_torch_port_train.py` checks the flagship's step, with its
tolerances: the losses (rtol 2e-5), every gradient through
``named_parameters_from_jax`` (1e-4 of its largest entry, but the
backbone's: see ``test_every_gradient_matches``), the parameters after one
AdamW update (a hundredth of the learning rate; 2 lr where the clipped
gradient is near Adam's eps).

Streaming: fp32 within atol 1e-4 (rtol 1e-4 for JAX, as
`tests/test_streaming.py`). The pose helpers: fp64, rtol 1e-12.
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
from petr_tpu.serve.streaming import StreamingPETRv2 as JStreaming
from petr_tpu.serve.streaming import align_prev_lidar2img as jax_align
from petr_tpu.serve.streaming import lidar2global as jax_lidar2global
from petr_tpu.serve.streaming import self_padded_timestamp as jax_self_padded
from petr_tpu.train.optim import build_optimizer as jax_build_optimizer
from petr_tpu.train.train_step import TrainState as JTrainState
from petr_tpu.train.train_step import make_grad_fn as jax_make_grad_fn
from petr_tpu.utils.torch_convert import convert_state_dict
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.models import PETRDetector, init_weights
from petr_tpu_torch.models.grid_mask import GridParams, grid_mask
from petr_tpu_torch.models.layers import FrozenBatchNorm
from petr_tpu_torch.ops.sampling import bilinear_sample_batched, gather_rows, sum_into_rows_sorted
from petr_tpu_torch.serve import StreamingPETRv2, align_prev_lidar2img, lidar2global, self_padded_timestamp
from petr_tpu_torch.train import BATCH_KEYS, batch_keys, create_train_state, make_grad_fn, make_train_step
from petr_tpu_torch.utils import named_parameters_from_jax
from tests.test_heads import make_cams

TOTAL_STEPS = 100
KEYS = ("images", "img2lidar", "img_hw", "timestamp")


def _train_config(cfg):
    head = dataclasses.replace(cfg.model.head, dropout_rate=0.0, with_multi_reg=True)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, head=head, use_grid_mask=False))


def _to_jax(model, jcfg, batch):
    port_sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    jmodel = JDetector(jcfg.model, deterministic=True)
    one = [jnp.asarray(batch[k][:1]) for k in KEYS]
    shapes = jax.eval_shape(lambda i, c, h, t: jmodel.init(jax.random.PRNGKey(0), i, c, h, timestamp=t), *one)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
    params, stats = convert_state_dict(port_sd, zeros, shared_branches=False)
    assert stats["skipped"] == 0 and stats["unfilled"] == 0, stats
    return port_sd, jmodel, jax.tree.map(jnp.asarray, params)


@pytest.fixture(scope="module")
def run():
    jcfg, cfg = _train_config(jax_config("tiny_debug_v2")), _train_config(get_config("tiny_debug_v2"))
    assert cfg.model.use_flash_attention and cfg.model.remat and cfg.model.compute_dtype == "float32"
    assert cfg.train.optim.code_weights == (1.0,) * 10  # v2's, read from the port's config copy
    assert batch_keys(cfg) == BATCH_KEYS + ("timestamp",)
    N, (H, W), G = cfg.data.num_views * cfg.data.num_frames, cfg.data.image_size, cfg.data.max_gt
    B = 2
    rng = np.random.RandomState(0)
    valid = np.zeros((B, G), bool)
    valid[0, rng.permutation(G)[:5]] = True
    valid[1, rng.permutation(G)[:9]] = True
    boxes = np.concatenate([
        rng.uniform(-40, 40, (B, G, 2)), rng.uniform(-4, 2, (B, G, 1)), rng.uniform(0.5, 4, (B, G, 3)),
        rng.uniform(-np.pi, np.pi, (B, G, 1)), rng.uniform(-3, 3, (B, G, 2)),
    ], -1).astype(np.float32)
    boxes[~valid] = 0.0
    cur = rng.uniform(-0.02, 0.02, (B, 6))
    batch = {
        "images": rng.randn(B, N, H, W, 3).astype(np.float32),
        "img2lidar": make_cams(B, N, seed=1),
        "img_hw": np.tile(np.array([H, W], np.float32), (B, N, 1)),
        "timestamp": np.concatenate([cur, cur + [[0.5], [0.4]]], 1).astype(np.float32),
        "gt_boxes": boxes,
        "gt_labels": np.where(valid, rng.randint(0, 10, (B, G)), 0).astype(np.int32),
        "gt_valid": valid,
    }
    batch["img_hw"][1, 8] = [16, 48]  # a padded previous-frame view

    state = create_train_state(cfg, seed=0, total_steps=TOTAL_STEPS, device="cpu")
    with torch.no_grad():
        for m in state.model.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))
    port_sd, _, params = _to_jax(state.model, jcfg, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    total, losses, grads, _ = jax.jit(jax_make_grad_fn(jcfg))(params, jb, jax.random.PRNGKey(1))
    tx = jax_build_optimizer(jcfg.train.optim, TOTAL_STEPS, params,
                             freeze_backbone_bn_affine=not jcfg.model.backbone.train_bn_affine)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params), tx=tx)
    new_params = jax.jit(lambda s, g: s.apply_gradients(g).params)(jstate, grads)
    return types.SimpleNamespace(
        cfg=cfg, batch=batch, model=state.model, port_sd=port_sd,
        jax=types.SimpleNamespace(total=float(total), losses={k: float(v) for k, v in losses.items()},
                                  grads=jax.device_get(grads), new_params=jax.device_get(new_params)),
        port=make_grad_fn(cfg)(state.model, batch, torch.Generator().manual_seed(0)),
    )


# --------------------------------------------------------------- train step
def test_losses_match(run):
    _, losses, _, _, _ = run.port
    assert set(losses) == set(run.jax.losses)
    for k, want in run.jax.losses.items():  # fp32 sums in other orders
        np.testing.assert_allclose(losses[k].item(), want, rtol=2e-5, err_msg=k)
    np.testing.assert_allclose(run.port[0].item(), run.jax.total, rtol=2e-5)


def test_every_gradient_matches(run):
    _, _, grads, _, _ = run.port
    want = named_parameters_from_jax(run.jax.grads, run.model)
    assert set(grads) == set(want)
    L = run.cfg.model.head.num_layers
    for kind in ("cls", "reg"):  # every layer's own branch has its own gradient
        assert sum(f".{kind}_branches.{i}." in n for n in grads for i in range(L)) > L
    # fp32 through the V-39 backbone over 12 views: the head's and the
    # neck's gradients and the backbone's last stages agree within 1e-6 of
    # their largest entry (median over all parameters 4e-7), as the flagship
    # test's do. Below stage 4 the two packages' fp32 sums switch a ReLU or
    # two, and every earlier gradient then moves by ~1e-4 (measured 2.4e-4
    # at the stem); a one-ulp nudge of the images alone moves the stem's
    # gradients by 6e-3 of their largest entry. So the backbone is held to
    # 1e-3, everything else to 1e-4, and the median to 1e-5. Where the exact
    # gradient is 0 (the PE MLPs' last biases; the velocity group of a layer
    # whose matched signs cancel) both give ~2e-9 of noise.
    rel = {}
    for name, g in grads.items():
        w = want[name]
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        rtol = 1e-3 if name.startswith("img_backbone.") else 1e-4
        assert err <= rtol * scale + 1e-8, f"{name}: max abs err {err:.3e}, max |grad| {scale:.3e}"
        rel[name] = err / max(scale, 1e-30)
    assert np.median(list(rel.values())) <= 1e-5


def test_one_update_matches(run):
    state = create_train_state(run.cfg, seed=0, total_steps=TOTAL_STEPS, device="cpu")
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in run.port_sd.items()})
    state, metrics = make_train_step(run.cfg)(state, run.batch, torch.Generator().manual_seed(0))
    assert metrics["skipped"] == 0 and state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), run.jax.total, rtol=2e-5)
    jgrads = named_parameters_from_jax(run.jax.grads, run.model)
    want_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in jgrads.values()]))
    np.testing.assert_allclose(metrics["grad_norm"].item(), want_norm.item(), rtol=1e-4)
    want = named_parameters_from_jax(run.jax.new_params, state.model)
    before = {k: torch.from_numpy(v) for k, v in run.port_sd.items()}
    lr0 = state.lr_schedule(0)
    clip = min(1.0, run.cfg.train.optim.grad_clip_norm / want_norm.item())
    for name, p in state.model.named_parameters():
        near_eps = (jgrads[name] * clip).abs() < 1e-6
        bound = torch.where(near_eps, 2.0 * lr0, 1e-2 * lr0) + 1e-6 * before[name].abs()
        err = (p.detach() - want[name]).abs()
        assert (err <= bound).all(), f"{name}: {err.max().item():.3e}"


def test_the_step_needs_its_timestamps(run):
    batch = {k: v for k, v in run.batch.items() if k != "timestamp"}
    with pytest.raises(KeyError, match="timestamp"):
        make_grad_fn(run.cfg)(run.model, batch, torch.Generator().manual_seed(0))


def test_create_train_state_pins_cudnn_determinism():
    kept = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = False
        create_train_state(get_config("tiny_debug_v2"), seed=0, total_steps=TOTAL_STEPS, device="cpu")
        assert torch.backends.cudnn.deterministic
    finally:
        torch.backends.cudnn.deterministic = kept


def test_grid_mask_covers_all_twelve_views():
    images = torch.ones(2, 12, 32, 80, 3)
    out = grid_mask(images, GridParams(apply=True, d=7, st_h=2, st_w=3))
    assert 0 < out.mean().item() < 1
    for view in range(12):
        assert torch.equal(out[:, view], out[0, 0].expand_as(out[:, view]))


# ---------------------------------------------------------------- streaming
@pytest.fixture(scope="module")
def stream():
    """tiny_debug_v2 as served (eval config, fp32) in both packages, and two
    frames of 6 views."""
    jcfg, cfg = jax_config("tiny_debug_v2"), get_config("tiny_debug_v2")
    model = init_weights(PETRDetector(cfg.model), seed=3).eval()
    H, W = cfg.data.image_size
    rng = np.random.RandomState(4)
    frames = [(rng.randn(1, 6, H, W, 3).astype(np.float32), make_cams(1, 6, seed=5 + i),
               np.tile(np.array([H, W], np.float32), (1, 6, 1))) for i in range(2)]
    ts12 = np.concatenate([np.zeros((1, 6)), np.full((1, 6), 0.5)], 1).astype(np.float32)
    one = {"images": np.zeros((1, 12, H, W, 3), np.float32), "img2lidar": make_cams(1, 12, seed=7),
           "img_hw": np.tile(np.array([H, W], np.float32), (1, 12, 1)), "timestamp": ts12}
    _, jmodel, params = _to_jax(model, jcfg, one)
    return types.SimpleNamespace(cfg=cfg, jcfg=jcfg, model=model, jmodel=jmodel, params=params, frames=frames,
                                 ts12=ts12)


def _twelve(cur, prev):
    return [np.concatenate([c, p], 1) for c, p in zip(cur, prev)]


def test_streaming_matches_its_own_full_forward(stream):
    """Frame 0 self-padded (prev := current), frame 1 on the cached
    features: each equals the full 12-view forward over (current, previous)."""
    (img_a, i2l_a, hw_a), (img_b, i2l_b, hw_b) = stream.frames
    s = StreamingPETRv2(stream.cfg, stream.model, decode=False, device="cpu")
    ts0 = self_padded_timestamp(np.zeros((1, 6)))
    inputs = [(img_a, (img_a, i2l_a, hw_a), (img_a, i2l_a, hw_a), ts0),
              (img_b, (img_b, i2l_b, hw_b), (img_a, i2l_a, hw_a), stream.ts12)]
    for frame, (img, cur, prev, ts) in enumerate(inputs):
        images12, i2l12, hw12 = _twelve(cur, prev)
        out = s.step(img, i2l12, hw12, ts)
        with torch.no_grad():
            full = stream.model(*[torch.from_numpy(a) for a in (images12, i2l12, hw12)],
                                timestamp=torch.as_tensor(ts, dtype=torch.float32))
        for k in ("cls_logits", "bbox_codes"):
            np.testing.assert_allclose(out[k].numpy(), full[k].numpy(), atol=1e-4, rtol=0,
                                       err_msg=f"frame {frame} {k}")
    s.reset()
    assert s._prev_feats is None
    with pytest.raises(ValueError, match="6 views"):
        s.step(np.zeros((1, 12) + img_a.shape[2:], np.float32), i2l12, hw12, ts)
    with pytest.raises(KeyError, match="missing"):  # scales that name no conv of the backbone
        StreamingPETRv2(stream.cfg, stream.model, quant_scales={}, device="cpu")


def test_streaming_matches_jax_streaming(stream):
    """Primed with a previous sweep, then two frames, decoded and raw."""
    (img_a, i2l_a, hw_a), (img_b, i2l_b, hw_b) = stream.frames
    prev = np.random.RandomState(6).randn(*img_a.shape).astype(np.float32)
    for decode in (False, True):
        ours = StreamingPETRv2(stream.cfg, stream.model, decode=decode, device="cpu")
        theirs = JStreaming(stream.jcfg, stream.params, decode=decode)
        ours.prime(prev)
        theirs.prime(prev)
        for frame, (img, cur, pr) in enumerate([(img_a, (i2l_a, hw_a), (i2l_b, hw_b)),
                                                (img_b, (i2l_b, hw_b), (i2l_a, hw_a))]):
            i2l12, hw12 = np.concatenate([cur[0], pr[0]], 1), np.concatenate([cur[1], pr[1]], 1)
            got = ours.step(img, i2l12, hw12, stream.ts12)
            want = theirs.step(img, i2l12, hw12, stream.ts12)
            if decode:
                scores = np.asarray(want["scores"])[0]
                np.testing.assert_allclose(got["scores"].numpy()[0], scores, atol=1e-6)
                # random weights give scores ~1e-7 apart; logits within ~1e-6
                # give scores within ~2e-8, so only closer ranks may trade places
                keep = np.ones_like(scores, bool)
                keep[1:] &= (scores[:-1] - scores[1:]) > 1e-7
                keep[:-1] &= (scores[:-1] - scores[1:]) > 1e-7
                assert keep.sum() > 50, keep.sum()
                np.testing.assert_allclose(got["boxes"].numpy()[0][keep], np.asarray(want["boxes"])[0][keep],
                                           atol=2e-3, rtol=1e-3)
                np.testing.assert_array_equal(got["labels"].numpy()[0][keep], np.asarray(want["labels"])[0][keep])
                continue
            for k in ("cls_logits", "bbox_codes"):
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4,
                                           err_msg=f"frame {frame} {k}")


def test_pose_helpers_match_jax():
    rng = np.random.RandomState(11)

    def pose():
        a = rng.uniform(-np.pi, np.pi)
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        return R, rng.uniform(-30, 30, 3)

    (r1, t1), (r2, t2), (r3, t3), (r4, t4) = pose(), pose(), pose(), pose()
    got, want = lidar2global(r1, t1, r2, t2), jax_lidar2global(r1, t1, r2, t2)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    prev_l2g, cur_l2g = lidar2global(r1, t1, r2, t2), lidar2global(r3, t3, r4, t4)
    l2i = rng.randn(2, 6, 4, 4)
    np.testing.assert_allclose(align_prev_lidar2img(l2i, prev_l2g, cur_l2g), jax_align(l2i, prev_l2g, cur_l2g),
                               rtol=1e-12, atol=1e-12)
    ts6 = rng.uniform(-0.05, 0.05, (3, 6))
    np.testing.assert_array_equal(self_padded_timestamp(ts6), jax_self_padded(ts6))
    np.testing.assert_array_equal(self_padded_timestamp(ts6, (0, 3)), jax_self_padded(ts6, (0, 3)))


# ------------------------------------------- the corner gather's backward
def test_gather_rows_backward_equals_torch_gather_exactly():
    """fp64, values on a 1/8 grid so that every sum is exact in any order;
    rows read many times, never, and at both ends."""
    rng = np.random.RandomState(12)
    B, R, C, P = 3, 17, 5, 200
    flat = torch.from_numpy(rng.randn(B, R, C)).requires_grad_()
    idx = torch.from_numpy(rng.randint(0, R, (B, P)))
    idx[0, :50] = 4  # one row read 50 times
    idx[1, :] = torch.from_numpy(rng.choice([0, R - 1], P))  # only the first and last rows
    grad = torch.from_numpy(np.round(rng.randn(B, P, C) * 8) / 8)
    got_out = gather_rows(flat, idx)
    want_out = torch.gather(flat, 1, idx[..., None].expand(B, P, C))
    assert torch.equal(got_out, want_out)
    (got,) = torch.autograd.grad(got_out, flat, grad)
    (want,) = torch.autograd.grad(want_out, flat, grad)
    assert torch.equal(got, want)
    # the CUDA backward's row sums, run here: exact values, so any order
    assert torch.equal(sum_into_rows_sorted(torch.zeros(B, R, C, dtype=torch.float64), idx, grad), want)


def test_bilinear_sample_backward_equals_torch_gather_exactly():
    """The sampler with points out of the plane and repeated corners: its
    gradients equal those through ``torch.gather``, exactly, in fp64."""
    import petr_tpu_torch.ops.sampling as sampling

    rng = np.random.RandomState(13)
    feat = torch.from_numpy(rng.randn(2, 6, 7, 3)).requires_grad_()
    xy = rng.uniform(-2.5, 8.5, (2, 40, 9, 2))
    xy[:, :10] = xy[:, :1]  # ten points at one place: the same four corners ten times
    xy[0, 10] = [-0.5, -0.5]  # three corners outside the plane
    xy = torch.from_numpy(np.round(xy * 4) / 4)  # bilinear weights on a 1/4 grid
    grad = torch.from_numpy(np.round(rng.randn(2, 40, 9, 3) * 8) / 8)
    (got,) = torch.autograd.grad(bilinear_sample_batched(feat, xy), feat, grad)
    plain = sampling.gather_rows
    try:
        sampling.gather_rows = lambda f, i: torch.gather(f, 1, i[..., None].expand(*i.shape, f.shape[2]))
        (want,) = torch.autograd.grad(bilinear_sample_batched(feat, xy), feat, grad)
    finally:
        sampling.gather_rows = plain
    assert torch.equal(got, want)
