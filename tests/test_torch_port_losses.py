"""The port's losses, matcher, GridMask, LR schedule and optimizer against
petr_tpu on the CPU.

Inputs come from seeded numpy and go to both packages. Tolerances: fp32
losses and costs within 1e-5 relative (both sum in fp32, in other orders);
assignments, GridMask masks and the LR schedule's steps exactly or to fp32
rounding; one AdamW step within 1e-6 relative, as
`tests/test_optim_torch_parity.py` holds optax to torch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from petr_tpu.configs import get_config as jax_config
from petr_tpu.configs.config import OptimConfig as JOptimConfig
from petr_tpu.models.grid_mask import exact_mask as jax_exact_mask
from petr_tpu.ops import losses as jl
from petr_tpu.ops.matcher import lap_solve as jax_lap_solve
from petr_tpu.train.losses import _match_single as jax_match_single
from petr_tpu.train.losses import petr_set_loss as jax_set_loss
from petr_tpu.train.optim import build_optimizer as jax_build_optimizer
from petr_tpu.train.optim import make_lr_schedule as jax_schedule
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.configs.config import OptimConfig
from petr_tpu_torch.models.grid_mask import (FloatGridParams, GridParams, draw_grid_params, exact_mask,
                                             float_masks, grid_mask)
from petr_tpu_torch.models.layers import FrozenBatchNorm, Linear
from petr_tpu_torch.ops import losses as tl
from petr_tpu_torch.ops.matcher import hungarian_match, lap_solve
from petr_tpu_torch.train import create_train_state, make_train_step
from petr_tpu_torch.train.losses import _match_single, petr_set_loss
from petr_tpu_torch.train.optim import build_optimizer, clip_by_global_norm, global_norm, make_lr_schedule
from petr_tpu_torch.train.train_step import TrainState

RTOL = 1e-5
t = torch.from_numpy


def _gt(rng, B, G, n_valid):
    boxes = np.concatenate([
        rng.uniform(-30, 30, (B, G, 2)), rng.uniform(-3, 1, (B, G, 1)),
        rng.uniform(0.5, 4, (B, G, 3)), rng.uniform(-np.pi, np.pi, (B, G, 1)),
        rng.uniform(-2, 2, (B, G, 2)),
    ], -1).astype(np.float32)
    labels = rng.randint(0, 10, (B, G)).astype(np.int32)
    valid = np.zeros((B, G), bool)
    for b, n in enumerate(n_valid):
        valid[b, rng.permutation(G)[:n]] = True
    boxes[~valid] = 0.0  # padding rows: log(0) sizes, cleaned by nan_to_num
    return boxes, labels, valid


# ------------------------------------------------------------------ losses
def test_focal_and_l1_losses_match():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 32, 10).astype(np.float32) * 3
    labels = rng.randint(0, 11, (2, 32)).astype(np.int32)  # 10 = background
    weights = rng.rand(2, 32).astype(np.float32)
    for w in (None, weights):
        want = jl.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(labels),
                                     None if w is None else jnp.asarray(w), num_classes=10, avg_factor=3.0)
        got = tl.sigmoid_focal_loss(t(logits), t(labels), None if w is None else t(w), num_classes=10, avg_factor=3.0)
        np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    pred, tgt = rng.randn(2, 32, 10).astype(np.float32), rng.randn(2, 32, 10).astype(np.float32)
    lw = rng.rand(2, 32, 10).astype(np.float32)
    want = jl.weighted_l1_loss(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(lw), avg_factor=7.0)
    got = tl.weighted_l1_loss(t(pred), t(tgt), t(lw), avg_factor=7.0)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_matching_costs_match():
    rng = np.random.RandomState(1)
    logits = rng.randn(32, 10).astype(np.float32) * 3
    gt_labels = rng.randint(0, 10, (16,)).astype(np.int32)
    codes, gt_codes = rng.randn(32, 8).astype(np.float32), rng.randn(16, 8).astype(np.float32)
    np.testing.assert_allclose(
        tl.focal_loss_cost(t(logits), t(gt_labels)).numpy(),
        np.asarray(jl.focal_loss_cost(jnp.asarray(logits), jnp.asarray(gt_labels))), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(
        tl.bbox_l1_cost(t(codes), t(gt_codes)).numpy(),
        np.asarray(jl.bbox_l1_cost(jnp.asarray(codes), jnp.asarray(gt_codes))), rtol=RTOL, atol=1e-6)
    # batched leading axes broadcast as petr_set_loss uses them
    batched = tl.focal_loss_cost(t(np.stack([logits] * 3))[:, None], t(gt_labels)[None])
    assert batched.shape == (3, 1, 32, 16)
    np.testing.assert_allclose(batched[2, 0].numpy(), tl.focal_loss_cost(t(logits), t(gt_labels)).numpy())


# ----------------------------------------------------------------- matcher
@pytest.mark.parametrize("case", ["random", "padded", "zero_gt", "nonfinite"])
def test_lap_solve_matches(case):
    rng = np.random.RandomState({"random": 2, "padded": 3, "zero_gt": 4, "nonfinite": 5}[case])
    G, Q = 16, 32
    cost = rng.rand(G, Q).astype(np.float32) * 10
    valid = np.ones(G, bool)
    if case == "padded":
        valid[rng.permutation(G)[:7]] = False
    elif case == "zero_gt":
        valid[:] = False
    elif case == "nonfinite":
        cost[0, 3], cost[2, 5], cost[4, 9] = np.nan, np.inf, -np.inf
    want = np.asarray(jax.jit(jax_lap_solve)(jnp.asarray(cost), jnp.asarray(valid)))
    got = lap_solve(cost, valid)
    np.testing.assert_array_equal(got[valid], want[valid])
    assert len(set(got[valid])) == valid.sum()
    q_of_g, mv = hungarian_match(cost.T, valid)
    np.testing.assert_array_equal(q_of_g[valid], want[valid])
    np.testing.assert_array_equal(mv, valid)


def test_match_single_matches():
    rng = np.random.RandomState(6)
    Q, G = 32, 16
    boxes, labels, valid = _gt(rng, 1, G, [6])
    from petr_tpu.ops.boxes import encode_bbox as jax_encode

    gt_codes = np.where(valid[0, :, None], np.nan_to_num(np.asarray(jax_encode(jnp.asarray(boxes[0])))), 0.0)
    gt_codes = gt_codes.astype(np.float32)
    logits = rng.randn(Q, 10).astype(np.float32)
    codes = rng.randn(Q, 10).astype(np.float32)
    want = jax_match_single(jnp.asarray(logits), jnp.asarray(codes), jnp.asarray(gt_codes),
                            jnp.asarray(labels[0]), jnp.asarray(valid[0]),
                            num_classes=10, cls_weight=2.0, bbox_weight=0.25)
    got = _match_single(t(logits), t(codes), t(gt_codes), t(labels[0]), t(valid[0]),
                        num_classes=10, cls_weight=2.0, bbox_weight=0.25)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-6)


def _jax_assignment(outputs, boxes, labels, valid, **kw):
    from petr_tpu.ops.boxes import encode_bbox as jax_encode

    gt_codes = np.where(valid[..., None], np.nan_to_num(np.asarray(jax_encode(jnp.asarray(boxes)))), 0.0)
    L, B = outputs["cls_logits"].shape[:2]
    solve = jax.jit(jax_lap_solve)
    out = np.zeros((L, B, boxes.shape[1]), np.int64)
    for lvl in range(L):
        for b in range(B):
            cost = jl.focal_loss_cost(jnp.asarray(outputs["cls_logits"][lvl, b]), jnp.asarray(labels[b])) + \
                jl.bbox_l1_cost(jnp.asarray(outputs["bbox_codes"][lvl, b, :, :8]), jnp.asarray(gt_codes[b, :, :8]))
            out[lvl, b] = np.asarray(solve(cost.T, jnp.asarray(valid[b])))
    return np.where(valid[None], out, 0)


@pytest.mark.parametrize("case", ["random", "zero_gt", "near_ties", "sync_avg"])
def test_set_loss_matches(case):
    rng = np.random.RandomState(7)
    L, B, Q, G = 2, 2, 32, 16
    boxes, labels, valid = _gt(rng, B, G, [0, 0] if case == "zero_gt" else [5, 9])
    logits = rng.randn(L, B, Q, 10).astype(np.float32)
    codes = rng.randn(L, B, Q, 10).astype(np.float32)
    if case == "near_ties":
        # nearly alike queries, as random weights make them: the assignment
        # of the two packages may differ by a last-bit flip, so the loss is
        # compared with petr_tpu's assignment injected
        logits = np.repeat(logits[:, :, :1], Q, 2) + rng.randn(L, B, Q, 10).astype(np.float32) * 1e-6
        codes = np.repeat(codes[:, :, :1], Q, 2) + rng.randn(L, B, Q, 10).astype(np.float32) * 1e-6
    sync = case == "sync_avg"
    outputs = {"cls_logits": logits, "bbox_codes": codes}
    jax_loss = jax.jit(lambda o: jax_set_loss(o, jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid),
                                              sync_cls_avg_factor=sync))
    want_total, want = jax_loss({k: jnp.asarray(v) for k, v in outputs.items()})
    jax_idx = _jax_assignment(outputs, boxes, labels, valid)
    ltl = {k: t(v).requires_grad_() for k, v in outputs.items()}
    total, got, idx = petr_set_loss(ltl, t(boxes), t(labels), t(valid), sync_cls_avg_factor=sync,
                                    indices=jax_idx if case == "near_ties" else None)
    if case != "near_ties":
        np.testing.assert_array_equal(np.where(valid[None], idx, 0), jax_idx)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=RTOL, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(total.item(), float(want_total), rtol=RTOL)
    if case == "random":  # gradients with respect to the head's outputs
        gj = jax.jit(jax.grad(lambda o: jax_loss(o)[0]))({k: jnp.asarray(v) for k, v in outputs.items()})
        total.backward()
        for k in outputs:
            np.testing.assert_allclose(ltl[k].grad.numpy(), np.asarray(gj[k]), rtol=1e-4, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------- GridMask
@pytest.mark.parametrize("H,W,d,st_h,st_w", [(32, 80, 2, 0, 1), (32, 80, 7, 3, 6), (320, 800, 123, 50, 122),
                                              (64, 160, 63, 62, 0)])
def test_exact_mask_matches(H, W, d, st_h, st_w):
    want = np.asarray(jax_exact_mask(H, W, d, st_h, st_w))
    got = exact_mask(H, W, d, st_h, st_w).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.0 < got.mean() < 1.0


def test_grid_mask_draws_and_applies_one_mask():
    gen = torch.Generator().manual_seed(0)
    draws = [draw_grid_params(gen, 32) for _ in range(200)]
    assert all(2 <= p.d < 32 and 0 <= p.st_h < p.d and 0 <= p.st_w < p.d for p in draws)
    assert 0.6 < np.mean([p.apply for p in draws]) < 0.8  # Bernoulli(0.7)
    images = torch.randn(2, 3, 32, 80, 3)
    out = grid_mask(images, GridParams(True, 9, 4, 2))
    mask = exact_mask(32, 80, 9, 4, 2)
    assert torch.equal(out, images * mask[None, None, :, :, None])
    assert torch.equal(grid_mask(images, GridParams(False, 9, 4, 2)), images)
    # the float mode: one gate, period, band, offset pair and angle per sample, from the same generator
    fp = draw_grid_params(gen, 32, exact=False, batch=300)
    assert (fp.d >= 2.0).all() and (fp.d < 32).all() and (fp.off >= 0).all() and (fp.off < fp.d[:, None]).all()
    assert torch.equal(fp.keep, torch.clamp(torch.minimum(torch.round(fp.d * 0.5), fp.d - 1.0), min=1.0))
    assert (fp.ang == 0.0).all() and 0.6 < fp.apply.float().mean() < 0.8  # Bernoulli(0.7)
    out = grid_mask(images, FloatGridParams(torch.tensor([True, False]), fp.d[:2], fp.keep[:2], fp.off[:2],
                                            fp.ang[:2]))
    mask = float_masks(32, 80, fp.d[:1], fp.keep[:1], fp.off[:1], fp.ang[:1])[0]
    assert torch.equal(out[1], images[1]) and torch.equal(out[0], images[0] * mask[None, :, :, None])
    assert 0.0 < mask.mean() < 1.0


# --------------------------------------------------------------- optimizer
def test_lr_schedule_matches():
    for kw in ({}, {"warmup_iters": 2}, {"warmup_iters": 50, "min_lr_ratio": 0.2}):
        want = jax_schedule(JOptimConfig(**kw), 10000)
        got = make_lr_schedule(OptimConfig(**kw), 10000)
        for step in (0, 1, 2, 49, 250, 499, 500, 501, 5000, 9999, 10000, 12000):
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, err_msg=f"{kw} step {step}")


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.img_backbone = nn.Module()
        self.img_backbone.conv = Linear(4, 8, bias=False)
        self.img_backbone.norm = FrozenBatchNorm(8)
        self.head = Linear(8, 3)


@pytest.mark.parametrize("freeze", [False, True], ids=["train_bn_affine", "frozen_bn_affine"])
def test_two_adamw_steps_match_optax(freeze):
    rng = np.random.RandomState(8)
    model = _Tiny()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(t(rng.randn(*p.shape).astype(np.float32)))
        model.img_backbone.norm.running_mean.copy_(t(rng.randn(8).astype(np.float32)))
    bn = model.img_backbone.norm
    params = {
        "backbone": {"conv": {"kernel": model.img_backbone.conv.weight.detach().numpy().T.copy()},
                     "bn": {"scale": bn.weight.detach().numpy().copy(), "bias": bn.bias.detach().numpy().copy(),
                            "mean": bn.running_mean.numpy().copy(), "var": bn.running_var.numpy().copy()}},
        "head": {"fc": {"kernel": model.head.weight.detach().numpy().T.copy(),
                        "bias": model.head.bias.detach().numpy().copy()}},
    }
    cfg = dict(lr=2e-4, warmup_iters=5, weight_decay=0.01, grad_clip_norm=35.0, backbone_lr_mult=0.1)
    tx = jax_build_optimizer(JOptimConfig(**cfg), 100, params, freeze_backbone_bn_affine=freeze)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    state = TrainState(0, model, build_optimizer(OptimConfig(**cfg), model, freeze), make_lr_schedule(OptimConfig(**cfg), 100))
    names = list(state.trainable())
    assert ("img_backbone.norm.weight" in names) == (not freeze)
    for step in range(2):
        scale = 30.0 if step == 0 else 0.1  # the clip engages on the first step only
        g = {"conv": rng.randn(8, 4) * scale, "scale": rng.randn(8) * scale, "bias": rng.randn(8) * scale,
             "w": rng.randn(3, 8) * scale, "b": rng.randn(3) * scale}
        g = {k: v.astype(np.float32) for k, v in g.items()}
        huge = np.full((8,), 1e6, np.float32)  # frozen statistics' grads must not count
        jgrads = {"backbone": {"conv": {"kernel": g["conv"].T}, "bn": {"scale": g["scale"], "bias": g["bias"],
                                                                       "mean": huge, "var": huge}},
                  "head": {"fc": {"kernel": g["w"].T, "bias": g["b"]}}}
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, jgrads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        by_name = {"img_backbone.conv.weight": g["conv"], "img_backbone.norm.weight": g["scale"],
                   "img_backbone.norm.bias": g["bias"], "head.weight": g["w"], "head.bias": g["b"]}
        grads = [t(by_name[n]) for n in names]
        norm = global_norm(grads)
        state.apply_gradients(dict(zip(names, clip_by_global_norm(grads, 35.0, norm))))
        state.step += 1
        np.testing.assert_allclose(model.img_backbone.conv.weight.detach().numpy().T,
                                   np.asarray(jparams["backbone"]["conv"]["kernel"]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(model.head.weight.detach().numpy().T,
                                   np.asarray(jparams["head"]["fc"]["kernel"]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(model.head.bias.detach().numpy(),
                                   np.asarray(jparams["head"]["fc"]["bias"]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(bn.weight.detach().numpy(), np.asarray(jparams["backbone"]["bn"]["scale"]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_array_equal(bn.running_mean.numpy(), np.asarray(jparams["backbone"]["bn"]["mean"]))


def _tiny_batch(cfg, B=1, seed=0):
    rng = np.random.RandomState(seed)
    N, (H, W), G = cfg.data.num_views, cfg.data.image_size, cfg.data.max_gt
    boxes, labels, valid = _gt(rng, B, G, [5] * B)
    cams = np.tile(np.eye(4, dtype=np.float32), (B, N, 1, 1))
    cams[..., :3, 3] = rng.randn(B, N, 3)
    return {"images": rng.randn(B, N, H, W, 3).astype(np.float32), "img2lidar": cams,
            "img_hw": np.tile(np.array([H, W], np.float32), (B, N, 1)),
            "gt_boxes": boxes, "gt_labels": labels, "gt_valid": valid}


def test_nonfinite_step_is_skipped_but_the_schedule_advances():
    """petr_tpu's skip (`train_step.py:281-309`): parameters, Adam moments and
    their step counts stay; the LR schedule's count advances."""
    cfg = get_config("tiny_debug")
    state = create_train_state(cfg, seed=0, total_steps=10, device="cpu")
    step_fn = make_train_step(cfg)
    batch = _tiny_batch(cfg)
    gen = torch.Generator().manual_seed(0)
    state, _ = step_fn(state, batch, gen)  # one clean step: Adam state exists
    params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    opt = {id(p): {k: v.clone() for k, v in s.items()} for p, s in state.optimizer.state.items()}

    bad = dict(batch, images=batch["images"].copy())
    bad["images"][0, 0, 0, 0, 0] = np.nan
    state, m = step_fn(state, bad, gen)
    assert m["skipped"] == 1 and m["grad_nonfinite"] > 0 and state.step == 2
    for n, p in state.model.named_parameters():
        assert torch.equal(p, params[n]), n
    for p, s in state.optimizer.state.items():
        for k, v in s.items():
            assert torch.equal(v, opt[id(p)][k]), k

    state, m = step_fn(state, batch, gen)
    assert m["skipped"] == 0 and state.step == 3
    jsched = jax_schedule(jax_config("tiny_debug").train.optim, 10)
    lrs = {g["name"]: g["lr"] for g in state.optimizer.param_groups}
    np.testing.assert_allclose(lrs["main"], float(jsched(2)), rtol=1e-6)  # the skip advanced the schedule
    np.testing.assert_allclose(lrs["backbone"], float(jsched(2)) * cfg.train.optim.backbone_lr_mult, rtol=1e-6)
    steps = {int(s["step"]) for s in state.optimizer.state.values()}
    assert steps == {2}, steps  # Adam's bias-correction count skipped the bad step


def test_grad_accum_averages_interleaved_micro_batches():
    cfg = get_config("tiny_debug")
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, grad_accum=2))
    from petr_tpu_torch.train import accumulate_grads, make_grad_fn

    state = create_train_state(cfg, seed=0, total_steps=10, device="cpu")
    batch = _tiny_batch(cfg, B=2, seed=3)
    grad_fn = make_grad_fn(cfg2)
    total, losses, grads, _ = accumulate_grads(grad_fn, state.model, batch, torch.Generator().manual_seed(0), 2)
    gen = torch.Generator().manual_seed(0)  # the micro-batches draw from it in turn
    parts = [grad_fn(state.model, {k: v[i::2] for k, v in batch.items()}, gen) for i in range(2)]
    np.testing.assert_allclose(total.item(), (parts[0][0] + parts[1][0]).item() / 2, rtol=1e-6)
    for n in grads:
        torch.testing.assert_close(grads[n], (parts[0][2][n] + parts[1][2][n]) / 2, rtol=1e-5, atol=1e-7)


def test_global_norm_stays_finite_where_the_gradients_are():
    """The global norm of the clip: optax's where its sum of squares fits
    in fp32 (the same bits as the plain sum: the scale is a power of two),
    finite where that sum would overflow, so that the clip keeps the
    update's direction instead of zeroing it, and non-finite where a
    gradient is."""
    rng = np.random.RandomState(7)
    grads = [rng.randn(300).astype(np.float32) * 3, rng.randn(7, 5).astype(np.float32) * 1e-3]
    plain = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(torch.from_numpy(g)) for g in grads]))
    got = global_norm([torch.from_numpy(g) for g in grads])
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.item(), float(optax.global_norm([jnp.asarray(g) for g in grads])), rtol=1e-6)
    big = [torch.from_numpy(g) * 1e20 for g in grads]
    assert not torch.isfinite(torch.linalg.vector_norm(torch.cat([g.flatten() for g in big])))
    norm = global_norm(big)
    np.testing.assert_allclose(norm.item(), got.item() * 1e20, rtol=1e-5)
    clipped = clip_by_global_norm(big, 35.0, norm)
    np.testing.assert_allclose(global_norm(clipped).item(), 35.0, rtol=1e-5)
    assert not torch.isfinite(global_norm([torch.tensor([np.nan, 1.0]), torch.ones(3)]))
    assert not torch.isfinite(global_norm([torch.tensor([np.inf, 1.0])]))
    assert global_norm([torch.zeros(4)]).item() == 0.0
