"""The port's train step against petr_tpu's at tiny_debug size, on the CPU.

``tiny_debug`` in fp32 with ``dropout_rate=0`` and no GridMask on both
sides, flash attention on (petr_tpu runs its Pallas kernels in interpret
mode, the port its plain versions through the same autograd Function), and
remat as the preset says. One set of weights serves both: a seeded port
model with random frozen-BN statistics goes to a petr_tpu param tree through
petr_tpu's checkpoint converter. The same numpy batch goes to both.

Checked: the assignment, the per-layer losses and total, every gradient
(mapped through ``named_parameters_from_jax``), the parameters after one
update (petr_tpu's ``make_train_step`` applies ``state.apply_gradients`` to
``make_grad_fn``'s gradients when they are finite; the port's
``make_train_step`` runs in full), and the port's gradients with remat on
and off. Tolerances are stated at each check.
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
from petr_tpu.ops import losses as jl
from petr_tpu.ops.boxes import encode_bbox as jax_encode
from petr_tpu.ops.matcher import lap_solve as jax_lap_solve
from petr_tpu.train.optim import build_optimizer as jax_build_optimizer
from petr_tpu.train.train_step import TrainState as JTrainState
from petr_tpu.train.train_step import make_grad_fn as jax_make_grad_fn
from petr_tpu.utils.torch_convert import convert_state_dict
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.models import PETRDetector, init_weights
from petr_tpu_torch.models.layers import FrozenBatchNorm
from petr_tpu_torch.train import create_train_state, make_grad_fn, make_train_step
from petr_tpu_torch.utils import named_parameters_from_jax
from tests.test_heads import make_cams

TOTAL_STEPS = 100


def _no_dropout(cfg):
    head = dataclasses.replace(cfg.model.head, dropout_rate=0.0)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, head=head, use_grid_mask=False))


@pytest.fixture(scope="module")
def run():
    jcfg, cfg = _no_dropout(jax_config("tiny_debug")), _no_dropout(get_config("tiny_debug"))
    assert cfg.model.use_flash_attention and cfg.model.remat and cfg.model.compute_dtype == "float32"
    N, (H, W), G = cfg.data.num_views, cfg.data.image_size, cfg.data.max_gt
    B = 2
    rng = np.random.RandomState(0)
    valid = np.zeros((B, G), bool)
    valid[0, rng.permutation(G)[:5]] = True
    valid[1, rng.permutation(G)[:9]] = True
    boxes = np.concatenate([
        rng.uniform(-40, 40, (B, G, 2)), rng.uniform(-4, 2, (B, G, 1)), rng.uniform(0.5, 4, (B, G, 3)),
        rng.uniform(-np.pi, np.pi, (B, G, 1)), rng.uniform(-1, 1, (B, G, 2)),
    ], -1).astype(np.float32)
    boxes[~valid] = 0.0
    batch = {
        "images": rng.randn(B, N, H, W, 3).astype(np.float32),
        "img2lidar": make_cams(B, N, seed=1),
        "img_hw": np.tile(np.array([H, W], np.float32), (B, N, 1)),
        "gt_boxes": boxes,
        "gt_labels": np.where(valid, rng.randint(0, 10, (B, G)), 0).astype(np.int32),
        "gt_valid": valid,
    }
    batch["img_hw"][1, 2] = [16, 48]  # a padded view: masked decoder keys

    state = create_train_state(cfg, seed=0, total_steps=TOTAL_STEPS, device="cpu")
    model = state.model
    # the He-scaled draw of the serving paths (init_weights' default), on
    # which this file's tolerances were set: create_train_state draws
    # petr_tpu's smaller scales, under which the stem's gradient is ~1e-4
    # and made of cancelling terms (tests/test_torch_port_init.py)
    model.load_state_dict(init_weights(PETRDetector(cfg.model), 0).state_dict())
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))
    port_sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    jmodel = JDetector(jcfg.model, deterministic=True)
    one = [jnp.asarray(batch[k][:1]) for k in ("images", "img2lidar", "img_hw")]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *one)["params"]
    params, stats = convert_state_dict(port_sd, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    assert stats["skipped"] == 0 and stats["unfilled"] == 0, stats
    params = jax.tree.map(jnp.asarray, params)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    total, losses, grads, _ = jax.jit(jax_make_grad_fn(jcfg))(params, jb, jax.random.PRNGKey(1))
    tx = jax_build_optimizer(jcfg.train.optim, TOTAL_STEPS, params,
                             freeze_backbone_bn_affine=not jcfg.model.backbone.train_bn_affine)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params), tx=tx)
    new_params = jax.jit(lambda s, g: s.apply_gradients(g).params)(jstate, grads)
    outputs = jax.jit(jmodel.apply)({"params": params}, *[jb[k] for k in ("images", "img2lidar", "img_hw")])
    return types.SimpleNamespace(
        cfg=cfg, batch=batch, state=state, model=model, port_sd=port_sd,
        jax=types.SimpleNamespace(total=float(total), losses={k: float(v) for k, v in losses.items()},
                                  grads=jax.device_get(grads), new_params=jax.device_get(new_params),
                                  outputs=jax.device_get(outputs)),
        port=make_grad_fn(cfg)(model, batch, torch.Generator().manual_seed(0)),
    )


def _jax_assignment(run):
    out, b = run.jax.outputs, run.batch
    codes = np.where(b["gt_valid"][..., None], np.nan_to_num(np.asarray(jax_encode(jnp.asarray(b["gt_boxes"])))), 0.0)
    solve = jax.jit(jax_lap_solve)
    L, B = out["cls_logits"].shape[:2]
    idx = np.zeros((L, B, codes.shape[1]), np.int64)
    for lvl in range(L):
        for s in range(B):
            cost = jl.focal_loss_cost(jnp.asarray(out["cls_logits"][lvl, s]), jnp.asarray(b["gt_labels"][s])) \
                + jl.bbox_l1_cost(jnp.asarray(out["bbox_codes"][lvl, s, :, :8]), jnp.asarray(codes[s, :, :8]))
            idx[lvl, s] = np.asarray(solve(cost.T, jnp.asarray(b["gt_valid"][s])))
    return idx


def test_assignment_and_losses_match(run):
    _, losses, _, idx, _ = run.port
    valid = run.batch["gt_valid"][None]
    np.testing.assert_array_equal(np.where(valid, idx, 0), np.where(valid, _jax_assignment(run), 0))
    assert set(losses) == set(run.jax.losses)
    for k, want in run.jax.losses.items():  # fp32 sums in other orders
        np.testing.assert_allclose(losses[k].item(), want, rtol=2e-5, err_msg=k)
    np.testing.assert_allclose(run.port[0].item(), run.jax.total, rtol=2e-5)


def test_every_gradient_matches(run):
    _, _, grads, _, _ = run.port
    want = named_parameters_from_jax(run.jax.grads, run.model)
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name]
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        # fp32 through 2 decoder layers and the V-39 backbone: observed within
        # 1.5e-5 of each gradient's largest entry. The last biases of the PE
        # MLPs shift every key of a query alike, which the softmax ignores:
        # their exact gradient is 0, and both packages give ~2e-9 of noise
        assert err <= 1e-4 * scale + 1e-8, f"{name}: max abs err {err:.3e}, max |grad| {scale:.3e}"


def test_one_update_matches(run):
    state = create_train_state(run.cfg, seed=0, total_steps=TOTAL_STEPS, device="cpu")
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in run.port_sd.items()})
    gen = torch.Generator().manual_seed(0)
    state, metrics = make_train_step(run.cfg)(state, run.batch, gen)
    assert metrics["skipped"] == 0 and state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), run.jax.total, rtol=2e-5)
    # the clip engages when the trainable gradients' norm passes 35
    jgrads = named_parameters_from_jax(run.jax.grads, run.model)
    want_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in jgrads.values()]))
    np.testing.assert_allclose(metrics["grad_norm"].item(), want_norm.item(), rtol=1e-4)
    want = named_parameters_from_jax(run.jax.new_params, state.model)
    before = {k: torch.from_numpy(v) for k, v in run.port_sd.items()}
    lr0 = state.lr_schedule(0)
    clip = min(1.0, run.cfg.train.optim.grad_clip_norm / want_norm.item())
    for name, p in state.model.named_parameters():
        # Adam's first step moves an entry by lr * g / (|g| + 1e-8): about lr
        # whatever |g|. Where the clipped |g| is near eps, fp32 noise of
        # 1e-9 in g moves the update by a good part of lr, so such entries
        # are held to 2 lr; the others to a hundredth of lr. Plus the fp32
        # rounding of the parameter.
        near_eps = (jgrads[name] * clip).abs() < 1e-6
        bound = torch.where(near_eps, 2.0 * lr0, 1e-2 * lr0) + 1e-6 * before[name].abs()
        err = (p.detach() - want[name]).abs()
        assert (err <= bound).all(), f"{name}: {err.max().item():.3e}"
    moved = sum(not torch.equal(p.detach(), before[n]) for n, p in state.model.named_parameters())
    assert moved == len(list(state.model.parameters()))
    for name, b in state.model.named_buffers():
        assert torch.equal(b, before[name]), name


def test_remat_on_and_off_give_the_same_gradients(run):
    cfg = dataclasses.replace(run.cfg, model=dataclasses.replace(run.cfg.model, remat=False))
    state = create_train_state(cfg, seed=0, total_steps=TOTAL_STEPS, device="cpu")
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in run.port_sd.items()})
    total, _, grads, _, _ = make_grad_fn(cfg)(state.model, run.batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(total.item(), run.port[0].item(), rtol=1e-6)
    for name, g in grads.items():
        torch.testing.assert_close(g, run.port[2][name], rtol=1e-5, atol=1e-7, msg=name)


def test_remat_recomputes_the_same_dropout_masks():
    """With dropout on, the decoder's recompute draws its masks again from
    the seeds it was given: remat on and off give the same gradients."""
    cfg = get_config("tiny_debug")
    assert cfg.model.head.dropout_rate > 0 and cfg.model.remat
    cfg_nr = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=False))
    rng = np.random.RandomState(3)
    N, (H, W), G = cfg.data.num_views, cfg.data.image_size, cfg.data.max_gt
    valid = np.arange(G)[None] < 6
    batch = {"images": rng.randn(1, N, H, W, 3).astype(np.float32), "img2lidar": make_cams(1, N, seed=2),
             "img_hw": np.tile(np.array([H, W], np.float32), (1, N, 1)),
             "gt_boxes": np.abs(rng.randn(1, G, 9)).astype(np.float32) + 0.5,
             "gt_labels": rng.randint(0, 10, (1, G)), "gt_valid": valid}
    results = []
    for c in (cfg, cfg_nr):
        model = create_train_state(c, seed=0, total_steps=TOTAL_STEPS, device="cpu").model
        results.append(make_grad_fn(c)(model, batch, torch.Generator().manual_seed(5)))
    assert results[0][0].item() == pytest.approx(results[1][0].item(), rel=1e-6)
    for name, g in results[0][2].items():
        torch.testing.assert_close(g, results[1][2][name], rtol=1e-5, atol=1e-7, msg=name)
    # and a different seed draws other masks
    model = create_train_state(cfg, seed=0, total_steps=TOTAL_STEPS, device="cpu").model
    other = make_grad_fn(cfg)(model, batch, torch.Generator().manual_seed(6))
    assert other[0].item() != results[0][0].item()
