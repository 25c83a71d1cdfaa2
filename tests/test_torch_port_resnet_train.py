"""One fp32 train step of the r50dcn detector, port against petr_tpu, on the CPU.

``petr_r50_p4_1408x512`` shrunk as in ``test_torch_port_resnet.py`` (2
views of 64x160, a 2-layer head of width 64), in fp32 with dropout 0 and no
GridMask on both sides, flash attention and remat on. The preset freezes the
backbone's BN affine (``train_bn_affine=False``), so that petr_tpu's
optimizer zeroes its update and the port leaves it out of AdamW. One set of
weights serves both (offset convs redrawn, random BN statistics), through
petr_tpu's converter; the same numpy batch goes to both.

Checked: the assignment, the losses, every trainable gradient (the DCN
weights and offset convs among them), the parameters after one update, and
the frozen BN affine unchanged on both sides. Tolerances are stated at each
check.
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
from petr_tpu.train.optim import build_optimizer as jax_build_optimizer
from petr_tpu.train.train_step import TrainState as JTrainState
from petr_tpu.train.train_step import make_grad_fn as jax_make_grad_fn
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.models.layers import FrozenBatchNorm
from petr_tpu_torch.models.resnet import redraw_offset_convs
from petr_tpu_torch.train import create_train_state, make_grad_fn, make_train_step
from petr_tpu_torch.utils import named_parameters_from_jax
from tests.test_heads import make_cams
from tests.test_torch_port_resnet import randomize_bn, small, to_jax
from tests.test_torch_port_train import _jax_assignment

TOTAL_STEPS = 100


def _no_dropout(cfg):
    head = dataclasses.replace(cfg.model.head, dropout_rate=0.0)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, head=head, use_grid_mask=False))


@pytest.fixture(scope="module")
def run():
    jcfg = _no_dropout(small(jax_config("petr_r50_p4_1408x512")))
    cfg = _no_dropout(small(get_config("petr_r50_p4_1408x512")))
    assert cfg.model.remat and cfg.model.use_flash_attention and not cfg.model.backbone.train_bn_affine
    N, (H, W), G = cfg.data.num_views, cfg.data.image_size, cfg.data.max_gt
    rng = np.random.RandomState(0)
    valid = np.zeros((1, G), bool)
    valid[0, rng.permutation(G)[:7]] = True
    boxes = np.concatenate([
        rng.uniform(-40, 40, (1, G, 2)), rng.uniform(-4, 2, (1, G, 1)), rng.uniform(0.5, 4, (1, G, 3)),
        rng.uniform(-np.pi, np.pi, (1, G, 1)), rng.uniform(-1, 1, (1, G, 2)),
    ], -1).astype(np.float32)
    boxes[~valid] = 0.0
    batch = {
        "images": rng.randn(1, N, H, W, 3).astype(np.float32),
        "img2lidar": make_cams(1, N, seed=1),
        "img_hw": np.tile(np.array([H, W], np.float32), (1, N, 1)),
        "gt_boxes": boxes,
        "gt_labels": np.where(valid, rng.randint(0, 10, (1, G)), 0).astype(np.int32),
        "gt_valid": valid,
    }
    batch["img_hw"][0, 1] = [40, 112]  # a padded view: masked decoder keys

    state = create_train_state(cfg, seed=0, total_steps=TOTAL_STEPS, device="cpu")
    model = state.model
    redraw_offset_convs(model, seed=1)
    randomize_bn(model, rng)
    port_sd, params, stats = to_jax(model, jcfg, batch)
    assert stats["skipped"] == 0 and stats["unfilled"] == 0, stats
    params = jax.tree.map(jnp.asarray, params)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    total, losses, grads, _ = jax.jit(jax_make_grad_fn(jcfg))(params, jb, jax.random.PRNGKey(1))
    tx = jax_build_optimizer(jcfg.train.optim, TOTAL_STEPS, params, freeze_backbone_bn_affine=True)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params), tx=tx)
    new_params = jax.jit(lambda s, g: s.apply_gradients(g).params)(jstate, grads)
    outputs = jax.jit(JDetector(jcfg.model, deterministic=True).apply)(
        {"params": params}, *[jb[k] for k in ("images", "img2lidar", "img_hw")])
    return types.SimpleNamespace(
        cfg=cfg, batch=batch, model=model, port_sd=port_sd,
        jax=types.SimpleNamespace(total=float(total), losses={k: float(v) for k, v in losses.items()},
                                  grads=jax.device_get(grads), new_params=jax.device_get(new_params),
                                  outputs=jax.device_get(outputs)),
        port=make_grad_fn(cfg)(model, batch, torch.Generator().manual_seed(0)),
    )


def test_assignment_and_losses_match(run):
    _, losses, _, idx, _ = run.port
    valid = run.batch["gt_valid"][None]
    np.testing.assert_array_equal(np.where(valid, idx, 0), np.where(valid, _jax_assignment(run), 0))
    assert set(losses) == set(run.jax.losses)
    for k, want in run.jax.losses.items():  # fp32 sums in other orders
        np.testing.assert_allclose(losses[k].item(), want, rtol=2e-5, err_msg=k)
    np.testing.assert_allclose(run.port[0].item(), run.jax.total, rtol=2e-5)


def test_every_trainable_gradient_matches(run):
    _, _, grads, _, _ = run.port
    want = named_parameters_from_jax(run.jax.grads, run.model)
    trainable = {n for n, p in run.model.named_parameters() if p.requires_grad}
    assert set(grads) == trainable
    bn_affine = {n for n in want if n.startswith("img_backbone.") and n not in trainable}
    assert len(bn_affine) == 2 * sum(isinstance(m, FrozenBatchNorm) for m in run.model.img_backbone.modules())
    offsets = [n for n in grads if "conv_offset" in n]
    assert len(offsets) == 18  # 9 offset convs: weight and bias
    # fp32 through ResNet-50-DCN and 2 decoder layers. A ReLU whose input
    # lies within fp32 noise of 0 can switch between the two packages, and
    # then every gradient below it moves: here one switch in stage 3 moves
    # the gradients of stages 1 to 3.1 by up to 1.5% in L2 (8% in max abs
    # on one entry). A 1e-6 change of the images makes the port's own
    # gradients switch the same way, and then they match petr_tpu's within
    # 8e-5. So each gradient is held to 3% in L2 over the larger of its own
    # norm and 1e-3 x the largest (the PE MLPs' last biases have an exact
    # gradient of 0, which both give as cancellation noise), and half of
    # them to 1e-3: an error of the DCN's gradient, or a frozen parameter
    # trained, is off by far more.
    top = max(w.norm().item() for w in want.values())
    rel = {}
    for name, g in grads.items():
        w = want[name]
        rel[name] = (g - w).norm().item() / max(w.norm().item(), 1e-3 * top)
        assert rel[name] <= 3e-2, f"{name}: relative L2 error {rel[name]:.3e}"
    assert np.median(list(rel.values())) <= 1e-3, np.median(list(rel.values()))


def test_one_update_matches_and_the_bn_affine_stays(run):
    state = create_train_state(run.cfg, seed=0, total_steps=TOTAL_STEPS, device="cpu")
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in run.port_sd.items()})
    state, metrics = make_train_step(run.cfg)(state, run.batch, torch.Generator().manual_seed(0))
    assert metrics["skipped"] == 0 and state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), run.jax.total, rtol=2e-5)
    want = named_parameters_from_jax(run.jax.new_params, state.model)
    jgrads = named_parameters_from_jax(run.jax.grads, state.model)
    norm = torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(jgrads[n]) for n, p in state.model.named_parameters() if p.requires_grad]))
    np.testing.assert_allclose(metrics["grad_norm"].item(), norm.item(), rtol=1e-3)  # the switch: 1.5e-4
    before = {k: torch.from_numpy(v) for k, v in run.port_sd.items()}
    lr0 = state.lr_schedule(0)
    clip = min(1.0, run.cfg.train.optim.grad_clip_norm / norm.item())
    grads = run.port[2]
    frozen = flipped = entries = 0
    for name, p in state.model.named_parameters():
        if not p.requires_grad:  # the backbone BN affine: unchanged on both sides
            assert torch.equal(p.detach(), before[name]) and torch.equal(want[name], before[name]), name
            frozen += 1
            continue
        # Adam's first step moves an entry by about lr x sign(g); where the
        # clipped |g| is near eps on either side, a small change of g moves
        # it by a good part of lr, and where the ReLU switch above flips the
        # sign of g, by 2 lr
        g = grads[name]
        flips = torch.sign(g) != torch.sign(jgrads[name])
        other_side = flips | (torch.minimum(g.abs(), jgrads[name].abs()) * clip < 1e-6)
        flipped += int(flips.sum())
        entries += flips.numel()
        bound = torch.where(other_side, 2.0 * lr0, 1e-2 * lr0) + 1e-6 * before[name].abs()
        err = (p.detach() - want[name]).abs()
        assert (err <= bound).all(), f"{name}: {err.max().item():.3e}"
        assert not torch.equal(p.detach(), before[name]), f"{name} did not move"
    assert frozen > 0
    assert flipped <= 1e-3 * entries, (flipped, entries)
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

