"""One fp32 train step of the Depthr detector, port against petr_tpu, on the
CPU; and what a step of the r50 Depthr preset runs of its backbone.

The detector of `tests/test_torch_port_depthr.py` (``synth_small_depthr``
with a head of width 32, 2 layers, 12 queries, 8 depth bins; 6 views of
64x160), one batch of 2 with the GT-depth oracle's inputs. Dropout 0 and no
GridMask on both sides: the plain attention branch draws its dropout masks
from a torch generator in the port and from JAX's PRNG in petr_tpu, so at
a rate above 0 the two steps cannot match. Remat is on in the port (its
checkpointed Depthr layers carry the depth tokens) and off in petr_tpu
(the same arithmetic; a cheaper compile). One set of weights serves both
(``random_params`` through ``state_dict_from_jax``); the same numpy batch
goes to both. Tolerances are stated at each check.
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
from petr_tpu_torch.models import resnet
from petr_tpu_torch.train import create_train_state, make_grad_fn, make_train_step
from petr_tpu_torch.utils import named_parameters_from_jax, state_dict_from_jax
from tests.test_torch_port_depthr import init_params, jax_kwargs, oracle_batch, tiny

TOTAL_STEPS = 100


def _train_config(cfg, remat):
    head = dataclasses.replace(cfg.model.head, dropout_rate=0.0)
    model = dataclasses.replace(cfg.model, head=head, use_grid_mask=False, remat=remat)
    return dataclasses.replace(cfg, model=model)


@pytest.fixture(scope="module")
def run():
    jcfg = _train_config(tiny(jax_config("synth_small_depthr")), remat=False)
    cfg = _train_config(tiny(get_config("synth_small_depthr")), remat=True)
    batch = oracle_batch(2, 13)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = init_params(JDetector(jcfg.model), 14, *[jb[k] for k in ("images", "img2lidar", "img_hw")],
                         **jax_kwargs(batch))
    state = create_train_state(cfg, seed=0, total_steps=TOTAL_STEPS, device="cpu")
    port_sd = state_dict_from_jax(params, state.model)  # raises on a leaf skipped or unfilled
    state.model.load_state_dict(port_sd)
    params = jax.tree.map(jnp.asarray, params)
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


def test_losses_match(run):
    """fp32 sums in other orders: rtol 2e-5, as the flagship's step."""
    _, losses, _, _, _ = run.port
    assert set(losses) == set(run.jax.losses)
    for k, want in run.jax.losses.items():
        np.testing.assert_allclose(losses[k].item(), want, rtol=2e-5, err_msg=k)
    np.testing.assert_allclose(run.port[0].item(), run.jax.total, rtol=2e-5)


def test_every_gradient_matches(run):
    """Every trainable gradient within 1e-4 of its largest entry (the
    flagship step's limit), the median within 5e-5 (the flagship's 1e-5
    was set on init weights; these random ones, every norm and bias moved,
    put the two packages' fp32 outputs up to 5e-5 apart, relative, as
    `test_torch_port_depthr.py::test_eval_step_matches` measures). Some
    are exact zeros, held to be small on both sides instead (1e-5 of the model's
    largest gradient entry; both give cancellation noise): the decoder
    reads no image feature, so the backbone's, the neck's and
    ``input_proj``'s gradients are 0, exactly on both sides; the last
    biases of the PE MLPs shift every key of a query alike, which the
    softmax ignores; at width 32 each GroupNorm group is one channel,
    which takes out the bias of the conv before it; and layer 0's
    self-attention reads the zero target, so its values are one vector
    (the bias) and no q/k/v weight moves its output."""
    _, _, grads, _, _ = run.port
    want = named_parameters_from_jax(run.jax.grads, run.model)
    assert set(grads) == {n for n, p in run.model.named_parameters() if p.requires_grad}
    dead = [n for n in grads if n.startswith(("img_backbone.", "img_neck.", "pts_bbox_head.input_proj."))]
    assert dead and all(not grads[n].any() and not want[n].any() for n in dead)
    assert run.cfg.model.head.embed_dim == 32
    zero = [n for n in grads if n.endswith(("position_encoder.2.bias", "adapt_pos3d.2.bias",
                                             "layers.0.attentions.0.attn.in_proj_weight"))
            or ("depth_gt_encoder.depth_head." in n and n.endswith(".0.bias"))]
    assert len(zero) == 5, zero
    live = [n for n in grads if n not in dead and n not in zero]
    assert any("depth_gt_encoder.depth_pos_embed" in n for n in live)
    top = max(want[n].abs().max().item() for n in live)
    for name in zero:
        assert max(grads[name].abs().max().item(), want[name].abs().max().item()) <= 1e-5 * top, name
    rel = {}
    for name in live:
        scale = want[name].abs().max().item()
        err = (grads[name] - want[name]).abs().max().item()
        assert scale > 0, f"{name}: a live gradient is 0"
        rel[name] = err / scale
        assert rel[name] <= 1e-4, f"{name}: max abs err {err:.3e}, max |grad| {scale:.3e}"
    assert np.median(list(rel.values())) <= 5e-5


def test_one_update_matches(run):
    """One AdamW step from the same weights: the parameters within a
    hundredth of the learning rate of petr_tpu's (2 lr where the clipped
    gradient is near Adam's eps)."""
    state = create_train_state(run.cfg, seed=0, total_steps=TOTAL_STEPS, device="cpu")
    state.model.load_state_dict(run.port_sd)
    state, metrics = make_train_step(run.cfg)(state, run.batch, torch.Generator().manual_seed(0))
    assert metrics["skipped"] == 0 and state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), run.jax.total, rtol=2e-5)
    jgrads = named_parameters_from_jax(run.jax.grads, run.model)
    want_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in jgrads.values()]))
    np.testing.assert_allclose(metrics["grad_norm"].item(), want_norm.item(), rtol=1e-4)
    want = named_parameters_from_jax(run.jax.new_params, state.model)
    lr0 = state.lr_schedule(0)
    clip = min(1.0, run.cfg.train.optim.grad_clip_norm / want_norm.item())
    for name, p in state.model.named_parameters():
        near_eps = (jgrads[name] * clip).abs() < 1e-6
        bound = torch.where(near_eps, 2.0 * lr0, 1e-2 * lr0) + 1e-6 * run.port_sd[name].abs()
        err = (p.detach() - want[name]).abs()
        assert (err <= bound).all(), f"{name}: {err.max().item():.3e}"


def test_the_r50_step_runs_the_backbone_forward_only():
    """``depthr_r50_c5_512x1408_gtdepth`` (cut to 6 views of 64x192 and the
    tiny head; remat, dropout 0.1 and GridMask as the preset): a train step
    calls the DCN op 9 times, all in the forward. No gradient reaches the
    backbone, so autograd never replays its checkpointed bottlenecks (the
    r50dcn PETR step calls it 18 times), and every backbone gradient is 0."""
    cfg = get_config("depthr_r50_c5_512x1408_gtdepth")
    head = dataclasses.replace(tiny(cfg).model.head, depth_map_down_scale=cfg.model.head.depth_map_down_scale)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, head=head),
                              data=dataclasses.replace(cfg.data, image_size=(64, 192)))
    assert cfg.model.remat and cfg.model.use_grid_mask and head.dropout_rate > 0
    batch = oracle_batch(1, 15, 64, 192)
    state = create_train_state(cfg, seed=0, total_steps=TOTAL_STEPS, device="cpu")
    calls = []

    def counted(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return kept(*args, **kwargs)

    kept = resnet.modulated_deform_conv
    resnet.modulated_deform_conv = counted
    try:
        _, _, grads, _, _ = make_grad_fn(cfg)(state.model, batch, torch.Generator().manual_seed(0))
    finally:
        resnet.modulated_deform_conv = kept
    assert len(calls) == 9, calls
    backbone = [n for n in grads if n.startswith("img_backbone.")]
    assert backbone and all(not grads[n].any() for n in backbone)
    assert grads["pts_bbox_head.depth_gt_encoder.depth_head.0.0.weight"].any()
