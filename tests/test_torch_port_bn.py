"""Batch-moments BN (``bn_mode="batch"``), its train step and the BN
warm-up of the port against petr_tpu, on the CPU at tiny sizes.

The layer: ``FrozenBatchNorm(use_batch_stats=True)`` in train mode against
petr_tpu's, output and collected moments (the mean and the Bessel-corrected
variance). The step: ``tiny_debug`` with ``bn_mode="batch"`` in fp32,
dropout 0, no GridMask, both packages on the plain attention (the flash
kernels' parity is held in tests/test_torch_port_train.py; here the Pallas
interpret mode would only add compile time) and petr_tpu without remat
(remat changes no number: the port's remat on and off are held to each
other below). One set of weights serves both (the port's, with random
running statistics, through petr_tpu's converter). Checked: the loss, every
gradient, the batch moments, the weights after one update and the EMA'd
running statistics, against petr_tpu's ``make_grad_fn``, ``apply_gradients``
and ``_ema_bn_stats``; the combine over two micro-batches against
``_combine_bn_moments``; remat on and off; the K5 route turned off under
batch moments. ``estimate_bn_stats`` against petr_tpu's, for VoVNet and for
Depthr's forward. Tolerances are stated at each check.
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
from petr_tpu.models.layers import FrozenBatchNorm as JFrozenBatchNorm
from petr_tpu.train.bn_warmup import estimate_bn_stats as jax_estimate_bn_stats
from petr_tpu.train.optim import build_optimizer as jax_build_optimizer
from petr_tpu.train.train_step import TrainState as JTrainState
from petr_tpu.train.train_step import _combine_bn_moments as jax_combine
from petr_tpu.train.train_step import _ema_bn_stats as jax_ema
from petr_tpu.train.train_step import make_grad_fn as jax_make_grad_fn
from petr_tpu.utils.torch_convert import convert_state_dict
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.models import PETRDetector, init_weights
from petr_tpu_torch.models import layers
from petr_tpu_torch.models.layers import ConvBNReLU, FrozenBatchNorm, collect_batch_moments
from petr_tpu_torch.ops import conv3x3
from petr_tpu_torch.train import accumulate_grads, create_train_state, make_grad_fn, make_train_step
from petr_tpu_torch.train.bn_warmup import estimate_bn_stats
from petr_tpu_torch.utils import named_parameters_from_jax, state_dict_from_jax
from tests.test_heads import make_cams
from tests.test_torch_port_depthr import init_params, jax_kwargs, oracle_batch, tiny

TOTAL_STEPS = 100
BATCH_BN = ("model.backbone.bn_mode=batch", "model.head.dropout_rate=0.0", "model.use_grid_mask=False",
            "model.use_flash_attention=False", "model.remat=False")
# BN statistics of two fp32 packages, each within MOMENT_TOL of its layer's
# largest |value|: the two sum in other orders, and the difference grows
# through the batch-normalised layers (each divides by a standard deviation
# measured on as few as 36 values per channel at stage 5); observed up to
# 4.1e-5 at stage 5, under 1e-6 in the stem
MOMENT_TOL = 2e-4
# A gradient through batch moments at this size is ill-conditioned: a
# one-ulp nudge of the images moves the port's own gradients by up to 13%
# of a layer's largest entry (ReLU and eSE kinks, 36-value statistics). So
# each gradient is held to petr_tpu's within NUDGE_MARGIN times what the
# nudge moves it by (or 1e-4 of its largest entry, if more); observed at
# most 1.8 times
NUDGE_MARGIN = 3.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs, as it was after: its
    CPU train steps, in a run of several test processes at once, otherwise
    contend for every core with the others."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def random_batch(cfg, B, seed):
    N, (H, W), G = cfg.data.num_views, cfg.data.image_size, cfg.data.max_gt
    rng = np.random.RandomState(seed)
    valid = np.zeros((B, G), bool)
    for b in range(B):
        valid[b, rng.permutation(G)[:5 + 4 * b]] = True
    boxes = np.concatenate([
        rng.uniform(-40, 40, (B, G, 2)), rng.uniform(-4, 2, (B, G, 1)), rng.uniform(0.5, 4, (B, G, 3)),
        rng.uniform(-np.pi, np.pi, (B, G, 1)), rng.uniform(-1, 1, (B, G, 2)),
    ], -1).astype(np.float32)
    boxes[~valid] = 0.0
    cams = make_cams(B, N, seed=seed + 1)
    return {
        "images": rng.randn(B, N, H, W, 3).astype(np.float32),
        "img2lidar": cams,
        "img_hw": np.tile(np.array([H, W], np.float32), (B, N, 1)),
        "gt_boxes": boxes,
        "gt_labels": np.where(valid, rng.randint(0, 10, (B, G)), 0).astype(np.int32),
        "gt_valid": valid,
        "lidar2img": np.linalg.inv(cams).astype(np.float32),
        "timestamp": np.zeros((B, N), np.float32),
    }


def jax_params_of(model, jcfg, batch):
    jmodel = JDetector(jcfg.model, deterministic=True)
    one = [jnp.asarray(batch[k][:1]) for k in ("images", "img2lidar", "img_hw")]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *one)["params"]
    params, stats = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                                       jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    assert stats["skipped"] == 0 and stats["unfilled"] == 0, stats
    return jax.tree.map(jnp.asarray, params)


def randomize_running_stats(model, seed):
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))


def assert_moments_close(got, want, what=""):
    assert set(got) == set(want), (sorted(set(got) ^ set(want)))[:4]
    for key, w in want.items():
        err = (got[key] - w).abs().max().item()
        assert err <= MOMENT_TOL * w.abs().max().item() + 1e-7, f"{what} {key}: {err:.3e}"


# ------------------------------------------------------------------- layer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_matches_petr_tpu(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 7, 16) * 2.0 + rng.randn(16)).astype(np.float32)  # NHWC, per-channel offsets
    scale, bias = rng.uniform(0.5, 1.5, 16).astype(np.float32), rng.randn(16).astype(np.float32)
    jlayer = JFrozenBatchNorm(dtype=getattr(jnp, dtype), use_batch_stats=True)
    params = {"scale": scale, "bias": bias, "mean": np.zeros(16, np.float32), "var": np.ones(16, np.float32)}
    want, stats = jlayer.apply({"params": params}, jnp.asarray(x).astype(getattr(jnp, dtype)),
                               mutable=["batch_stats"])
    bn = FrozenBatchNorm(16, use_batch_stats=True).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    with collect_batch_moments() as sink:
        got = bn(xt)
    assert got.dtype == xt.dtype
    mean, var = sink[bn]
    np.testing.assert_allclose(mean.numpy(), np.asarray(stats["batch_stats"]["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(stats["batch_stats"]["var"]), rtol=1e-5)
    # the collected variance is the unbiased one (torch's running_var)
    np.testing.assert_allclose(var.numpy(), xt.float().var(dim=(0, 2, 3), unbiased=True).numpy(), rtol=1e-5)
    # fp32: sums in other orders; bf16: one bf16 step (2^-8 relative) of the output
    tol = (1e-5, 1e-5) if dtype == "float32" else (2 ** -7, 2 ** -7)
    np.testing.assert_allclose(got.detach().float().permute(0, 2, 3, 1).numpy(), np.asarray(want, np.float32),
                               rtol=tol[0], atol=tol[1])
    assert torch.equal(bn.running_mean, torch.zeros(16)) and torch.equal(bn.running_var, torch.ones(16))


def test_eval_mode_and_frozen_bn_read_the_running_statistics():
    x = torch.randn(2, 8, 5, 5)
    frozen, batch = FrozenBatchNorm(8), FrozenBatchNorm(8, use_batch_stats=True)
    for m in (frozen, batch):
        with torch.no_grad():
            m.running_mean.uniform_(-1, 1, generator=torch.Generator().manual_seed(1))
            m.running_var.uniform_(0.5, 2, generator=torch.Generator().manual_seed(2))
    with collect_batch_moments() as sink:
        assert torch.equal(batch.eval()(x), frozen.train()(x))
    assert not sink
    with collect_batch_moments() as sink:
        assert not torch.equal(batch.train()(x), frozen(x))
    assert list(sink) == [batch]


def test_k5_route_is_off_under_batch_moments(monkeypatch):
    """petr_tpu takes the Pallas conv3x3 only under frozen BN
    (`layers.py:243`): with PETR_TPU_TORCH_CONV_IMPL=cuda, a batch-moments
    ConvBNReLU in train mode runs the conv and the batch BN; in eval mode
    (the running statistics) it takes K5's route again."""
    calls = []
    monkeypatch.setenv(conv3x3.CONV_IMPL_ENV, "cuda")
    monkeypatch.setattr(layers, "conv3x3_bn_relu", lambda *a, **k: calls.append(1) or torch.zeros(()))
    block = ConvBNReLU("c", 4, 6, bn_mode="batch")
    x = torch.randn(2, 4, 5, 5)
    with collect_batch_moments() as sink:
        y = block.train()(x)
    assert not calls and y.shape == (2, 6, 5, 5) and list(sink) == [block[1]]
    block.eval()(x)
    assert calls == [1]


# -------------------------------------------------------------------- step
@pytest.fixture(scope="module")
def run():
    jcfg, cfg = jax_config("tiny_debug", BATCH_BN), get_config("tiny_debug", BATCH_BN)
    assert cfg.model.compute_dtype == "float32" and cfg.model.backbone.bn_mode == "batch"
    batch = random_batch(cfg, 2, seed=0)
    state = create_train_state(cfg, seed=0, total_steps=TOTAL_STEPS, device="cpu")
    # the He-scaled draw (init_weights' default), whose features stay at
    # scale through the backbone, as in tests/test_torch_port_train.py
    state.model.load_state_dict(init_weights(PETRDetector(cfg.model), 0).state_dict())
    randomize_running_stats(state.model, seed=1)
    port_sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    params = jax_params_of(state.model, jcfg, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    total, losses, grads, bn_stats = jax.jit(jax_make_grad_fn(jcfg))(params, jb, jax.random.PRNGKey(1))
    tx = jax_build_optimizer(jcfg.train.optim, TOTAL_STEPS, params,
                             freeze_backbone_bn_affine=not jcfg.model.backbone.train_bn_affine)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params), tx=tx)
    momentum = jcfg.model.backbone.bn_momentum
    # petr_tpu's make_train_step on a finite step: the update, then the EMA
    new_params = jax.jit(lambda s, g, st: jax_ema(s.apply_gradients(g).params, st, momentum))(
        jstate, grads, bn_stats)
    return types.SimpleNamespace(
        cfg=cfg, batch=batch, model=state.model, port_sd=port_sd,
        jax=types.SimpleNamespace(total=float(total), losses={k: float(v) for k, v in losses.items()},
                                  grads=jax.device_get(grads), new_params=jax.device_get(new_params),
                                  bn_stats=state_dict_from_jax(jax.device_get(bn_stats))),
        port=make_grad_fn(cfg)(state.model, batch, torch.Generator().manual_seed(0)),
        nudged=make_grad_fn(cfg)(state.model, dict(batch, images=np.nextafter(batch["images"], np.inf)),
                                 torch.Generator().manual_seed(0))[2],
    )


def fresh_state(run, cfg=None):
    state = create_train_state(cfg or run.cfg, seed=0, total_steps=TOTAL_STEPS, device="cpu")
    state.model.load_state_dict(run.port_sd)
    return state


def test_step_loss_and_gradients_match(run):
    total, losses, grads, _, _ = run.port
    for k, want in run.jax.losses.items():  # fp32 sums in other orders
        np.testing.assert_allclose(losses[k].item(), want, rtol=2e-5, err_msg=k)
    np.testing.assert_allclose(total.item(), run.jax.total, rtol=2e-5)
    want = named_parameters_from_jax(run.jax.grads, run.model)
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name]
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        nudge = (g - run.nudged[name]).abs().max().item()
        # the PE MLPs' last biases have an exact gradient of 0: both give
        # noise of ~1e-9, under the 1e-8 floor
        bound = NUDGE_MARGIN * max(nudge, 1e-4 * scale) + 1e-8
        assert err <= bound, f"{name}: max abs err {err:.3e}, the nudge's {nudge:.3e}, max |grad| {scale:.3e}"


def test_step_batch_moments_match(run):
    stats = run.port[4]
    n_bn = sum(isinstance(m, FrozenBatchNorm) for m in run.model.modules())
    assert len(stats) == 2 * n_bn
    assert_moments_close(stats, run.jax.bn_stats)


def test_one_step_updates_and_ema_match(run):
    state = fresh_state(run)
    state, metrics = make_train_step(run.cfg)(state, run.batch, torch.Generator().manual_seed(0))
    assert metrics["skipped"] == 0 and state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), run.jax.total, rtol=2e-5)
    want = state_dict_from_jax(run.jax.new_params, state.model)
    lr0 = state.lr_schedule(0)
    jgrads = named_parameters_from_jax(run.jax.grads, run.model)
    gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in jgrads.values()]))
    clip = min(1.0, run.cfg.train.optim.grad_clip_norm / gnorm.item())
    for name, p in state.model.named_parameters():
        # as tests/test_torch_port_train.py: Adam's first step moves an entry
        # by about lr; entries whose clipped gradient is near eps, or whose
        # gradient the two packages put less than twice their distance from
        # 0 (NUDGE_MARGIN: the sign itself is noise), to 2 lr, the others to
        # a hundredth of lr, plus the fp32 rounding
        jg, pg = jgrads[name] * clip, run.port[2][name] * clip
        loose = (jg.abs() < 1e-6) | ((jg - pg).abs() * 2 >= jg.abs())
        bound = torch.where(loose, 2.0 * lr0, 1e-2 * lr0) + 1e-6 * run.port_sd[name].abs()
        err = (p.detach() - want[name]).abs()
        assert (err <= bound).all(), f"{name}: {err.max().item():.3e}"
    buffers = dict(state.model.named_buffers())
    ema = {k: buffers[k] for k in run.jax.bn_stats}
    assert_moments_close(ema, {k: want[k] for k in ema}, "EMA'd")
    for key, v in ema.items():  # moved by momentum x (batch - running), and once
        m = run.cfg.model.backbone.bn_momentum
        torch.testing.assert_close(v, (1 - m) * run.port_sd[key] + m * run.port[4][key], rtol=1e-6, atol=1e-7)


def test_skipped_step_still_emas_the_statistics(run):
    state = fresh_state(run)
    bad = dict(run.batch, images=run.batch["images"].copy())
    bad["images"][0, 0, 0, 0, 0] = np.inf
    state, metrics = make_train_step(run.cfg)(state, bad, torch.Generator().manual_seed(0))
    assert metrics["skipped"] == 1 and state.step == 1
    params = dict(state.model.named_parameters())
    for name, p in params.items():
        assert torch.equal(p.detach(), run.port_sd[name]), name
    moved = [k for k, b in state.model.named_buffers() if not torch.equal(b, run.port_sd[k])]
    assert len(moved) == len(run.port[4])


def test_combine_over_micro_batches_matches_petr_tpu(run):
    grad_fn = make_grad_fn(run.cfg)
    batch = random_batch(run.cfg, 4, seed=5)
    _, _, _, combined = accumulate_grads(grad_fn, run.model, batch, torch.Generator().manual_seed(0), 2)
    gen = torch.Generator().manual_seed(0)
    parts = [grad_fn(run.model, {k: v[i::2] for k, v in batch.items()}, gen)[4] for i in range(2)]
    tree = {}
    for key in parts[0]:
        module, leaf = key.rsplit(".running_", 1)
        tree.setdefault(module, {})[leaf] = jnp.stack([jnp.asarray(p[key].numpy()) for p in parts])
    want = jax_combine(tree, lambda x: jnp.mean(x, axis=0))
    want = {f"{m}.running_{leaf}": torch.from_numpy(np.array(v)) for m, d in want.items() for leaf, v in d.items()}
    assert_moments_close(combined, want, "combined")
    # the first BN's input does not depend on any batch's moments: there the
    # combine gives the whole batch's moments, to the O(1/n) (n = 2 x 6 x
    # 16 x 40 per micro-batch) that the Bessel-corrected entries leave
    whole = grad_fn(run.model, batch, torch.Generator().manual_seed(0))[4]
    for key in ("img_backbone.stem.stem_1/norm.running_mean", "img_backbone.stem.stem_1/norm.running_var"):
        torch.testing.assert_close(combined[key], whole[key], rtol=1e-3, atol=1e-6, msg=key)


def test_remat_on_and_off_give_the_same_statistics(run):
    """A checkpointed block runs its forward again in the backward: the
    statistics are folded in once either way."""
    cfg_remat = dataclasses.replace(run.cfg, model=dataclasses.replace(run.cfg.model, remat=True))
    out = {}
    for cfg in (run.cfg, cfg_remat):
        state = fresh_state(run, cfg)
        make_train_step(cfg)(state, run.batch, torch.Generator().manual_seed(0))
        out[cfg.model.remat] = dict(state.model.named_buffers())
    m = run.cfg.model.backbone.bn_momentum
    for key, moment in run.port[4].items():
        once = (1 - m) * run.port_sd[key] + m * moment
        torch.testing.assert_close(out[True][key], out[False][key], rtol=1e-6, atol=1e-7, msg=key)
        torch.testing.assert_close(out[True][key], once, rtol=1e-6, atol=1e-7, msg=key)


# ---------------------------------------------------------------- BN warm-up
@pytest.mark.parametrize("family", ["vovnet", "depthr"])
def test_estimate_bn_stats_matches_petr_tpu(family):
    if family == "vovnet":
        cfg = get_config("tiny_debug", ("model.use_flash_attention=False",))
        jcfg = jax_config("tiny_debug", ("model.use_flash_attention=False",))
        batches = [random_batch(cfg, 2, seed) for seed in (7, 8)]
        model = init_weights(PETRDetector(cfg.model), 3)
        params = jax_params_of(model, jcfg, batches[0])
    else:
        cfg, jcfg = tiny(get_config("synth_small_depthr")), tiny(jax_config("synth_small_depthr"))
        batches = [oracle_batch(2, seed) for seed in (7, 8)]
        jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
        params = init_params(JDetector(jcfg.model), 14, *[jb[k] for k in ("images", "img2lidar", "img_hw")],
                             **jax_kwargs(batches[0]))
        model = PETRDetector(cfg.model)
        model.load_state_dict(state_dict_from_jax(params, model))
        params = jax.tree.map(jnp.asarray, params)
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    want = state_dict_from_jax(jax.device_get(jax_estimate_bn_stats(
        jcfg, params, [{k: jnp.asarray(v) for k, v in b.items()} for b in batches])), model)
    assert estimate_bn_stats(cfg, model, batches) is model
    assert model.training and all(m.training for m in model.modules())
    assert not any(m.use_batch_stats for m in model.modules() if isinstance(m, FrozenBatchNorm))
    got = model.state_dict()
    stat_keys = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert stat_keys and all(not torch.equal(got[k], before[k]) for k in stat_keys)
    assert_moments_close({k: got[k] for k in stat_keys}, {k: want[k] for k in stat_keys}, "estimated")
    for k in got:  # nothing else moved
        if k not in stat_keys:
            assert torch.equal(got[k], before[k]), k


def test_estimate_bn_stats_of_no_batches_leaves_the_model():
    cfg = get_config("tiny_debug")
    model = init_weights(PETRDetector(cfg.model), 3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    estimate_bn_stats(cfg, model, [])
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
