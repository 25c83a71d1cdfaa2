"""The port's sharded train step on 2 Gloo CPU ranks against its
one-process step and against petr_tpu's global-batch step.

petr_tpu runs its (data x model) step under GSPMD, which computes exactly
the step of the global batch; the port reaches it with explicit
collectives. ``tiny_debug`` in fp32 on a global batch of 2 (4 with
``grad_accum=2``), from one set of weights (a seeded draw with random
frozen-BN statistics, as tests/test_torch_port_train.py), each rank on its
rows:
* data 2 and data 1 x model 2 (the decoder's keys split over the ranks),
  with dropout 0.1, against the port's one-process step on the whole
  batch with the same generator: the loss within rtol 1e-6, every
  gradient within 1e-5 of its largest entry, the parameters after AdamW
  within 1e-7 (plus the fp32 rounding of the parameter). The ranks must
  draw the global batch's dropout masks, and the token shards the slice
  of the global hash (the key offset);
* the same with ``bn_mode="batch"`` (the BN moments of the global batch,
  and its running statistics after the step) and with ``grad_accum=2``;
* both layouts at dropout 0 against petr_tpu's step on the same global
  batch (its plain attention, no remat: the same numbers as its flash
  kernel, tests/test_torch_port_cli_train.py): the loss within rtol 2e-5,
  ``grad_norm`` within rtol 1e-4, as tests/test_torch_port_train.py.
* a resumed state where only rank 0 sees the checkpoint (ranks that share
  no file system): every rank ends with rank 0's weights, AdamW state and
  step, exactly.
* ``evaluate_model_multiprocess`` on 2 ranks over 7 val samples (the ranks
  decode 4 and 3) equals ``evaluate_model`` within 1e-6, and with fewer
  samples than ranks it raises on every rank (the launch fails).
"""

import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petr_tpu.configs import get_config as jax_config
from petr_tpu.models import PETRDetector as JDetector
from petr_tpu.train.train_step import make_grad_fn as jax_make_grad_fn
from petr_tpu.utils.torch_convert import convert_state_dict
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.data import NuScenesDataset, generate_synthetic_scenes
from petr_tpu_torch.models import PETRDetector, init_weights
from petr_tpu_torch.models.layers import FrozenBatchNorm
from petr_tpu_torch.parallel.distributed import spawn
from petr_tpu_torch.train import create_train_state, make_grad_fn, make_train_step, step_generator
from petr_tpu_torch.train.checkpoint import save_checkpoint
from petr_tpu_torch.train.evaluate import evaluate_model
from tests.test_heads import make_cams
from tests.test_torch_port_parallel_workers import eval_case, resume_case, train_case

SEED = 5
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL = 1e-6, 1e-5, 1e-7
# a gradient whose exact value is 0 (the PE MLPs' last biases shift every key of
# a query alike, which the softmax ignores) is cancellation noise: it is held to
# GRAD_RTOL of GRAD_FLOOR x the model's largest gradient entry (chip_smoke.py's
# STEP_GRAD_FLOOR)
GRAD_FLOOR = 1e-3
# a gradient through batch moments at tiny sizes is ill-conditioned (a one-ulp
# nudge of the images moves grad_norm by ~1e-5 here): the batch-BN cases hold it
# within NUDGE_MARGIN x what that nudge does to the one-process step
NUDGE_MARGIN = 3.0
JAX_LOSS_RTOL, JAX_NORM_RTOL = 2e-5, 1e-4
EVAL_TOL = 1e-6

# name -> (overrides of tiny_debug, (data, model), global batch, whether the gradients are compared
# besides the step's metrics and parameters)
CASES = {
    "data2": ((), (2, 1), 2, True),
    "model2": ((), (1, 2), 2, True),
    "data2_batch_bn": (("model.backbone.bn_mode=batch",), (2, 1), 2, False),
    "model2_batch_bn": (("model.backbone.bn_mode=batch",), (1, 2), 2, False),
    "data2_accum2": (("train.grad_accum=2",), (2, 1), 4, True),
    "data2_no_dropout": (("model.head.dropout_rate=0.0",), (2, 1), 2, False),
    "model2_no_dropout": (("model.head.dropout_rate=0.0",), (1, 2), 2, False),
}
JAX_CASES = ("data2_no_dropout", "model2_no_dropout")


def make_batch(cfg, B, seed=0):
    N, (H, W), G = cfg.data.num_views, cfg.data.image_size, cfg.data.max_gt
    rng = np.random.RandomState(seed)
    valid = np.zeros((B, G), bool)
    for b in range(B):
        valid[b, rng.permutation(G)[:5 + 2 * b]] = True
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
    batch["img_hw"][B - 1, 2] = [16, 48]  # a padded view: masked decoder keys
    return batch


def weights(cfg):
    """A seeded draw with random frozen-BN statistics (numpy state_dict)."""
    rng = np.random.RandomState(0)
    model = init_weights(PETRDetector(cfg.model), 0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def one_process(cfg, sd, batch, with_grads):
    """The port's step on the whole batch in this process."""
    def fresh():
        state = create_train_state(cfg, 0, 100, "cpu")
        state.model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        return state

    grads = {}
    if with_grads and cfg.train.grad_accum > 1:
        from petr_tpu_torch.train import accumulate_grads, batch_keys

        _, _, grads, _ = accumulate_grads(make_grad_fn(cfg), fresh().model, batch, step_generator(SEED, 0),
                                          cfg.train.grad_accum, batch_keys(cfg))
    elif with_grads:
        grads = make_grad_fn(cfg)(fresh().model, batch, step_generator(SEED, 0))[2]
    state, metrics = make_train_step(cfg)(fresh(), batch, step_generator(SEED, 0))
    return {"grads": {n: g.numpy() for n, g in grads.items()}, "lr": state.lr_schedule(0),
            "clip": cfg.train.optim.grad_clip_norm,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.numpy() for k, v in state.model.state_dict().items()}}


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(2)
    base = get_config("tiny_debug")
    sd = weights(base)
    cases, inputs = [], {}
    for name, (overrides, shape, B, with_grads) in CASES.items():
        cfg = get_config("tiny_debug", list(overrides))
        batch = make_batch(cfg, B)
        inputs[name] = (cfg, batch)
        cases.append((cfg, sd, batch, shape, SEED, with_grads))
    ranks = spawn(train_case, 2, "gloo", "cpu", args=(cases,))
    return types.SimpleNamespace(sd=sd, inputs=inputs, ranks={n: [r[i] for r in ranks] for i, n in enumerate(CASES)})


@pytest.fixture(scope="module")
def single(run):
    out = {name: one_process(cfg, run.sd, batch, CASES[name][3]) for name, (cfg, batch) in run.inputs.items()}
    for name, (cfg, batch) in run.inputs.items():
        if "batch_bn" in name:
            nudged = dict(batch, images=np.nextafter(batch["images"], np.float32(np.inf)))
            norm = out[name]["metrics"]["grad_norm"]
            out[name]["nudge"] = abs(one_process(cfg, run.sd, nudged, False)["metrics"]["grad_norm"] - norm) / norm
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_one_process(run, single, name):
    want = single[name]
    for rank, got in enumerate(run.ranks[name]):
        what = f"{name}, rank {rank}"
        np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=LOSS_RTOL, err_msg=what)
        norm_rtol = max(GRAD_RTOL, NUDGE_MARGIN * want.get("nudge", 0.0))
        np.testing.assert_allclose(got["metrics"]["grad_norm"], want["metrics"]["grad_norm"], rtol=norm_rtol,
                                   err_msg=what)
        assert got["metrics"]["num_pos"] == want["metrics"]["num_pos"], what
        if CASES[name][3]:
            assert set(got["grads"]) == set(want["grads"])
            top = max(np.abs(g).max() for g in want["grads"].values())
            for n, w in want["grads"].items():
                err = np.abs(got["grads"][n] - w).max()  # fp32 sums in other orders
                assert err <= GRAD_RTOL * max(np.abs(w).max(), GRAD_FLOOR * top), f"{what} {n}: {err:.3e}"
        # AdamW's first step moves an entry by about lr whatever its gradient; where
        # the clipped gradient is near Adam's eps, fp32 noise in it moves the update
        # by a good part of lr: such entries to 2 lr, the others to 1e-3 lr
        clip = min(1.0, want["clip"] / want["metrics"]["grad_norm"])
        for k, w in want["state"].items():
            if k.endswith(("running_mean", "running_var")):  # batch BN's: test_batch_bn_moments_are_the_global_batch
                assert "batch_bn" in name or np.array_equal(got["state"][k], w), f"{what} {k}"
                continue
            bound = PARAM_ATOL + 1e-6 * np.abs(w)
            if CASES[name][3] and k in want["grads"]:
                near_eps = np.abs(want["grads"][k] * clip) < 1e-6
                bound = bound + np.where(near_eps, 2.0, 1e-3) * want["lr"]
            else:
                bound = bound + 2.0 * want["lr"]
            err = np.abs(got["state"][k] - w)
            assert (err <= bound).all(), f"{what} {k}: max err {err.max():.3e}"



def test_ranks_hold_one_model(run):
    for name, (a, b) in run.ranks.items():
        for k in a["state"]:
            np.testing.assert_array_equal(a["state"][k], b["state"][k], err_msg=f"{name} {k}")


def test_batch_bn_moments_are_the_global_batch(run, single):
    """The running statistics after a batch-BN step: one EMA of the global
    batch's moments on every rank (not of each rank's own)."""
    for name in ("data2_batch_bn", "model2_batch_bn"):
        want = single[name]["state"]
        moved = [k for k in want if k.endswith("running_var") and not np.allclose(want[k], run.sd[k])]
        assert moved, "no running statistic moved"
        for got in run.ranks[name]:
            for k in moved:
                np.testing.assert_allclose(got["state"][k], want[k], rtol=1e-5, err_msg=f"{name} {k}")


@pytest.fixture(scope="module")
def jax_steps(run):
    out = {}
    for name in JAX_CASES:
        cfg, batch = run.inputs[name]
        jcfg = jax_config("tiny_debug", list(CASES[name][0]) + ["model.use_flash_attention=False",
                                                                "model.remat=False"])
        jmodel = JDetector(jcfg.model, deterministic=True)
        one = [jnp.asarray(batch[k][:1]) for k in ("images", "img2lidar", "img_hw")]
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *one)["params"]
        params, stats = convert_state_dict(run.sd, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
        assert stats["skipped"] == 0 and stats["unfilled"] == 0, stats
        total, losses, grads, _ = jax.jit(jax_make_grad_fn(jcfg))(
            jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
        norm = float(np.sqrt(sum(float(jnp.sum(g.astype(jnp.float32) ** 2)) for g in jax.tree.leaves(grads))))
        out[name] = {"loss": float(total), "grad_norm": norm}
    return out


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_step_matches_petr_tpu(run, jax_steps, name):
    want = jax_steps[name]
    for rank, got in enumerate(run.ranks[name]):
        np.testing.assert_allclose(got["metrics"]["loss"], want["loss"], rtol=JAX_LOSS_RTOL, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["metrics"]["grad_norm"], want["grad_norm"], rtol=JAX_NORM_RTOL,
                                   err_msg=f"rank {rank}")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """One val scene of 7 frames at tiny_debug's 32x80 (and 1 train scene)."""
    root = tmp_path_factory.mktemp("synth")
    generate_synthetic_scenes(str(root), n_scenes=2, frames_per_scene=7, image_hw=(32, 80), n_objects=6,
                              val_scenes=1, seed=3)
    few = root / "few.pkl"
    with open(root / "synth_infos_val.pkl", "rb") as f:
        data = pickle.load(f)
    with open(few, "wb") as f:
        pickle.dump({**data, "infos": data["infos"][:1]}, f)
    return root


def test_multiprocess_eval_equals_one_process(run, synth):
    cfg = get_config("tiny_debug", ["data.src_hw=(32,80)"])
    val = str(synth / "synth_infos_val.pkl")
    classes = ("car", "bus", "pedestrian")
    got = spawn(eval_case, 2, "gloo", "cpu", args=(cfg, run.sd, val, 1, classes))
    model = PETRDetector(cfg.model)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in run.sd.items()})
    want = evaluate_model(cfg, model.eval(), NuScenesDataset.from_pkl(val, cfg.data, training=False), 1,
                          classes=classes)
    assert len(NuScenesDataset.from_pkl(val, cfg.data, training=False)) == 7
    for rank, g in enumerate(got):
        assert set(g) == set(want), rank
        for k, v in want.items():
            assert (np.isnan(v) and np.isnan(g[k])) or abs(g[k] - v) <= EVAL_TOL, (rank, k, g[k], v)


def test_multiprocess_eval_raises_on_every_rank_below_one_sample_each(run, synth):
    cfg = get_config("tiny_debug", ["data.src_hw=(32,80)"])
    with pytest.raises(Exception, match="every process would not get a shard"):
        spawn(eval_case, 2, "gloo", "cpu", args=(cfg, run.sd, str(synth / "few.pkl")))


def test_ranks_take_rank_0s_resumed_state(run, tmp_path):
    cfg = get_config("tiny_debug")
    state = create_train_state(cfg, 0, 100, "cpu")
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in run.sd.items()})
    state, _ = make_train_step(cfg)(state, make_batch(cfg, 2), step_generator(SEED, 0))
    ckpt = save_checkpoint(str(tmp_path / "ckpts"), state.step, state)
    opt = state.optimizer.state_dict()
    adam = {f"{i}.{k}": v.numpy() for i, st in opt["state"].items() for k, v in st.items()}
    assert state.step == 1 and adam
    for rank, got in enumerate(spawn(resume_case, 2, "gloo", "cpu", args=(cfg, ckpt))):
        assert got["step"] == state.step and got["groups"] == opt["param_groups"], rank
        assert set(got["model"]) == set(state.model.state_dict()) and set(got["adam"]) == set(adam), rank
        for k, v in state.model.state_dict().items():
            np.testing.assert_array_equal(got["model"][k], v.numpy(), err_msg=f"rank {rank} {k}")
        for k, v in adam.items():
            np.testing.assert_array_equal(got["adam"][k], v, err_msg=f"rank {rank} adam {k}")
