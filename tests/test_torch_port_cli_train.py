"""The port's training CLI (``python -m petr_tpu_torch.cli.train``) and its
synthetic train-and-score harness (``python -m
petr_tpu_torch.tools.synth_train_eval``) on the CPU, over synthetic scenes
rendered at tiny_debug's 32x80.

Against petr_tpu: a ``tiny_debug`` run of the CLI in fp32 with dropout 0
and no GridMask, 3 steps, starts from petr_tpu's ``create_train_state``
weights (carried over by ``utils/convert.py`` and given by ``--load-from``)
and logs the per-step losses of a loop of petr_tpu's ``make_train_step``
over petr_tpu's ``Loader`` with the same seed, within rtol 1e-4 (fp32 in
other orders, through 3 updates). Both run the plain attention and
petr_tpu no remat, which changes no number (tests/test_torch_port_train.py
holds the flash kernels and remat); the Pallas interpret mode would only
add compile time. Both loaders decode through PIL.

The CLI on its own: SIGTERM in a process of its own checkpoints at the
step boundary and exits 0, and ``--resume`` continues from that step,
replaying its epoch; two runs with the same seed log the same losses bit
for bit; ``--eval-infos`` logs ``val/`` keys equal to ``evaluate_model``'s
on the epoch's checkpoint; the unported options raise. The harness prints
the original's JSON keys and exits 1 below ``--floor``.
"""

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petr_tpu.configs import get_config as jax_config
from petr_tpu.data import Loader as JLoader
from petr_tpu.data import NuScenesDataset as JDataset
from petr_tpu.data.synthetic import SYNTH_CLASSES as JAX_SYNTH_CLASSES
from petr_tpu.metrics.nuscenes import evaluate_detections as jax_evaluate_detections
from petr_tpu.train import create_train_state as jax_create_train_state
from petr_tpu.train import make_train_step as jax_make_train_step
from petr_tpu_torch.cli import train as cli
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.data import NuScenesDataset, generate_synthetic_scenes
from petr_tpu_torch.models import PETRDetector
from petr_tpu_torch.tools import synth_train_eval
from petr_tpu_torch.train import checkpoint, create_train_state
from petr_tpu_torch.train.evaluate import evaluate_model
from petr_tpu_torch.utils import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 80)
# tiny_debug on the synthetic scenes: their source size, no dropout, the
# plain attention, no remat
PARITY = ("data.src_hw=(32,80)", "model.head.dropout_rate=0.0", "model.use_flash_attention=False",
          "model.remat=False")
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs, as it was after: its
    CPU train steps, in a run of several test processes at once, otherwise
    contend for every core with the others."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """3 scenes of 2 frames at 32x80, 1 held out: 4 train and 2 val samples."""
    root = tmp_path_factory.mktemp("synth")
    generate_synthetic_scenes(str(root), n_scenes=3, frames_per_scene=2, image_hw=HW, n_objects=6,
                              val_scenes=1, seed=2)
    return root


def train_args(synth, work, *extra, config="tiny_debug", overrides=("data.src_hw=(32,80)",)):
    # one checkpoint kept per run: a tiny_debug state with its AdamW moments is ~270 MB
    return ["--config", config, "--infos", str(synth / "synth_infos_train.pkl"), "--work-dir", str(work),
            "--batch-size", "2", "--log-every", "1", "--device", "cpu",
            "--set", "train.max_keep_ckpts=1", *overrides, *extra]


def logged(work):
    with open(os.path.join(work, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def step_losses(work):
    return {r["step"]: r["loss"] for r in logged(work) if "loss" in r}


# --------------------------------------------------------- against petr_tpu
def test_cli_losses_match_petr_tpu_step_loop(synth, tmp_path, monkeypatch):
    monkeypatch.setattr("petr_tpu.data.native.available", lambda: False)  # both decode through PIL
    jcfg = jax_config("tiny_debug", PARITY)
    assert jcfg.model.compute_dtype == "float32" and not jcfg.model.use_grid_mask
    epochs, steps = 2, 3
    jds = JDataset.from_pkl(str(synth / "synth_infos_train.pkl"), jcfg.data, training=True)
    jloader = JLoader(jds, 2, seed=0)
    total = len(jloader) * epochs
    sample = next(iter(jloader.epoch(0)))
    sample.pop("tokens")
    # under one jit: eagerly, its init compiles some 470 small programs
    jstate = jax.jit(lambda b: jax_create_train_state(jcfg, jax.random.PRNGKey(0), total, b))(
        {k: jnp.asarray(v) for k, v in sample.items()})
    # petr_tpu's weights into a port checkpoint for --load-from
    cfg = get_config("tiny_debug", PARITY)
    state = create_train_state(cfg, 1, total, "cpu")
    state.model.load_state_dict(state_dict_from_jax(jax.device_get(jstate.params), state.model))
    init = checkpoint.save_checkpoint(str(tmp_path / "init"), 0, state)

    step_fn = jax.jit(jax_make_train_step(jcfg))
    rng = jax.random.PRNGKey(1)
    want = {}
    for epoch in range(epochs):
        for batch in jloader.epoch(epoch):
            batch.pop("tokens")
            jstate, metrics = step_fn(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
            want[int(jstate.step)] = float(metrics["loss"])
            if len(want) == steps:
                break
        if len(want) == steps:
            break

    cli.main(train_args(synth, tmp_path / "work", "--epochs", str(epochs), "--max-steps", str(steps),
                        "--load-from", init, overrides=PARITY))
    got = step_losses(tmp_path / "work")
    assert sorted(got) == sorted(want) == [1, 2, 3]
    for step, loss in want.items():
        np.testing.assert_allclose(got[step], loss, rtol=LOSS_RTOL, err_msg=f"step {step}")


# ---------------------------------------------------------------- on its own
def test_sigterm_checkpoints_and_resume_continues(synth, tmp_path, capsys):
    work = tmp_path / "work"
    args = train_args(synth, work, "--epochs", "3")
    proc = subprocess.Popen([sys.executable, "-m", "petr_tpu_torch.cli.train", *args], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2"), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        for line in proc.stdout:  # SIGTERM once step 3 (of 6; the second epoch's first) is logged
            lines.append(line)
            if line.startswith("{") and json.loads(line).get("step", 0) >= 3:
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    lines.append(out)
    stopped = max(step_losses(work))
    assert proc.returncode == 0, err[-3000:]
    assert f"checkpoint saved at step {stopped}; exiting on signal {int(signal.SIGTERM)}" in "".join(lines)
    assert stopped < 6
    assert checkpoint.latest_checkpoint(str(work / "ckpts")).endswith(f"step_{stopped:08d}")

    cli.main(args + ["--resume"])
    printed = capsys.readouterr().out
    assert f"resumed from {work / 'ckpts'}/step_{stopped:08d} at step {stopped}" in printed
    steps = [r["step"] for r in logged(work) if "loss" in r]
    resumed = steps[steps.index(stopped) + 1:]
    # petr_tpu's semantics: the interrupted epoch is replayed from its start
    # with the step count going on, then the epochs after it
    assert resumed == list(range(stopped + 1, stopped + 1 + 2 * (3 - stopped // 2)))
    assert checkpoint.latest_checkpoint(str(work / "ckpts")).endswith(f"step_{resumed[-1]:08d}")


@pytest.fixture(scope="module")
def two_runs(synth, tmp_path_factory):
    """The same seed twice (dropout 0.1 and the flash route's plain version,
    as tiny_debug says), one epoch; the first also evaluates, the second
    asks for tensorboard where it cannot be imported. Returns the work
    directories and what the second printed."""
    works = [tmp_path_factory.mktemp(f"run{i}") for i in range(2)]
    cli.main(train_args(synth, works[0], "--epochs", "1", "--eval-infos", str(synth / "synth_infos_val.pkl")))
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()) as out:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # its import raises ImportError
        cli.main(train_args(synth, works[1], "--epochs", "1", "--tensorboard"))
    return works, out.getvalue()


def test_same_seed_same_losses_bit_for_bit(two_runs):
    a, b = (step_losses(w) for w in two_runs[0])
    assert sorted(a) == [1, 2] and a == b
    assert get_config("tiny_debug").model.head.dropout_rate > 0


def test_eval_infos_logs_evaluate_model(synth, two_runs):
    work = two_runs[0][0]
    rec = [r for r in logged(work) if any(k.startswith("val/") for k in r)]
    assert len(rec) == 1 and rec[0]["step"] == 2
    cfg = get_config("tiny_debug", ("data.src_hw=(32,80)",))
    model = PETRDetector(cfg.model)
    checkpoint.load_params(checkpoint.latest_checkpoint(str(work / "ckpts")), model)
    want = evaluate_model(cfg, model.eval(),
                          NuScenesDataset.from_pkl(str(synth / "synth_infos_val.pkl"), cfg.data, training=False))
    assert {k: v for k, v in rec[0].items() if k.startswith("val/")} == {f"val/{k}": v for k, v in want.items()}


def test_checkpoint_meta_names_the_config_and_classes(two_runs):
    path = checkpoint.latest_checkpoint(str(two_runs[0][1] / "ckpts"))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == {"classes", "config"} and meta["config"]["name"] == "tiny_debug"
    assert meta["classes"][0] == "car" and len(meta["classes"]) == 10


def test_tensorboard_falls_back_to_json(two_runs):
    works, printed = two_runs
    assert "tensorboard unavailable; scalar logging stays JSON-only" in printed
    assert not os.path.exists(works[1] / "tb") and step_losses(works[1])


@pytest.mark.parametrize("extra", [["--num-processes", "2"], ["--coordinator", "localhost:1234"]])
def test_more_than_one_process_is_not_ported(synth, tmp_path, extra):
    with pytest.raises(NotImplementedError, match="item 10"):
        cli.main(train_args(synth, tmp_path, *extra))


def test_the_card_is_the_default(synth, tmp_path):
    args = [a for a in train_args(synth, tmp_path) if a not in ("--device", "cpu")]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(args)


# ------------------------------------------------------------------ harness
def harness_args(tmp_path, *extra):
    return ["--config", "tiny_debug", "--image-hw", "32", "80", "--scenes", "3", "--val-scenes", "1",
            "--frames", "2", "--batch-size", "1", "--device", "cpu", "--out-dir", str(tmp_path / "synth"), *extra]


def test_harness_prints_the_originals_json_keys(tmp_path, capsys):
    synth_train_eval.main(harness_args(tmp_path, "--steps", "3", "--floor", "0", "--bn-warmup", "2"))
    out = capsys.readouterr().out
    rec = json.loads([line for line in out.splitlines() if line.startswith('{"steps"')][-1])
    # tools/synth_train_eval.py's line: these four, then val/ and every key
    # of petr_tpu's evaluator over the three synthetic classes
    metric_keys = jax_evaluate_detections({}, {}, classes=JAX_SYNTH_CLASSES)
    assert set(rec) == {"steps", "train_loss_first", "train_loss_last", "wall_s"} | {f"val/{k}" for k in metric_keys}
    assert rec["steps"] == 3 and np.isfinite(rec["train_loss_last"])
    assert "bn-warmup: estimated BN stats from 2 batches" in out and "SYNTH TRAIN/EVAL OK" in out


def test_harness_exits_1_below_the_floor(tmp_path, capsys):
    with pytest.raises(SystemExit) as exit_:
        synth_train_eval.main(harness_args(tmp_path, "--steps", "1", "--floor", "1.0"))
    assert exit_.value.code == 1
    assert re.search(r"FAIL: held-out mAP \d\.\d{3} < floor 1\.0", capsys.readouterr().out)
