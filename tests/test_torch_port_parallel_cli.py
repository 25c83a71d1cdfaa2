"""The port's multi-process entry points on the CPU (slow: each starts
several processes): ``python -m petr_tpu_torch.cli.train`` over 2 Gloo
ranks, as petr_tpu's `tests/test_multiprocess_train.py` runs its CLI over 2
JAX processes; ``dryrun_multichip(4)``; ``python -m
petr_tpu_torch.cli.scaling``.

* 2 ranks, global batch 4, 2 steps: both exit 0, rank 0 alone logs and
  checkpoints, the losses are finite;
* 2 ranks for an epoch with the eval hook on 7 val samples (the ranks
  decode 4 and 3): the logged metrics equal ``evaluate_model`` of the saved
  checkpoint in this process within 1e-6;
* SIGTERM to both ranks: both exit 0 at one step, rank 0 checkpointed it;
* a resume where rank 1's work directory holds no checkpoint (ranks that
  share no file system): both ranks take rank 0's state, and the run ends
  on the weights of the run that was never stopped, bit for bit;
* ``dryrun_multichip(4)``: data 2 x model 2 (the model axis asked for) and
  petr_tpu's default rule (model 4), a finite loss on every rank;
* ``cli.scaling`` at 1 and 2 ranks: one JSON record each, marked as no
  scaling figure.
"""

import json
import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from petr_tpu_torch.configs import get_config
from petr_tpu_torch.data import NuScenesDataset, generate_synthetic_scenes
from petr_tpu_torch.models import PETRDetector
from petr_tpu_torch.parallel.distributed import free_port
from petr_tpu_torch.parallel.dryrun import dryrun_multichip
from petr_tpu_torch.train.checkpoint import latest_checkpoint
from petr_tpu_torch.train.evaluate import evaluate_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ("--config", "tiny_debug", "--set", "data.src_hw=(32,80)", "model.head.dropout_rate=0.0")
EVAL_TOL = 1e-6

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """8 train samples and 7 val samples at tiny_debug's 32x80."""
    root = tmp_path_factory.mktemp("synth")
    generate_synthetic_scenes(str(root), n_scenes=3, frames_per_scene=4, image_hw=(32, 80), n_objects=6,
                              val_scenes=1, seed=4)
    with open(root / "synth_infos_val.pkl", "rb") as f:
        data = pickle.load(f)
    extra = generate_synthetic_scenes(str(root / "more"), n_scenes=1, frames_per_scene=3, image_hw=(32, 80),
                                      n_objects=6, val_scenes=1, seed=5)["val"]
    with open(root / "val7.pkl", "wb") as f:
        pickle.dump({**data, "infos": list(data["infos"]) + list(extra)}, f)
    return root


def launch(synth, work, *extra, n=2, signal_after=None, works=None):
    """``cli.train`` as ``n`` Gloo ranks on the CPU -> each rank's output;
    ``works`` gives each rank its own work directory."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, GLOO_SOCKET_IFNAME="lo", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "petr_tpu_torch.cli.train", *CFG, "--infos", str(synth / "synth_infos_train.pkl"),
         "--work-dir", str(works[r] if works else work), "--log-every", "1", "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(n), "--process-id", str(r), *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)]
    head = ""
    try:
        if signal_after is not None:
            for line in procs[0].stdout:
                head += line
                if line.startswith('{"epoch"') and json.loads(line).get("step", 0) >= signal_after:
                    for p in procs:
                        p.send_signal(signal.SIGTERM)
                    break
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    outs[0] = head + outs[0]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return outs


def logged(work):
    with open(work / "train_log.jsonl") as f:
        return [json.loads(line) for line in f]


def test_two_rank_cli_train(synth, tmp_path):
    work = tmp_path / "work"
    outs = launch(synth, work, "--batch-size", "4", "--max-steps", "2")
    recs = [r for r in logged(work) if "loss" in r]
    assert [r["step"] for r in recs] == [1, 2] and all(np.isfinite(r["loss"]) for r in recs)
    assert latest_checkpoint(str(work / "ckpts")).endswith("step_00000002")
    assert '{"env"' in outs[0] and '{"env"' not in outs[1] and '{"epoch"' not in outs[1]
    assert json.loads([x for x in outs[0].splitlines() if x.startswith('{"env"')][0])["env"]["processes"] == 2


def test_two_rank_eval_hook_equals_one_process(synth, tmp_path):
    work = tmp_path / "work"
    outs = launch(synth, work, "--batch-size", "4", "--epochs", "1", "--eval-infos", str(synth / "val7.pkl"))
    assert "checkpoint saved" in outs[0] and "checkpoint saved" not in outs[1]
    vals = [r for r in logged(work) if "val/mAP" in r]
    assert len(vals) == 1
    cfg = get_config("tiny_debug", list(CFG[3:]))
    ds = NuScenesDataset.from_pkl(str(synth / "val7.pkl"), cfg.data, training=False)
    assert len(ds) == 7
    model = PETRDetector(cfg.model)
    ckpt = latest_checkpoint(str(work / "ckpts"))
    model.load_state_dict(torch.load(f"{ckpt}/state.pt", map_location="cpu", weights_only=True)["model"])
    want = evaluate_model(cfg, model.eval(), ds)
    for k, v in want.items():
        got = vals[0][f"val/{k}"]
        assert (np.isnan(v) and np.isnan(got)) or abs(got - v) <= EVAL_TOL, (k, got, v)


def test_sigterm_stops_both_ranks_at_one_step(synth, tmp_path):
    work = tmp_path / "work"
    outs = launch(synth, work, "--batch-size", "4", "--epochs", "20", signal_after=2)
    stopped = max(r["step"] for r in logged(work) if "loss" in r)
    assert stopped < 20 * 2
    assert f"checkpoint saved at step {stopped}; exiting on signal {int(signal.SIGTERM)}" in outs[0]
    assert f"rank 1: stopping at step {stopped}" in outs[1]
    assert latest_checkpoint(str(work / "ckpts")).endswith(f"step_{stopped:08d}")


def test_resume_without_rank_1s_checkpoints(synth, tmp_path):
    """2 epochs of 2 steps straight, against the same run stopped after
    its first epoch (``--max-steps 2``: one LR schedule) and resumed with
    rank 1 in an empty work directory: rank 1 would start at step 0 on its
    own draw of the weights, and the ranks' collectives would no longer
    pair up."""
    straight, stopped, alone = tmp_path / "straight", tmp_path / "stopped", tmp_path / "alone"
    launch(synth, straight, "--batch-size", "4", "--epochs", "2")
    launch(synth, stopped, "--batch-size", "4", "--epochs", "2", "--max-steps", "2")
    outs = launch(synth, stopped, "--batch-size", "4", "--epochs", "2", "--resume", works=(stopped, alone))
    assert "resumed from" in outs[0] and "step_00000002 at step 2" in outs[0]
    assert not (alone / "ckpts").exists()
    assert [r["step"] for r in logged(stopped) if "loss" in r] == [1, 2, 3, 4]
    a, b = (torch.load(f"{latest_checkpoint(str(w / 'ckpts'))}/state.pt", map_location="cpu", weights_only=True)
            for w in (straight, stopped))
    assert a["step"] == b["step"] == 4
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k


@pytest.mark.parametrize("model", [2, None])
def test_dryrun_multichip_four_ranks(model):
    rec = dryrun_multichip(4, device="cpu", model=model)
    assert tuple(rec["mesh"]) == ((2, 2) if model == 2 else (1, 4)) and np.isfinite(rec["loss"])


def test_scaling_cli_records(capsys):
    from petr_tpu_torch.cli import scaling

    results = scaling.main(["--devices", "1,2", "--device", "cpu", "--steps", "1", "--warmup", "1"])
    assert [r["devices"] for r in results] == [1, 2]
    assert results[0]["weak_scaling_efficiency"] == 1.0 and all("note" in r for r in results)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [p["devices"] for p in printed] == [1, 2]
