"""A tiny CPU rehearsal of each kind of cell: ``correct`` holds on the port,
falls on each fault the kind can have, and nothing of JAX is loaded."""

import subprocess
import sys

import pytest
import torch

from h100_bench.harness import REPO, run_cell
from h100_bench.tiny_root import make_tiny_root

SEED = 2**33 + 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", ["tiny_serve", "tiny_train", "tiny_infer"])
def test_rehearsal_is_correct(root, cell):
    res = run_cell(cell, SEED, 0.5, False, "cpu", root=root)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2


def test_traced_rehearsal_reads_its_metrics(root):
    res = run_cell("tiny_train", SEED, 0.5, True, "cpu", root=root)
    assert res["correct"] and "window_s" in res["device"] and "breakdown" in res
    assert set(res["metrics"]) <= {"mfu_pct.train", "attn_roofline_pct.train", "dcn_bwd_roofline_pct.train",
                                   "idle_pct.train"}


def _altered_serving(make):
    def wrapped(*a, **k):
        fn = make(*a, **k)

        def serve(*inputs):
            out = fn(*inputs)
            out["scores"] = out["scores"].copy()
            out["scores"][0] += 0.05  # the first answer of every call: its scores
            return out
        return serve
    return wrapped


def _sizes_exchanged(make):
    def wrapped(*a, **k):
        fn = make(*a, **k)

        def serve(*inputs):
            out = fn(*inputs)
            out["boxes"] = out["boxes"].copy()
            out["boxes"][..., [3, 4]] = out["boxes"][..., [4, 3]]  # every box: width and length exchanged
            return out
        return serve
    return wrapped


def _answers_exchanged(make):
    def wrapped(*a, **k):
        fn = make(*a, **k)
        last = []

        def serve(*inputs):
            out = fn(*inputs)
            last.append(out)
            return last[-2] if len(last) > 1 else out  # every call after the first: the call before's answers
        return serve
    return wrapped


def _altered_eval(make):
    def wrapped(*a, **k):
        step = make(*a, **k)

        def run(model, batch):
            out = dict(step(model, batch))
            out["scores"] = out["scores"].clone()
            out["scores"][0] += 0.05  # the first answer of every batch: its scores
            return out
        return run
    return wrapped


def _unchanged_state(make):
    def wrapped(cfg, *a, **k):
        def step(state, batch, generator):
            return state, {"loss": torch.tensor(1.0), "skipped": 0}
        return step
    return wrapped


def _half_batch(make):
    def wrapped(cfg, *a, **k):
        real = make(cfg, *a, **k)

        def step(state, batch, generator):
            return real(state, {key: v[: len(v) // 2] for key, v in batch.items()}, generator)
        return step
    return wrapped


@pytest.mark.parametrize("cell, module, attr, fault", [
    ("tiny_serve", "petr_tpu_torch.serve", "make_serving_fn", _altered_serving),
    ("tiny_serve", "petr_tpu_torch.serve", "make_serving_fn", _sizes_exchanged),
    ("tiny_serve", "petr_tpu_torch.serve", "make_serving_fn", _answers_exchanged),
    ("tiny_infer", "petr_tpu_torch.train.train_step", "make_eval_step", _altered_eval),
    ("tiny_train", "petr_tpu_torch.train.train_step", "make_train_step", _unchanged_state),
    ("tiny_train", "petr_tpu_torch.train.train_step", "make_train_step", _half_batch),
], ids=["answer_altered", "sizes_exchanged", "answers_exchanged", "eval_answer_altered", "state_unchanged",
        "half_batch"])
def test_each_fault_turns_correct_false(root, monkeypatch, cell, module, attr, fault):
    mod = __import__(module, fromlist=[attr])
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    res = run_cell(cell, SEED, 0.5, False, "cpu", root=root)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["tiny_serve", "tiny_infer", "tiny_train"])
def test_control_fails_the_tiny_limits(root, cell):
    """The control in the program's place comes out not correct under the
    benchmark's own judgment, as calibrate prints it."""
    from h100_bench.calibrate import held

    keep = {}
    res = run_cell(cell, SEED, 0.5, False, "cpu", root=root, keep=keep)
    program = {k: v["value"] for k, v in res["checks"].items()}
    control = held(program, keep["driver"].control(), keep["driver"].run.cell.limits)
    assert res["correct"] and not control["correct"], control


def test_the_faults_calibrate_reads_fail_the_tiny_serve_limits(root):
    from h100_bench.calibrate import held

    keep = {}
    res = run_cell("tiny_serve", SEED, 0.5, False, "cpu", root=root, keep=keep)
    program = {k: v["value"] for k, v in res["checks"].items()}
    faults = keep["driver"].faults()
    assert set(faults) == {"answers_exchanged", "sizes_exchanged", "labels_shifted"}
    for name, numbers in faults.items():
        assert not held(program, numbers, keep["driver"].run.cell.limits)["correct"], (name, numbers)


def test_no_jax_after_a_rehearsal(root):
    code = ("import sys; from pathlib import Path; from h100_bench.harness import run_cell, forbidden_modules; "
            f"run_cell('tiny_infer', 7, 0.3, False, 'cpu', root=Path({str(root)!r})); "
            "print(forbidden_modules()); print(sorted(m for m in sys.modules if m.split('.')[0] == 'petr_tpu_torch')[:1])")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    assert lines[-2] == "[]"  # no jax, jaxlib, flax or petr_tpu, compared by whole top-level names
    assert lines[-1] == "['petr_tpu_torch']"  # the port was loaded, and petr_tpu_torch is not petr_tpu
