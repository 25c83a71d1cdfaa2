"""The benchmark of the PyTorch/CUDA port: one run of one cell.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric sits in files of its own, found by the names in
``BENCHMARK.json``:

  * a configuration: the file its ``configs`` entry names (the port's
    preset, the shapes and settings as run, checked against the preset,
    the weight draw, ``assumed`` and ``reduced``);
  * a traffic mix: ``h100_bench/traffic/<traffic>.json``, read by the one
    generator (``traffic.py``) and the driver its ``kind`` names;
  * a per-layer metric: its reader ``h100_bench/metrics/<name>.py``
    (``read(ctx) -> float or None``) and, where it reads device time by
    name, ``h100_bench/metrics/<name>.json`` (the host ranges and the kernel
    names it counts);
  * a cell's limits for ``correct``: ``h100_bench/limits/<cell>.json``
    (the limits and the readings they were set from).

A run (``run_cell``) draws its inputs and weights from the seed, builds the
port's serving, training or evaluation path, warms up the cell's shapes
(set-up), measures for ``seconds``, checks what the timed path produced
against the plain reference (``reference/``), which imports nothing of the
port, and returns the result line. Nothing here imports JAX or petr_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from concurrent.futures import Future
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from h100_bench import flops, traffic
from h100_bench.inputs import draw_gt, draw_samples, draw_weights, seed_stream
from h100_bench.judge import detection_gaps, judge, train_gaps
from h100_bench.reference.model import Detector, exact_fp32, last_layer_table, normalize_bn_statistics
from h100_bench.trace import Trace

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "petr_tpu")
BETA1 = 0.9  # AdamW's first-moment decay, the port's and the reference's


# ------------------------------------------------------------ the files
@dataclasses.dataclass
class Cell:
    root: Path
    bench: Dict
    workload: Dict
    config: Dict
    mix: Dict
    limits: Dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[Dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def load_cell(name: str, root: Path = REPO) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = found[0]
    entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / "h100_bench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = root / "h100_bench" / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text())["limits"] if limits_file.exists() else {}
    return Cell(root, bench, w, config, mix, limits)


def load_reader(root: Path, name: str):
    """(read, data) of a per-layer metric: its module's ``read`` and its
    data file's contents ({} without one)."""
    path = root / "h100_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100_bench_metric_{len(sys.modules)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    data_file = path.with_suffix(".json")
    return module.read, (json.loads(data_file.read_text()) if data_file.exists() else {})


def port_config(config: Dict):
    """The port's preset with the file's overrides, after checking that
    every setting the file states is the preset's."""
    from petr_tpu_torch.configs import get_config

    cfg = get_config(config["preset"], config.get("overrides") or None)
    port = {"model": cfg.model, "data": cfg.data, "optim": cfg.train.optim, "decode": cfg}

    def check(path, want, have):
        if isinstance(want, dict):
            for k, v in want.items():
                check(f"{path}.{k}", v, getattr(have, k))
            return
        have = list(have) if isinstance(have, tuple) else have
        if want != have:
            raise ValueError(f"{path}: the configuration file says {want!r}, the port's preset runs {have!r}")

    for part, obj in port.items():
        check(part, config[part], obj)
    return cfg


def spec_of(config: Dict) -> Dict:
    """What the reference reads: the file's model and optimiser, and the
    decode's limits."""
    return {"model": config["model"], "optim": config["optim"]}


# ------------------------------------------------------------ the weights
def make_weights(cell: Cell, seed: int, port_model: torch.nn.Module, sample_images: np.ndarray, device) -> Dict:
    """The weights of the run on ``device``: drawn for the port's state_dict
    names, then the BN statistics set by the reference's backbone on one
    sample (its views) in fp32."""
    w = dict(cell.config["weights"], num_classes=cell.config["model"]["head"]["num_classes"])
    state = draw_weights(seed, port_model.state_dict(), w, device)
    ref = Detector(cell.config["model"]).to(device)
    ref.load_state_dict(state)
    x = torch.as_tensor(sample_images, device=device).permute(0, 3, 1, 2).contiguous()
    with exact_fp32():
        normalize_bn_statistics(ref.img_backbone, x)
    for name, t in ref.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            state[name] = t.detach().clone()
    del ref, x
    return {k: v.detach().cpu() for k, v in state.items()}


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    prof = profile(activities=acts, record_shapes=False, with_stack=False, profile_memory=False)
    prof.start()
    return prof


# ---------------------------------------------------------------- drivers
class Serve:
    """An open loop of single-sample requests through ``InferenceServer``
    over ``make_serving_fn`` at the mix's batch and delay."""

    def __init__(self, run: "Run"):
        self.run = run

    def setup(self):
        from petr_tpu_torch.configs import eval_model_config
        from petr_tpu_torch.models.detector import PETRDetector
        from petr_tpu_torch.serve import make_serving_fn, serving_input_spec

        r, mix = self.run, self.run.mix
        cfg = r.cfg
        self.B = mix["batch"]
        self.pool = draw_samples(r.seed, mix["pool"], cfg.data.num_views, tuple(cfg.data.image_size), r.device)
        with torch.device(r.device):
            model = PETRDetector(eval_model_config(cfg.model))
        r.state = make_weights(r.cell, r.seed, model, self.pool["images"][0], r.device)
        free(r.device)
        r.reset_peak()
        model.load_state_dict(r.state)
        model.eval()
        self.model = model
        fn = make_serving_fn(cfg, model, device=r.device)
        self.keys = tuple(serving_input_spec(cfg))
        self.calls: List[Tuple[float, float]] = []

        def serving(*inputs):
            t0 = time.perf_counter()
            out = fn(*inputs)
            self.calls.append((t0, time.perf_counter()))
            return out

        self.serving = serving
        self.open_server()
        for _ in range(2):  # the one shape: a full batch, through the server
            futs = [self.server.submit(self.sample(i)) for i in range(self.B)]
            [f.result() for f in futs]
        sync(r.device)
        self.calls.clear()

    def open_server(self):
        from petr_tpu_torch.serve import InferenceServer

        self.server = InferenceServer(self.serving, batch_size=self.B, input_keys=self.keys,
                                      max_delay_ms=self.run.mix["max_delay_ms"])

    def sample(self, i: int) -> Dict[str, np.ndarray]:
        return {k: self.pool[k][i] for k in self.keys}

    def window(self, seconds: float, trace: bool):
        r, mix = self.run, self.run.mix
        due = traffic.arrival_times(mix, seconds, r.seed)
        which = traffic.request_samples(len(due), mix["pool"], r.seed)
        n = len(due)
        done = [math.inf] * n
        self.futures: List[Future] = []
        late = []
        prof = start_profiler(r.device) if trace else None
        t0 = time.perf_counter()
        for i in range(n):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            if prof is not None and time.perf_counter() - t0 >= mix["trace_seconds"]:
                prof.stop()
                r.trace_window = time.perf_counter() - t0
                r.prof, prof = prof, None
                r.ctx["trace_end"] = time.perf_counter()
            late.append(time.perf_counter() - (t0 + due[i]))
            fut = self.server.submit(self.sample(which[i]))

            def finished(f, i=i):
                if f.exception() is None:
                    done[i] = time.perf_counter()

            fut.add_done_callback(finished)
            self.futures.append(fut)
        deadline = t0 + seconds + 60.0
        for f in self.futures:
            try:
                f.result(timeout=max(deadline - time.perf_counter(), 0.001))
            except Exception:  # counted as failed below
                pass
        if prof is not None:
            prof.stop()
            r.trace_window = time.perf_counter() - t0
            r.prof = prof
        self.server.close()
        r.window_s = seconds
        lat = [(d - (t0 + t)) * 1e3 for d, t in zip(done, due)]
        failed = sum(1 for f in self.futures if not f.done() or f.exception() is not None)
        k = max(int(math.ceil(0.95 * n)) - 1, 0)
        r.e2e["serve_p95_ms"] = sorted(lat)[k]
        r.attempted, r.failed = n, failed
        untraced = [c for c in self.calls if c[0] >= r.ctx.get("trace_end", t0)]
        r.ctx.update(calls=untraced, served=n - failed, all_calls=len(self.calls), batch=self.B,
                     generator_late_ms_p95=sorted(late)[k] * 1e3, latencies_ms=lat,
                     drain_s=max((d for d in done if d < math.inf), default=t0) - (t0 + seconds))
        self.which = which

    def check(self) -> Dict[str, float]:
        r = self.run
        del self.model, self.server
        free(r.device)
        finished = [i for i, f in enumerate(self.futures) if f.done() and f.exception() is None]
        picks = [finished[j] for j in traffic.check_sample(len(finished), r.mix["check_requests"], r.seed)]
        ref = r.reference_model()
        self.checked = []
        for i in picks:
            s = self.sample(self.which[i])
            self.checked.append((s, *r.reference_table(ref, s)))
        del ref
        self.answers = [self.futures[i].result() for i in picks]
        return dict(detection_numbers(r, self.answers, self.checked), failed_requests=float(r.failed))


class Infer:
    """A closed loop of ``make_eval_step`` batches, results copied to the host."""

    def __init__(self, run: "Run"):
        self.run = run

    def setup(self):
        from petr_tpu_torch.configs import eval_model_config
        from petr_tpu_torch.models.detector import PETRDetector
        from petr_tpu_torch.train.train_step import make_eval_step

        r, mix = self.run, self.run.mix
        cfg = r.cfg
        self.B = mix["batch"]
        n = mix["pool_batches"] * self.B
        pool = draw_samples(r.seed, n, cfg.data.num_views, tuple(cfg.data.image_size), r.device)
        self.batches = [{k: v[i * self.B:(i + 1) * self.B] for k, v in pool.items()}
                        for i in range(mix["pool_batches"])]
        with torch.device(r.device):
            model = PETRDetector(eval_model_config(cfg.model))
        r.state = make_weights(r.cell, r.seed, model, pool["images"][0], r.device)
        free(r.device)
        r.reset_peak()
        model.load_state_dict(r.state)
        self.model = model.eval()
        self.step = make_eval_step(cfg)
        self.kept: Dict[int, Dict[str, np.ndarray]] = {}
        for i in range(min(2, len(self.batches))):
            self.one(i)
        sync(r.device)

    def one(self, i: int):
        out = self.step(self.model, self.batches[i % len(self.batches)])
        host = {k: v.cpu().numpy() for k, v in out.items()}
        self.kept.setdefault(i % len(self.batches), host)
        return host

    def window(self, seconds: float, trace: bool):
        r = self.run
        steps, t0 = 0, time.perf_counter()
        if trace:
            prof = start_profiler(r.device)
            while time.perf_counter() - t0 < r.mix["trace_seconds"]:
                self.one(steps)
                steps += 1
            sync(r.device)
            prof.stop()
            r.trace_window, r.prof = time.perf_counter() - t0, prof
            r.ctx["trace_steps"] = steps
        t1, first = time.perf_counter(), steps
        while time.perf_counter() - t0 < seconds:
            self.one(steps)
            steps += 1
        sync(r.device)
        r.window_s = time.perf_counter() - t0
        r.ctx.update(untraced_steps=steps - first, untraced_s=time.perf_counter() - t1)
        r.e2e["infer_samples_per_s"] = steps * self.B / r.window_s
        r.attempted, r.failed = steps * self.B, 0
        r.ctx.update(samples=steps * self.B, batch=self.B)

    def check(self) -> Dict[str, float]:
        r = self.run
        del self.model
        free(r.device)
        B = self.B
        ref = r.reference_model()
        self.checked, self.answers = [], []
        for j in traffic.check_sample(len(self.batches) * B, r.mix["check_samples"], r.seed):
            b, row = divmod(j, B)
            self.answers.append({k: v[row] for k, v in self.kept[b].items()})
            s = {k: v[row] for k, v in self.batches[b].items()}
            self.checked.append((s, *r.reference_table(ref, s)))
        del ref
        return detection_numbers(r, self.answers, self.checked)


class Train:
    """``make_train_step`` at the mix's batch over its distinct host batches.
    Set-up takes the first ``checked_steps`` steps through the same call;
    the reference follows them after the window."""

    def __init__(self, run: "Run"):
        self.run = run

    def generator(self, step: int) -> torch.Generator:
        return torch.Generator().manual_seed(seed_stream(self.run.seed, 20, step))

    def setup(self):
        from petr_tpu_torch.models.detector import PETRDetector
        from petr_tpu_torch.train.optim import build_optimizer, make_lr_schedule
        from petr_tpu_torch.train.train_step import TrainState, make_train_step

        r, mix = self.run, self.run.mix
        cfg = r.cfg
        self.B = mix["batch"]
        P = mix["pool_batches"]
        pool = draw_samples(r.seed, P * self.B, cfg.data.num_views, tuple(cfg.data.image_size), r.device)
        pool.update(draw_gt(r.seed, P * self.B, cfg.data.max_gt, tuple(mix["gt_per_sample"]),
                            cfg.model.head.pc_range, cfg.model.head.num_classes))
        self.batches = [{k: v[i * self.B:(i + 1) * self.B] for k, v in pool.items()} for i in range(P)]
        # as create_train_state: reproducible steps (cuDNN's deterministic algorithms)
        torch.backends.cudnn.deterministic = True
        with torch.device(r.device):
            model = PETRDetector(cfg.model)
        r.state = make_weights(r.cell, r.seed, model, pool["images"][0], r.device)
        free(r.device)
        r.reset_peak()
        model.load_state_dict(r.state)
        model.train()
        opt = build_optimizer(cfg.train.optim, model, freeze_backbone_bn_affine=not cfg.model.backbone.train_bn_affine)
        self.ts = TrainState(0, model, opt, make_lr_schedule(cfg.train.optim, mix["total_steps"]))
        self.step_fn = make_train_step(cfg)
        self.losses, self.skipped, self.steps = [], 0, 0
        for _ in range(mix["checked_steps"]):
            m = self.one()
            self.losses.append(float(m["loss"]))
            if self.steps == 1:  # the first gradient from Adam's first moment, the clip undone
                gn = float(m.get("grad_norm", 0.0))
                unclip = 1.0 if gn < cfg.train.optim.grad_clip_norm else gn / cfg.train.optim.grad_clip_norm
                self.first_grad = {n: float(torch.linalg.vector_norm(opt.state[p]["exp_avg"])) / (1.0 - BETA1) * unclip
                                   for n, p in self.ts.trainable().items() if p in opt.state}
        self.change = {n: float(torch.linalg.vector_norm(p.detach().float() - r.state[n].to(p.device)))
                       for n, p in self.ts.trainable().items()}
        sync(r.device)

    def one(self):
        i = self.steps
        self.ts, m = self.step_fn(self.ts, self.batches[i % len(self.batches)], self.generator(i))
        self.skipped += int(m.get("skipped", 0))
        self.steps += 1
        return m

    def window(self, seconds: float, trace: bool):
        r = self.run
        done, t0 = 0, time.perf_counter()
        if trace:
            prof = start_profiler(r.device)
            while time.perf_counter() - t0 < r.mix["trace_seconds"]:
                self.one()
                done += 1
            sync(r.device)
            prof.stop()
            r.trace_window, r.prof = time.perf_counter() - t0, prof
            r.ctx["trace_steps"] = done
        t1, first = time.perf_counter(), done
        while time.perf_counter() - t0 < seconds:
            self.one()
            done += 1
        sync(r.device)
        r.window_s = time.perf_counter() - t0
        r.ctx.update(untraced_steps=done - first, untraced_s=time.perf_counter() - t1)
        r.e2e["train_samples_per_s"] = done * self.B / r.window_s
        r.attempted, r.failed = done, 0
        r.ctx.update(samples=done * self.B, batch=self.B)

    def check(self) -> Dict[str, float]:
        from h100_bench.reference.train import ReferenceTrainer

        r, mix = self.run, self.run.mix
        del self.ts, self.step_fn
        free(r.device)
        ref = ReferenceTrainer(spec_of(r.cell.config), {k: v.to(r.device) for k, v in r.state.items()}, r.device,
                               mix["total_steps"])
        losses, first = [], None
        with exact_fp32():
            for i in range(mix["checked_steps"]):
                b = {k: torch.as_tensor(v, device=r.device) for k, v in self.batches[i % len(self.batches)].items()}
                out = ref.step(b, self.generator(i))
                losses.append(out["loss"])
                if i == 0:
                    first = out
        change = {n: float(torch.linalg.vector_norm(p.detach() - r.state[n].to(r.device)))
                  for n, p in ref.trainable().items()}
        self.ref_numbers = (losses, first["raw"], change)
        self.leaves = {"program_grad": self.first_grad, "reference_grad": first["raw"],
                       "program_change": self.change, "reference_change": change, "reference_raw": first["raw"],
                       "program_losses": self.losses, "reference_losses": losses}
        del ref
        nums = train_gaps(self.losses, losses, self.first_grad, first["raw"], self.change, change)
        nums["skipped_steps"] = float(self.skipped)
        return nums

    def stand_in(self, rounding: bool, half: bool) -> Dict[str, float]:
        """The reference in the program's place, through the checked steps:
        with its products' operands rounded to e4m3 (the control), or on the
        first half of each batch with the mean taken over it (a fault); held
        to the reference as the program is."""
        from h100_bench.reference.model import operand_rounding
        from h100_bench.reference.train import ReferenceTrainer

        r, mix = self.run, self.run.mix
        free(r.device)
        sub = ReferenceTrainer(spec_of(r.cell.config), {k: v.to(r.device) for k, v in r.state.items()}, r.device,
                               mix["total_steps"])
        losses, first = [], None
        with exact_fp32(), operand_rounding(rounding):
            for i in range(mix["checked_steps"]):
                b = {k: torch.as_tensor(v[:len(v) // 2] if half else v, device=r.device)
                     for k, v in self.batches[i % len(self.batches)].items()}
                out = sub.step(b, self.generator(i))
                losses.append(out["loss"])
                if i == 0:
                    first = out
        change = {n: float(torch.linalg.vector_norm(p.detach() - r.state[n].to(r.device)))
                  for n, p in sub.trainable().items()}
        del sub
        r_losses, r_grad, r_change = self.ref_numbers
        return dict(train_gaps(losses, r_losses, first["raw"], r_grad, change, r_change), losses=losses)

    def control(self) -> Dict[str, float]:
        return self.stand_in(rounding=True, half=False)

    def faults(self) -> Dict[str, Dict[str, float]]:
        return {"half_batch": self.stand_in(rounding=False, half=True)}


def detection_numbers(run: "Run", answers, checked) -> Dict[str, float]:
    """A run's detection numbers: ``answers`` to the ``checked`` requests."""
    return detection_gaps(answers, [(scores, boxes) for _, scores, boxes in checked], run.cfg.model.head.pc_range)


def control_answers(run: "Run", checked) -> List[Dict[str, np.ndarray]]:
    """The reference in the program's place with its products' operands
    rounded to e4m3, decoded as the NMS-free decode picks (top max_det by
    score): the control's answers to the checked requests."""
    from h100_bench.reference.model import operand_rounding

    ref = run.reference_model()
    out = []
    for s, _, _ in checked:
        with operand_rounding():
            cs, cb = run.reference_table(ref, s)
        k = min(run.cfg.max_det, cs.numel())
        top, idx = torch.sort(cs.reshape(-1), descending=True, stable=True)
        C = cs.shape[1]
        out.append({"scores": top[:k].cpu().numpy(), "labels": (idx[:k] % C).cpu().numpy(),
                    "boxes": cb[idx[:k] // C].cpu().numpy(), "valid": np.ones(k, bool)})
    return out


def fault_answers(answers, num_classes: int) -> Dict[str, List[Dict[str, np.ndarray]]]:
    """The checked answers as faults of the timed path would leave them:
    each request given the next checked request's answer (answers exchanged
    between requests), every box's width and length exchanged (an error in
    the boxes alone), every label the next class (an error in the labels
    alone)."""
    def sizes_exchanged(a):
        b = np.array(a["boxes"], copy=True)
        b[..., [3, 4]] = b[..., [4, 3]]
        return dict(a, boxes=b)

    return {"answers_exchanged": answers[1:] + answers[:1],
            "sizes_exchanged": [sizes_exchanged(a) for a in answers],
            "labels_shifted": [dict(a, labels=(np.asarray(a["labels"]) + 1) % num_classes) for a in answers]}


def _detection_control(self) -> Dict[str, float]:
    return detection_numbers(self.run, control_answers(self.run, self.checked), self.checked)


def _detection_faults(self) -> Dict[str, Dict[str, float]]:
    faults = fault_answers(self.answers, self.run.cfg.model.head.num_classes)
    return {name: detection_numbers(self.run, ans, self.checked) for name, ans in faults.items()}


Serve.control = Infer.control = _detection_control
Serve.faults = Infer.faults = _detection_faults

DRIVERS = {"serve": Serve, "infer": Infer, "train": Train}


# ------------------------------------------------------------------- run
class Run:
    def __init__(self, cell: Cell, seed: int, device, t_start: float):
        self.cell, self.seed, self.device, self.t_start = cell, seed, torch.device(device), t_start
        self.mix = cell.mix
        self.cfg = port_config(cell.config)
        self.e2e: Dict[str, float] = {}
        self.ctx: Dict[str, Any] = {}
        self.prof = None
        self.trace_window = None
        self.state = None
        self.attempted = self.failed = 0

    def reset_peak(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def reference_model(self) -> Detector:
        ref = Detector(self.cell.config["model"]).to(self.device).eval()
        ref.load_state_dict({k: v.to(self.device) for k, v in self.state.items()})
        return ref

    @torch.no_grad()
    def reference_table(self, ref: Detector, sample: Dict[str, np.ndarray]):
        """The reference's per-query scores (Q, C) and boxes (Q, 9) for one sample."""
        args = [torch.as_tensor(np.asarray(sample[k])[None], device=self.device)
                for k in ("images", "img2lidar", "img_hw")]
        with exact_fp32():
            scores, boxes = last_layer_table(ref(*args))
        return scores[0], boxes[0]


def device_info(device) -> Dict[str, Any]:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    import subprocess

    name = torch.cuda.get_device_name(device)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i",
                                str(torch.device(device).index or 0)], capture_output=True, text=True,
                               timeout=20).stdout.strip()
        limit = float(limit)
    except (OSError, ValueError, subprocess.SubprocessError):
        limit = None
    return {"platform": "gpu", "kind": name, "count": 1, "power_limit_w": limit}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda", root: Path = REPO,
             t_start: Optional[float] = None, keep: Optional[Dict] = None) -> Dict[str, Any]:
    """One run of cell ``name``: the result line's object, its ``checks``
    last (each compared number with its limit)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, root)
    run = Run(cell, seed, device, t_start)
    driver = DRIVERS[cell.mix["kind"]](run)
    driver.setup()
    sync(run.device)
    setup_s = time.perf_counter() - t_start
    with collector_pauses() as pauses:
        driver.window(seconds, trace)
    run.ctx["gc"] = pauses
    info = device_info(run.device)
    if run.device.type == "cuda":
        info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(run.device))
    metrics: Dict[str, Dict] = {}
    result: Dict[str, Any] = {}
    if trace:
        tr = Trace.from_profiler(run.prof, run.trace_window)
        run.prof = None
        info["busy_s"] = tr.busy_s()
        info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        ctx = dict(run.ctx, trace=tr, window_s=run.window_s, trace_window_s=tr.window_s, spec=cell.config,
                   mix=cell.mix, peak=flops.peak_flops(info["kind"]) if run.device.type == "cuda" else None,
                   hw=tuple(run.cfg.data.image_size), views=run.cfg.data.num_views)
        if any(m["name"].startswith("mfu") for m in cell.per_layer()):
            ctx["forward_flops_per_batch"] = flops.forward_flops(cell.config["model"], ctx["batch"], ctx["views"],
                                                                 ctx["hw"])
        for m in cell.per_layer():
            read, data = load_reader(root, m["name"])
            value = read(dict(ctx, data=data))
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in run.e2e:
                metrics[m["name"]] = {"value": float(run.e2e[m["name"]]), "unit": m["unit"]}
    numbers = driver.check()
    if keep is not None:
        keep["driver"] = driver
    correct, checks = judge(numbers, cell.limits)
    window = {"gc": run.ctx["gc"]}
    if "generator_late_ms_p95" in run.ctx:
        window["generator_late_ms_p95"] = run.ctx["generator_late_ms_p95"]
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
              "device": info, **result, "window": window, "checks": checks}
    return result


@contextlib.contextmanager
def collector_pauses():
    """Yields a dict that, once the block ends, holds the garbage
    collector's passes inside it: how many, how many full ones, and their
    total and longest milliseconds."""
    out: Dict[str, float] = {"passes": 0, "full_passes": 0, "total_ms": 0.0, "longest_ms": 0.0}
    started = {}

    def note(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            ms = (time.perf_counter() - started.pop("t")) * 1e3
            out["passes"] += 1
            out["full_passes"] += int(info.get("generation") == 2)
            out["total_ms"] += ms
            out["longest_ms"] = max(out["longest_ms"], ms)

    gc.callbacks.append(note)
    try:
        yield out
    finally:
        gc.callbacks.remove(note)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
