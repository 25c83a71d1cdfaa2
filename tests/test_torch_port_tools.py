"""The port's measurement tools and small CLIs against petr_tpu at tiny_debug size.

``utils.mfu`` (the peak table, ``mfu_fields``, ``count_flops`` against the
dot_general and conv_general_dilated equations of petr_tpu's jaxpr, each
kernel op's formula against its plain version's aten count, the forward and
the train step on both routes), ``utils.profiler``, ``cli.benchmark``,
``cli.flops``, ``cli.print_config``, ``cli.analyze_logs``,
``cli.create_data``, ``utils.publish`` with ``cli.publish``, and the
host-only ``cli.browse_dataset`` and ``cli.visualize``. The CLIs run in
this process through ``main(argv)``.
"""

import json
import os
import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

import __graft_entry__ as ge
from petr_tpu.cli import analyze_logs as jax_analyze_logs
from petr_tpu.cli import print_config as jax_print_config
from petr_tpu.configs import get_config as jax_config
from petr_tpu.configs import list_configs
from petr_tpu.models import PETRDetector as JDetector
from petr_tpu.utils import mfu as jax_mfu
from petr_tpu.utils import profiler as jax_profiler
from petr_tpu_torch.cli import analyze_logs, benchmark, browse_dataset, create_data, flops, print_config
from petr_tpu_torch.cli import publish as publish_cli
from petr_tpu_torch.cli import visualize
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.data import generate_synthetic_scenes
from petr_tpu_torch.ops import conv3x3, conv_int8, cross_attention as ca, dcn
from petr_tpu_torch.serve import build_detector
from petr_tpu_torch.train import create_train_state, make_train_step, step_generator
from petr_tpu_torch.train.checkpoint import save_params
from petr_tpu_torch.utils import mfu, profiler
from petr_tpu_torch.utils.publish import load_published, publish_checkpoint

KEYS = ("images", "img2lidar", "img_hw")


def _stdout(capsys, fn, *args):
    capsys.readouterr()
    fn(*args)
    return capsys.readouterr().out


def _jax_main(monkeypatch, capsys, module, argv):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    return _stdout(capsys, module.main)


# ------------------------------------------------------------------ mfu
@pytest.mark.parametrize("flops_per_item,items_per_s", [(None, 3.0), (0.0, 3.0), (4.4275e9, 28.0), (3.1e11, 7.25)])
def test_mfu_fields_match(flops_per_item, items_per_s):
    assert mfu.mfu_fields(flops_per_item, items_per_s) == jax_mfu.mfu_fields(flops_per_item, items_per_s)


@pytest.mark.parametrize("name,peak", [("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA H100 SXM5 80GB", 989.0),
                                       ("NVIDIA H100 PCIe", 756.0), ("NVIDIA A100-SXM4-80GB", None)])
def test_device_peak_table(monkeypatch, name, peak):
    assert mfu.device_peak_tflops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    assert mfu.device_peak_tflops() == peak
    fields = mfu.mfu_fields(1e12, 100.0)
    assert fields.get("mfu_pct") == (None if peak is None else round(100.0 * 100.0 / peak, 1))


def _jaxpr_multiply_adds(jaxpr):
    """Multiply-adds of every dot_general and conv_general_dilated equation,
    sub-jaxprs included (a scan's body times its length), by equation."""
    terms = {}

    def walk(jx, mult):
        for e in jx.eqns:
            name = e.primitive.name
            out = int(np.prod(e.outvars[0].aval.shape))
            if name == "dot_general":
                (lc, _), _ = e.params["dimension_numbers"]
                k = int(np.prod([e.invars[0].aval.shape[i] for i in lc]))
                key = (name, tuple(e.invars[0].aval.shape), tuple(e.invars[1].aval.shape))
                terms[key] = terms.get(key, 0) + out * k * mult
            elif name == "conv_general_dilated":
                rhs, spec = e.invars[1].aval.shape, e.params["dimension_numbers"].rhs_spec
                k = rhs[spec[1]] * int(np.prod([rhs[i] for i in spec[2:]]))
                key = (name, tuple(e.invars[0].aval.shape), tuple(rhs))
                terms[key] = terms.get(key, 0) + out * k * mult
            inner = mult * (e.params["length"] if name == "scan" else 1)
            for v in e.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if isinstance(sub, jcore.ClosedJaxpr):
                        walk(sub.jaxpr, inner)
                    elif isinstance(sub, jcore.Jaxpr):
                        walk(sub, inner)

    walk(jaxpr.jaxpr, 1)
    return terms


@pytest.fixture(scope="module")
def tiny_inputs():
    cfg = get_config("tiny_debug")
    N, (H, W) = cfg.data.num_views, cfg.data.image_size
    rng = np.random.RandomState(0)
    batch = {
        "images": rng.randn(1, N, H, W, 3).astype(np.float32),
        "img2lidar": ge._cams(1, N),
        "img_hw": np.tile(np.array([H, W], np.float32), (1, N, 1)),
    }
    batch["img_hw"][0, 1] = [24, 64]  # padded tokens: the mask changes no count
    return cfg, batch


# The terms by which the two counts may differ: products that one package
# computes as a dot or conv and the other elementwise, by name. At tiny_debug
# there are none: the two counts are equal.
ELEMENTWISE_ON_ONE_SIDE = {}


def test_count_flops_matches_petr_tpu_jaxpr(tiny_inputs):
    """2 x the multiply-adds of petr_tpu's jaxpr of the same forward (flash
    off: its attention is two dot_generals), against ``count_flops`` of the
    port's forward on the kernel route (K1's op, counted by its formula)."""
    cfg, batch = tiny_inputs
    jcfg = jax_config("tiny_debug", ["model.use_flash_attention=False"])
    jmodel = JDetector(jcfg.model, deterministic=True)
    args = [jnp.asarray(batch[k]) for k in KEYS]
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args)["params"]
    terms = _jaxpr_multiply_adds(jax.make_jaxpr(lambda p, *a: jmodel.apply({"params": p}, *a))(params, *args))
    want = 2 * sum(terms.values()) + sum(ELEMENTWISE_ON_ONE_SIDE.values())

    model = build_detector(cfg, seed=0, device="cpu")
    inputs = [torch.from_numpy(batch[k]) for k in KEYS]
    with torch.inference_mode():
        got = mfu.count_flops(model, *inputs)
        with mfu.plain_kernels():
            plain = mfu.count_flops(model, *inputs)
    assert got == want and plain == got, (got, plain, want)
    hc = cfg.model.head
    attention = ca.forward_flops(1, hc.num_heads, hc.num_query, 6 * 2 * 5, hc.embed_dim // hc.num_heads)
    assert attention * hc.num_layers < got  # the decoder's K1 is in it


def test_count_flops_of_the_train_step_on_both_routes(tiny_inputs):
    cfg, _ = tiny_inputs
    batch = benchmark.benchmark_batch(cfg, 1, seed=0)
    counts = []
    for plain in (False, True):
        state = create_train_state(cfg, 0, 10, device="cpu")
        step = make_train_step(cfg)
        if plain:
            with mfu.plain_kernels():
                counts.append(mfu.count_flops(step, state, batch, step_generator(1, 0)))
        else:
            counts.append(mfu.count_flops(step, state, batch, step_generator(1, 0)))
    assert counts[0] == counts[1] > 0, counts


# ------------------------------------------------- each kernel op's formula
def _attention_inputs(B, H, Q, L, D, grad=False):
    g = torch.Generator().manual_seed(Q + L)
    q, k, v = (torch.randn(B, H, n, D, generator=g, requires_grad=grad) for n in (Q, L, L))
    return q, k, v, torch.rand(B, L, generator=g) < 0.25


def _plain_count(fn, *args):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("shape", [(2, 4, 37, 61, 16), (1, 8, 90, 600, 32)])
def test_k1_formula_is_the_plain_count(shape):
    q, k, v, mask = _attention_inputs(*shape)
    want = _plain_count(ca.flash_cross_attention_reference, q, k, v, mask)
    assert ca.forward_flops(*shape) == want
    assert mfu.count_flops(ca.flash_cross_attention, q, k, v, mask) == want  # through the op's formula
    assert mfu.count_flops(ca.flash_cross_attention_plain, q, k, v, mask) == want


@pytest.mark.parametrize("shape", [(2, 4, 37, 61, 16), (1, 8, 90, 600, 32)])
def test_k2_formula_is_the_plain_count(shape):
    q, k, v, mask = _attention_inputs(*shape)
    out, lse = ca.flash_cross_attention_reference(q, k, v, mask)
    gout = torch.randn_like(out)
    want = _plain_count(ca.flash_cross_attention_backward_reference, q, k, v, mask, out, lse, gout)
    assert ca.backward_flops(*shape) == want

    def step(fn):
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        fn(qg, kg, vg, mask)[0].sum().backward()

    assert mfu.count_flops(step, ca.flash_cross_attention) == ca.forward_flops(*shape) + want
    assert mfu.count_flops(step, ca.flash_cross_attention_plain) == ca.forward_flops(*shape) + want


@pytest.mark.parametrize("B,Cin,H,W,Cout,stride", [(2, 8, 6, 7, 5, 1), (1, 16, 9, 11, 12, 2)])
def test_k4_formula_is_the_plain_count(B, Cin, H, W, Cout, stride):
    g = torch.Generator().manual_seed(Cin)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x, om, w = torch.randn(B, Cin, H, W, generator=g), torch.randn(B, 27, Ho, Wo, generator=g), torch.randn(
        Cout, Cin, 3, 3, generator=g)
    want = _plain_count(dcn.modulated_deform_conv_reference, x, om, w, stride)
    assert dcn.forward_flops(x.shape, om.shape, w.shape) == want
    assert mfu.count_flops(dcn.modulated_deform_conv, x, om, w, stride) == want
    assert mfu.count_flops(dcn.modulated_deform_conv_plain, x, om, w, stride) == want


@pytest.mark.parametrize("B,C,H,W,Co", [(2, 8, 6, 7, 5), (1, 32, 10, 13, 48)])
def test_k5_formula_is_the_plain_count(B, C, H, W, Co):
    g = torch.Generator().manual_seed(C)
    x, w = torch.randn(B, C, H, W, generator=g), torch.randn(Co, C, 3, 3, generator=g)
    mul, add = torch.rand(Co, generator=g), torch.rand(Co, generator=g)
    want = _plain_count(conv3x3.conv3x3_bn_relu_reference, x, w, mul, add)
    assert mfu.count_flops(conv3x3.conv3x3_bn_relu, x, w, mul, add) == want == 2 * B * H * W * Co * C * 9
    assert mfu.count_flops(conv3x3.conv3x3_bn_relu_plain, x, w, mul, add) == want


@pytest.mark.parametrize("k,stride,C", [(3, 1, 8), (1, 1, 40), (3, 2, 3)])
def test_k6_formula_is_the_plain_count(k, stride, C):
    g = torch.Generator().manual_seed(k * C)
    B, H, W, Co = 2, 9, 10, 24
    x, w = torch.randn(B, C, H, W, generator=g), torch.randn(Co, C, k, k, generator=g)
    mul, add = torch.rand(Co, generator=g) + 0.5, torch.rand(Co, generator=g)
    wq, sa, scale, add = conv_int8.prepare_operands(w, mul, add, torch.tensor(2.5))
    wt = conv_int8.tile_weight(wq, conv_int8.conv_plan(B, C, H, W, Co, k, stride).bn)
    wi = conv_int8.untile_weight(wt, Co, C)
    want = _plain_count(conv_int8.conv_int8_bn_act_reference, x, wi, sa, scale, add, stride, True)
    assert mfu.count_flops(conv_int8.conv_int8_bn_act_tiled, x, wt, sa, scale, add, stride) == want
    assert mfu.count_flops(conv_int8.conv_int8_bn_act_tiled_plain, x, wt, sa, scale, add, stride) == want


# --------------------------------------------------------------- profiler
def test_step_timer_stats_match(monkeypatch):
    times = [0.031, 0.027, 0.044, 0.029, 0.030, 0.052, 0.028]
    clock = []
    t = 100.0
    for dt in times:
        clock += [t, t + dt]
        t += 1.0
    timers = (profiler.StepTimer(window=5), jax_profiler.StepTimer(window=5))
    for timer, module in zip(timers, (profiler, jax_profiler)):
        ticks = iter(clock)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))
        for _ in times:
            timer.start()
            timer.stop()
        monkeypatch.setattr(module.time, "perf_counter", time.perf_counter)
    assert timers[0].times == timers[1].times
    assert timers[0].stats() == timers[1].stats()
    assert set(timers[0].stats()) == {"mean_s", "p50_s", "max_s"}
    assert profiler.StepTimer().stats() == jax_profiler.StepTimer().stats() == {}


def test_force_completion_and_trace(tmp_path):
    rng = np.random.RandomState(0)
    tree = {"a": rng.randint(-8, 8, (3, 4)).astype(np.float32), "b": [rng.randint(-8, 8, 5).astype(np.float32)],
            "n": np.arange(4, dtype=np.int32)}
    want = jax_profiler.force_completion(jax.tree.map(jnp.asarray, tree))
    got = profiler.force_completion({"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(tree["b"][0])],
                                     "n": torch.from_numpy(tree["n"])})
    assert got == want
    assert profiler.force_completion({"n": torch.arange(3)}) == 0.0
    with profiler.trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "prof" / profiler.TRACE_FILE) as f:
        assert "traceEvents" in json.load(f)


# ------------------------------------------------------------------- CLIs
def test_benchmark_batch_is_graft_entry_batch():
    cfg = get_config("tiny_debug_v2")
    N, (H, W) = cfg.data.num_views * cfg.data.num_frames, cfg.data.image_size
    want = ge._batch(2, N, H, W, cfg.data.max_gt, with_ts=True, seed=3)
    got = benchmark.benchmark_batch(cfg, 2, seed=3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert got[k].dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("train", [False, True], ids=["inference", "train"])
def test_benchmark_cli_prints_petr_tpu_keys(capsys, train):
    iters = ["--iters", "1", "--warmup", "0", "--train"] if train else ["--iters", "2", "--warmup", "1"]
    out = _stdout(capsys, benchmark.main, ["--config", "tiny_debug", "--device", "cpu", *iters])
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    rec = json.loads(lines[0])
    # petr_tpu's keys (`cli/benchmark.py:128-138`; no mfu_pct without a known peak) and the device
    assert set(rec) == {"metric", "value", "unit", "ms_per_iter", "model_gflops", "achieved_tflops", "device"}
    assert rec["metric"] == "tiny_debug_" + ("train" if train else "inference")
    assert rec["unit"] == "samples/s" and rec["value"] > 0 and rec["device"] == "cpu"
    assert rec["model_gflops"] > (8.0 if train else 4.0)


def _jax_param_count(name):
    cfg = jax_config(name)
    model = JDetector(cfg.model, deterministic=True)
    N, (H, W) = cfg.data.num_views * cfg.data.num_frames, cfg.data.image_size
    b = ge._batch(1, N, H, W, 8, with_ts=cfg.data.num_frames > 1)
    extra = {}
    if cfg.model.head.kind == "depthr":  # the Depthr head reads the GT at init too
        extra = dict(gt_boxes=b["gt_boxes"], gt_valid=b["gt_valid"], lidar2img=jnp.linalg.inv(b["img2lidar"]))
    variables = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), b["images"], b["img2lidar"], b["img_hw"], timestamp=b.get("timestamp"), **extra))
    return sum(int(v.size) for v in jax.tree.leaves(variables["params"]))  # petr_tpu/cli/flops.py:43


@pytest.mark.parametrize("name", list_configs())
def test_flops_params_match_petr_tpu(name):
    assert flops.param_count(get_config(name)) == _jax_param_count(name)


def test_flops_cli_on_the_cpu(capsys):
    out = _stdout(capsys, flops.main, ["--config", "tiny_debug", "--device", "cpu"])
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec == {"config": "tiny_debug", "params_m": round(_jax_param_count("tiny_debug") / 1e6, 2),
                   "forward_gflops": rec["forward_gflops"], "input": "6x32x80"}
    assert 4.0 < rec["forward_gflops"] < 5.0  # 4.43 GFLOPs, petr_tpu's jaxpr count (test above)


@pytest.mark.parametrize("argv", [["--list"], []] + [["--config", n] for n in list_configs()]
                         + [["--config", "tiny_debug", "--set", "model.head.num_query=600", "data.max_gt=8"]],
                         ids=lambda a: "_".join(a) or "no_args")
def test_print_config_matches(monkeypatch, capsys, argv):
    want = _jax_main(monkeypatch, capsys, jax_print_config, argv)
    assert _stdout(capsys, print_config.main, argv) == want and want


def test_analyze_logs_cal_train_time_matches(monkeypatch, capsys, tmp_path):
    log = tmp_path / "train_log.jsonl"
    recs = [{"epoch": 0, "step": i, "loss": 3.0 - 0.1 * i, "time_per_iter": t}
            for i, t in enumerate([2.5, 0.41, 0.39, 0.44, 0.40])]
    log.write_text("\n".join(json.dumps(r) for r in recs) + "\n\n")
    empty = tmp_path / "eval_only.jsonl"
    empty.write_text(json.dumps({"epoch": 0, "mAP": 0.1}) + "\n")
    argv = ["cal_train_time", str(log), str(empty)]
    want = _jax_main(monkeypatch, capsys, jax_analyze_logs, argv)
    assert _stdout(capsys, analyze_logs.main, argv) == want
    assert "mean 0.4100s/iter" in want


def test_analyze_logs_plot_curve(capsys, tmp_path):
    log = tmp_path / "train_log.jsonl"
    log.write_text("".join(json.dumps({"step": i, "loss": 1.0 / (i + 1)}) + "\n" for i in range(4)))
    out = tmp_path / "curves.png"
    analyze_logs.main(["plot_curve", str(log), "--keys", "loss", "--out", str(out)])
    assert out.stat().st_size > 0


def test_create_data_writes_the_infos(monkeypatch, capsys, tmp_path):
    infos = {"train": [{"token": "a"}, {"token": "b"}], "val": [{"token": "c"}]}
    seen = {}

    def fake_build(root, version, max_prev):
        seen.update(root=root, version=version, max_prev=max_prev)
        return infos

    monkeypatch.setattr(create_data, "build_infos", fake_build)
    prefix = str(tmp_path / "petr")
    out = _stdout(capsys, create_data.main, ["--data-root", "/data/ns", "--version", "v1.0-mini",
                                             "--out-prefix", prefix, "--max-prev-frames", "5"])
    assert seen == {"root": "/data/ns", "version": "v1.0-mini", "max_prev": 5}
    assert out.splitlines() == ["train: 2 samples", "val: 1 samples"]
    assert sorted(os.listdir(tmp_path)) == ["petr_infos_train.pkl", "petr_infos_val.pkl"]


def test_publish_round_trip(capsys, tmp_path):
    model = build_detector(get_config("tiny_debug"), seed=3, device="cpu")
    ckpt = save_params(str(tmp_path / "ckpt"), model)
    final = publish_checkpoint(ckpt, str(tmp_path / "petr_tiny.pt"))
    m = re.fullmatch(r"petr_tiny-([0-9a-f]{8})\.pt", os.path.basename(final))
    assert m, final
    import hashlib

    assert hashlib.sha256(open(final, "rb").read()).hexdigest()[:8] == m.group(1)
    weights = load_published(final)
    want = model.state_dict()
    assert list(weights) == list(want)
    for k, v in want.items():
        assert torch.equal(weights[k], v), k
    out = _stdout(capsys, publish_cli.main, ["--ckpt", ckpt, "--out", str(tmp_path / "again.pt")])
    assert out.strip() == f"published {tmp_path / ('again-' + m.group(1) + '.pt')}"  # the same bytes, the same tag


def test_browse_dataset_and_visualize(capsys, tmp_path):
    splits = generate_synthetic_scenes(str(tmp_path / "synth"), n_scenes=2, frames_per_scene=1, image_hw=(48, 96),
                                       n_objects=3, val_scenes=1, seed=1)
    infos = str(tmp_path / "synth" / "synth_infos_val.pkl")
    assert os.path.exists(infos)
    out = _stdout(capsys, browse_dataset.main, ["--config", "tiny_debug", "--infos", infos, "--out",
                                                str(tmp_path / "browse"), "--num", "1"])
    assert "wrote 1 figures" in out and os.listdir(tmp_path / "browse") == ["sample_000.png"]
    val = splits["val"]
    results = {"results": {val[0]["token"]: [{
        "translation": [1.0, 2.0, 0.5], "size": [1.8, 4.2, 1.5], "rotation": [0.96, 0.0, 0.0, 0.28],
        "detection_score": 0.9, "detection_name": "car"}]}}
    path = tmp_path / "results.json"
    path.write_text(json.dumps(results))
    out = _stdout(capsys, visualize.main, ["--results", str(path), "--infos", infos, "--out", str(tmp_path / "vis")])
    assert "wrote 1 BEV plots" in out and len(os.listdir(tmp_path / "vis")) == 1
