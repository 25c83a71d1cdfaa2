"""A diverging step replayed in both packages: the port's and petr_tpu's
forward module by module and their non-finite gradients, on the CPU.

    JAX_PLATFORMS=cpu python -m tests.test_torch_port_replay --bad-step DIR

``DIR`` holds what ``python -m petr_tpu_torch.tools.nan_replay`` saved on
the card (``bad_step.pkl``: the batch of the first step whose gradients
held an inf or a NaN, and the weights before it), or that file cut in two
parts (``bad_step_part0.pkl`` with the batch and ``bad_step_part1.pkl``),
as a chip run brings it back under its size limit. Both packages take the
same weights (petr_tpu's through ``utils/torch_convert.py``) and the same
batch, in fp32 with dropout off on both sides (the step's dropout masks
come from two different generators), and the script prints, for each
module the two share a name for (the backbone, the neck, every decoder
layer and its parts), each side's largest finite |value| and count of
non-finite values, the relative difference of the largest values, then
each package's loss and its non-finite gradient entries by top-level
module. The first module whose numbers part is where a port fault would
start; numbers that part only where both sides have already overflowed
belong to the regime, not to the port.

The test below runs the same comparison at tiny_debug's size on weights
blown up until fp32 overflows inside the backbone, and holds the two
packages to the same first non-finite module and the same modules with
non-finite gradients (how many entries an inf reaches in a backward is
each library's own: 0 x inf).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import re
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from petr_tpu.configs import get_config as jax_config
from petr_tpu.models import PETRDetector as JDetector
from petr_tpu.train.train_step import make_grad_fn as jax_make_grad_fn
from petr_tpu.utils.torch_convert import convert_state_dict
from petr_tpu_torch.configs import get_config as port_config
from petr_tpu_torch.models import PETRDetector, draw_train_noise
from petr_tpu_torch.train import make_grad_fn, step_generator

Stats = Dict[str, Tuple[float, int, int]]  # module -> (largest finite |value|, non-finite, size)

# the port's module names -> petr_tpu's, one name segment at a time
_SEGMENTS = [(r"^img_backbone$", "backbone"), (r"^img_neck$", "neck"), (r"^pts_bbox_head$", "head"),
             (r"^layers\.(\d+)$", r"layer\1"), (r"^attentions\.0$", "self_attn"), (r"^attentions\.1$", "cross_attn"),
             (r"^norms\.(\d)$", None), (r"^ffns\.0$", "ffn")]
_COMPARED = re.compile(r"^(img_backbone|img_neck|pts_bbox_head\.transformer\.decoder"
                       r"(\.layers\.\d+(\.(attentions\.[01]|norms\.[012]|ffns\.0))?)?)$")


def jax_name(port_name: str) -> str:
    """petr_tpu's module path of a port module compared here."""
    parts = re.sub(r"(layers|attentions|norms|ffns)\.(\d+)", r"\1.\2", port_name).split(".")
    out, i = [], 0
    while i < len(parts):
        seg = parts[i]
        if i + 1 < len(parts) and parts[i + 1].isdigit():
            seg = f"{seg}.{parts[i + 1]}"
            i += 1
        for pattern, repl in _SEGMENTS:
            if re.match(pattern, seg):
                seg = f"norm{int(seg[-1]) + 1}" if repl is None else re.sub(pattern, repl, seg)
                break
        out.append(seg)
        i += 1
    return "/".join(out)


def _summary(x) -> Tuple[float, int, int]:
    a = np.asarray(x, np.float32)
    finite = np.isfinite(a)
    return (float(np.abs(a[finite]).max()) if finite.any() else 0.0, int((~finite).sum()), int(a.size))


def _merge(values: List[Tuple[float, int, int]]) -> Tuple[float, int, int]:
    return (max(v[0] for v in values), sum(v[1] for v in values), sum(v[2] for v in values))


def port_stats(cfg, model, batch) -> Stats:
    """Each compared module's output summary in the port's forward (train
    mode, dropout off: the forward the step takes); a module that runs
    several times (the decoder's shared post-norm) merges its calls."""
    seen: Dict[str, List] = {}

    def hook(name):
        def record(module, inputs, output):
            outs = output if isinstance(output, (list, tuple)) else [output]
            seen.setdefault(name, []).extend(_summary(o.detach().float().numpy()) for o in outs
                                              if isinstance(o, torch.Tensor))
        return record

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if _COMPARED.match(n)]
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    try:
        with torch.no_grad():
            model(b["images"], b["img2lidar"], b["img_hw"],
                  noise=draw_train_noise(cfg.model, b["images"].shape[2], step_generator(0, 0)))
    finally:
        for h in handles:
            h.remove()
    return {n: _merge(v) for n, v in seen.items()}


def jax_stats(jcfg, params, batch) -> Stats:
    """petr_tpu's module outputs (``capture_intermediates``) summarised the
    same way, by module path."""
    jmodel = JDetector(jcfg.model, deterministic=True)
    _, mods = jax.jit(lambda p, i, c, h: jmodel.apply({"params": p}, i, c, h, capture_intermediates=True))(
        params, *(jnp.asarray(batch[k]) for k in ("images", "img2lidar", "img_hw")))
    out: Dict[str, List] = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(mods["intermediates"]))[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        name = "/".join(str(k) for k in keys if isinstance(k, str) and k != "__call__")
        if hasattr(leaf, "dtype") and np.issubdtype(np.asarray(leaf).dtype, np.floating):
            out.setdefault(name, []).append(_summary(leaf))
    return {n: _merge(v) for n, v in out.items()}


def nonfinite_grads(named) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for name, g in named:
        n = int((~np.isfinite(np.asarray(g, np.float32))).sum())
        if n:
            top = name.split("/")[0]
            counts[top] = counts.get(top, 0) + n
    return counts


_TOP = {"img_backbone": "backbone", "img_neck": "neck", "pts_bbox_head": "head"}


def compare(cfg, jcfg, state_dict: Dict[str, np.ndarray], batch: Dict[str, np.ndarray]) -> Dict:
    """Both packages on ``batch`` from ``state_dict`` -> {"rows": [(port
    module, petr_tpu module, port stats, petr_tpu stats)] in the port's
    order of execution, "port"/"jax": (loss, non-finite gradients by top-level
    module with petr_tpu's names)}."""
    model = PETRDetector(cfg.model)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()})
    model.train()
    ports = port_stats(cfg, model, batch)
    one = [jnp.asarray(batch[k][:1]) for k in ("images", "img2lidar", "img_hw")]
    shapes = jax.eval_shape(JDetector(jcfg.model, deterministic=True).init, jax.random.PRNGKey(0), *one)["params"]
    params, stats = convert_state_dict({k: np.asarray(v) for k, v in state_dict.items()},
                                       jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    assert stats["skipped"] == 0 and stats["unfilled"] == 0, stats
    params = jax.tree.map(jnp.asarray, params)
    jaxs = jax_stats(jcfg, params, batch)
    rows = [(n, jax_name(n), s, jaxs.get(jax_name(n))) for n, s in ports.items()]
    total, _, grads, _, _ = make_grad_fn(cfg)(model, batch, step_generator(0, 0))
    jtotal, _, jgrads, _ = jax.jit(jax_make_grad_fn(jcfg))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    jflat = [("/".join(str(getattr(p, "key", p)) for p in path), g)
             for path, g in jax.tree_util.tree_flatten_with_path(jax.device_get(jgrads))[0]]
    port_counts = {_TOP.get(k, k): v for k, v in nonfinite_grads(
        [(n.replace(".", "/", 1), g.numpy()) for n, g in grads.items()]).items()}
    return {"rows": rows, "port": (float(total), port_counts), "jax": (float(jtotal), nonfinite_grads(jflat))}


def first_nonfinite(rows, side: int) -> str:
    for row in rows:
        if row[2 + side] is not None and row[2 + side][1]:
            return row[0]
    return ""


def report(result) -> None:
    print(f"{'module (port)':62s} {'port max|x|':>12s} {'nonfin':>8s} {'petr_tpu':>12s} {'nonfin':>8s} {'rel diff':>9s}")
    for name, _, p, j in result["rows"]:
        if j is None:
            print(f"{name:62s} {p[0]:12.4e} {p[1]:8d} {'(no match)':>12s}")
            continue
        rel = abs(p[0] - j[0]) / max(abs(j[0]), 1e-30)
        print(f"{name:62s} {p[0]:12.4e} {p[1]:8d} {j[0]:12.4e} {j[1]:8d} {rel:9.2e}")
    for side in ("port", "jax"):
        loss, counts = result[side]
        print(f"{side}: loss {loss:.6f}, non-finite gradient entries by module {counts}")
    print(f"first non-finite module: port {first_nonfinite(result['rows'], 0) or 'none'}, "
          f"petr_tpu {first_nonfinite(result['rows'], 1) or 'none'}")


def load_bad_step(path: str):
    """(batch, weights, step) from ``bad_step.pkl`` or its two parts."""
    whole = os.path.join(path, "bad_step.pkl")
    if os.path.exists(whole):
        with open(whole, "rb") as f:
            d = pickle.load(f)
        return d["batch"], {k: v.numpy() for k, v in d["model"].items()}, d["step"]
    parts = []
    for i in (0, 1):
        with open(os.path.join(path, f"bad_step_part{i}.pkl"), "rb") as f:
            parts.append(pickle.load(f))
    assert parts[0]["step"] == parts[1]["step"], "the parts come from two different steps"
    model = {**parts[0]["model"], **parts[1]["model"]}
    return parts[0]["batch"], {k: v.numpy() for k, v in model.items()}, parts[0]["step"]


def recipe_configs(name: str = "synth_small", hw=(128, 320)):
    """The synthetic harness's config in both packages, dropout off."""
    from petr_tpu_torch.tools.synth_train_eval import recipe_config

    cfg = recipe_config(name, hw)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, head=dataclasses.replace(cfg.model.head, dropout_rate=0.0)))
    jcfg = jax_config(name)
    jcfg = dataclasses.replace(
        jcfg, data=dataclasses.replace(jcfg.data, image_size=hw, final_dim=hw, max_gt=32),
        model=dataclasses.replace(jcfg.model, head=dataclasses.replace(jcfg.model.head, dropout_rate=0.0)),
        train=dataclasses.replace(jcfg.train, optim=dataclasses.replace(
            jcfg.train.optim, lr=cfg.train.optim.lr, warmup_iters=50, min_lr_ratio=cfg.train.optim.min_lr_ratio,
            backbone_lr_mult=1.0)))
    return cfg, jcfg


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--bad-step", required=True, help="the directory of bad_step.pkl (or its two parts)")
    p.add_argument("--config", default="synth_small")
    args = p.parse_args(argv)
    batch, weights, step = load_bad_step(args.bad_step)
    batch = {k: v for k, v in batch.items() if k != "tokens"}
    cfg, jcfg = recipe_configs(args.config, tuple(batch["images"].shape[2:4]))
    print(f"step {step}: batch of {batch['images'].shape[0]}, {len(weights)} tensors; fp32, dropout off", flush=True)
    report(compare(cfg, jcfg, weights, batch))


def test_tiny_overflow_is_the_same_in_both_packages():
    """tiny_debug with its last stage's conv weights x 1e12: fp32 overflows
    in the backbone; both packages name the same first non-finite module
    and the same modules with non-finite gradients."""
    from tests.test_torch_port_parallel_train import make_batch, weights

    cfg = port_config("tiny_debug", ["model.head.dropout_rate=0.0"])
    jcfg = jax_config("tiny_debug", ["model.head.dropout_rate=0.0", "model.use_flash_attention=False",
                                     "model.remat=False"])
    sd = weights(cfg)
    for k in sd:
        if k.startswith("img_backbone.stage5") and k.endswith("conv.weight"):
            sd[k] = sd[k] * np.float32(1e12)
    res = compare(cfg, jcfg, sd, make_batch(cfg, 2))
    port_first, jax_first = first_nonfinite(res["rows"], 0), first_nonfinite(res["rows"], 1)
    assert port_first and port_first == jax_first, (port_first, jax_first)
    # how many entries an inf or a NaN reaches in the backward depends on each
    # library's backward of ops at inf (0 x inf): the modules must agree, not the counts
    assert set(res["port"][1]) == set(res["jax"][1]) == {"backbone", "neck", "head"}, (res["port"], res["jax"])
    matched = [r for r in res["rows"] if r[3] is not None]
    assert len(matched) >= len(res["rows"]) - 1, [r[0] for r in res["rows"] if r[3] is None]


if __name__ == "__main__":
    main()
