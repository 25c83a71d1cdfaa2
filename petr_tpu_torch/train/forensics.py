"""Divergence forensics: snapshot and replay machinery for NaN hunts.

Counterpart of `petr_tpu/train/forensics.py`. A training driver keeps a
host copy of the last healthy state (``host_copy``) and saves it when the
run diverges (``save_snapshot``); ``python -m
petr_tpu_torch.tools.nan_replay`` replays from it step by step to the first
step whose gradients hold an inf or a NaN, then dissects that step: the
non-finite gradient entries per top-level module (``nonfinite_by_subtree``)
and the first module, in the order of execution, whose forward output is
non-finite (``first_nonfinite_intermediates``).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def host_copy(state) -> Dict[str, Any]:
    """The model's and the optimizer's ``state_dict`` of a
    ``train.TrainState`` as CPU tensors (a copy that later steps leave
    alone)."""
    return {"model": _to_cpu(state.model.state_dict()), "optimizer": _to_cpu(state.optimizer.state_dict())}


def save_snapshot(out_dir: str, host_state: Mapping[str, Any], step: int, cfg: Any,
                  loader_args: Optional[Dict] = None) -> str:
    """Pickle the last healthy state (``host_copy``), its step, the config
    and the loader's arguments to ``out_dir/healthy_step_<step>.pkl``; the
    replay rebuilds the optimizer from ``cfg`` and loads the state into it."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"healthy_step_{step:08d}.pkl")
    with open(path, "wb") as f:
        pickle.dump(
            {
                "model": host_state["model"],
                "optimizer": host_state["optimizer"],
                "step": int(step),
                "cfg": cfg,
                "loader_args": loader_args or {},
            },
            f,
        )
    return path


def load_snapshot(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def nonfinite_by_subtree(named: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """{top-level module: count of non-finite entries} over tensors by
    dotted name (gradients by parameter name, a ``state_dict``); modules
    with none are left out."""
    out: Dict[str, int] = {}
    for name, t in named.items():
        n = int((~torch.isfinite(t)).sum()) if t.is_floating_point() else 0
        if n:
            top = name.split(".")[0]
            out[top] = out.get(top, 0) + n
    return out


def _count(out: Any) -> Tuple[int, int]:
    """(non-finite entries, floating entries) over a module's output."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            return int((~torch.isfinite(out)).sum()), out.numel()
        return 0, 0
    items = out.values() if isinstance(out, dict) else out if isinstance(out, (list, tuple)) else ()
    bad = size = 0
    for item in items:
        b, s = _count(item)
        bad, size = bad + b, size + s
    return bad, size


@torch.no_grad()
def first_nonfinite_intermediates(model: nn.Module, *args, **kwargs) -> Tuple[Any, List[Tuple[str, int, int]]]:
    """Run ``model(*args, **kwargs)`` with a forward hook on every submodule
    and return (its outputs, [(module name, non-finite entries, entries)]
    for each module whose output holds an inf or a NaN, in the order the
    modules finished). The first entry names the first module, in the
    order of execution, to emit a non-finite value: a module finishes
    before the module that holds it."""
    bad: List[Tuple[str, int, int]] = []

    def hook(name):
        def record(module, inputs, output):
            n, size = _count(output)
            if n:
                bad.append((name, n, size))
        return record

    handles = [m.register_forward_hook(hook(name)) for name, m in model.named_modules() if name]
    try:
        outputs = model(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return outputs, bad
