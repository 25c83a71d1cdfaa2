"""Profiling and step-timing instrumentation.

Counterpart of `petr_tpu/utils/profiler.py`: a profile capture and a step
timer whose stop waits for the work to finish by reading a host value that
depends on it. ``trace`` records the host and, where there is a card, its
kernels with ``torch.profiler`` and writes a Chrome trace
(``chrome://tracing`` or Perfetto) in place of JAX's XProf files.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List

import torch
from torch.utils._pytree import tree_leaves

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block on the CPU and, where there is a card, CUDA; write
    ``log_dir/trace.json`` on exit. Yields the profiler (``key_averages()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def force_completion(tree) -> float:
    """Return a host scalar that depends on every floating leaf (a true
    sync point): the devices of the tensors are synchronized first."""
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    for dev in {x.device for x in leaves if x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    acc = 0.0
    for x in leaves:
        if x.is_floating_point():
            acc = acc + x.detach().sum().float().cpu()
    return float(acc) if not isinstance(acc, float) else 0.0


class StepTimer:
    """Rolling iteration-time stats with true-completion timing."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: List[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, outputs=None) -> float:
        if outputs is not None:
            force_completion(outputs)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        return {
            "mean_s": sum(ts) / len(ts),
            "p50_s": ts[len(ts) // 2],
            "max_s": ts[-1],
        }
