"""The traced window: torch.profiler's events read in memory.

``Trace.from_profiler(prof)`` keeps every device activity (kernels,
copies, sets; not the profiler's annotations and overhead records) as
(name, start, end) and, for each kernel, the names of the
host ranges (ops, autograd nodes, ``record_function`` spans) that enclosed
its launch on the launching thread, linked by the profiler's correlation
ids. Readers then ask for the device time of kernels by range name or by
kernel name, the busy time (the union of device intervals), and the
breakdown the result line carries.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, Sequence, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")  # device activities; annotations are not work
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")  # host API calls: linked to kernels, not ranges


def activity_kind(e) -> str:
    """The profiler's activity type of event ``e`` ("kernel", "cpu_op", ...).
    Where the build's events do not carry it, it is told from the device,
    the name and the user-annotation flag: a device event named with a "#"
    (``Optimizer.step#AdamW.step``) or "Buffer Flush" is the profiler's own."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if str(e.device_type()).endswith("CPU"):
        return "cuda_runtime" if name.startswith(("cuda", "cu")) else "cpu_op"
    if getattr(e, "is_user_annotation", lambda: False)() or "#" in name or name == "Buffer Flush":
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


class Trace:
    def __init__(self, device: List[Tuple[str, float, float, Tuple[str, ...]]], window_s: float):
        self.device = device  # (name, start s, end s, enclosing host range names)
        self.window_s = window_s

    @classmethod
    def from_profiler(cls, prof, window_s: float) -> "Trace":
        events = prof.profiler.kineto_results.events()
        host = defaultdict(list)  # thread -> [(start, end, name)]
        by_corr = {}
        device = []
        for e in events:
            kind = activity_kind(e)
            if kind in DEVICE_KINDS:
                device.append(e)
            elif not kind.startswith("gpu_") and kind != "overhead":
                s, d = e.start_ns(), e.duration_ns()
                by_corr[e.correlation_id()] = (e.start_thread_id(), s)
                if kind not in LAUNCH_KINDS and e.name() != "Buffer Flush":  # the profiler's own span names no work
                    host[e.start_thread_id()].append((s, s + d, e.name()))
        index = {}
        for tid, spans in host.items():
            spans.sort()
            index[tid] = ([s for s, _, _ in spans], spans)
        t0 = min([e.start_ns() for e in device] or [0])
        out = []
        for e in device:
            ranges: Tuple[str, ...] = ()
            link = by_corr.get(e.linked_correlation_id())
            if link is not None and link[0] in index:
                starts, spans = index[link[0]]
                at = link[1]
                hi = bisect.bisect_right(starts, at)
                ranges = tuple(name for s, end, name in spans[max(0, hi - 4096):hi] if end >= at)
            start = (e.start_ns() - t0) / 1e9
            out.append((e.name(), start, start + e.duration_ns() / 1e9, ranges))
        return cls(out, window_s)

    # -------------------------------------------------------------- queries
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (their union)."""
        total, end = 0.0, float("-inf")
        for _, s, e, _ in sorted(self.device, key=lambda k: k[1]):
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total

    def time_in_ranges(self, names: Sequence[str]) -> Tuple[float, int]:
        """(device seconds, kernel count) of the activities launched inside a
        host range whose name contains any of ``names``."""
        t, n = 0.0, 0
        for _, s, e, ranges in self.device:
            if any(k in r for r in ranges for k in names):
                t += e - s
                n += 1
        return t, n

    def time_of_kernels(self, names: Sequence[str]) -> Tuple[float, int]:
        """(device seconds, count) of the activities whose name contains any of ``names``."""
        t, n = 0.0, 0
        for name, s, e, _ in self.device:
            if any(k in name for k in names):
                t += e - s
                n += 1
        return t, n

    def device_time(self, ranges: Sequence[str], kernels: Sequence[str]) -> float:
        """Device seconds by range names, or by kernel names where no
        activity was seen inside such a range (a CUDA-graph replay); 0 when
        neither finds any."""
        t, n = self.time_in_ranges(ranges)
        if n:
            return t
        return self.time_of_kernels(kernels)[0]

    def top_ops(self, k: int = 10) -> List[List]:
        tot = defaultdict(float)
        for name, s, e, _ in self.device:
            tot[name[:120]] += e - s
        return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The longest gaps between device activities, named by the host
        ranges that enclosed the launch which ended the gap."""
        ordered = sorted(self.device, key=lambda d: d[1])
        gaps = []
        end = ordered[0][2] if ordered else 0.0
        for name, s, e, ranges in ordered[1:]:
            if s > end:
                label = ranges[-1] if ranges else name
                gaps.append((s - end, f"before {label[:100]}"))
            end = max(end, e)
        gaps.sort(key=lambda g: -g[0])
        return [[label, g] for g, label in gaps[:k]]
