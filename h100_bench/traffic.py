"""The one traffic generator: a mix file's parameters -> what a run sends.

A mix (``traffic/<name>.json``) names its ``kind``:
  * ``serve``: an open loop of single-sample requests. ``arrival`` is
    ``poisson`` (exponential gaps at ``rate_per_s``) or ``onoff`` (bursts:
    ``on_s`` seconds at ``rate_per_s / duty`` then ``off_s`` seconds idle,
    ``duty = on_s / (on_s + off_s)``, the same mean rate). Each seed sends
    the same set of gaps, the quantiles of the arrival law, in its own
    order, so that the seed changes the order and not the work.
  * ``train`` and ``infer``: a closed loop over ``pool_batches`` distinct
    batches of ``batch`` samples, taken in turn.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from h100_bench.inputs import seed_stream


def _exponential_quantiles(n: int, mean: float) -> np.ndarray:
    """n gaps at the midpoint quantiles of an exponential law of ``mean``."""
    p = (np.arange(n) + 0.5) / n
    return -np.log1p(-p) * mean


def arrival_times(mix: Dict, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of the requests of one window."""
    rate = float(mix["rate_per_s"])
    n = max(int(round(rate * seconds)), 1)
    rng = np.random.default_rng(seed_stream(seed, 10))
    if mix["arrival"] == "poisson":
        gaps = _exponential_quantiles(n, 1.0 / rate)
        gaps = rng.permutation(gaps)
        t = np.cumsum(gaps) - gaps[0]
        return t * (seconds / (t[-1] + 1.0 / rate))
    if mix["arrival"] == "onoff":
        on, off = float(mix["on_s"]), float(mix["off_s"])
        period = on + off
        burst_rate = rate * period / on
        cycles = max(int(math.floor(seconds / period)), 1)
        per = max(int(round(burst_rate * on)), 1)
        gaps = rng.permutation(_exponential_quantiles(per, 1.0 / burst_rate))
        within = np.cumsum(gaps) - gaps[0]
        within = within * (on / (within[-1] + 1.0 / burst_rate))
        phase = rng.uniform(0.0, period)
        t = np.concatenate([c * period + within for c in range(cycles)]) + phase
        t = np.sort(np.mod(t, cycles * period))
        return t * (seconds / (cycles * period))
    raise ValueError(f"unknown arrival law {mix['arrival']!r}")


def request_samples(n: int, pool: int, seed: int) -> List[int]:
    """The pool sample each of ``n`` requests sends: whole permutations of
    the pool, one after another."""
    rng = np.random.default_rng(seed_stream(seed, 11))
    order: List[int] = []
    while len(order) < n:
        order.extend(int(i) for i in rng.permutation(pool))
    return order[:n]


def check_sample(n: int, k: int, seed: int) -> List[int]:
    """``k`` distinct indices of ``n`` drawn from the seed, sorted."""
    rng = np.random.default_rng(seed_stream(seed, 12))
    return sorted(int(i) for i in rng.choice(n, size=min(k, n), replace=False))
