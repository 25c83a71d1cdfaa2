"""The numbers that decide ``correct``: the program's outputs against the reference's.

Detections (serve, infer): the served top-k answers of the NMS-free decode
against the reference's table of every (query, class) score and every
query's box. At random weights the scores of all Q x C pairs lie within a
few hundredths of each other, so a score does not tell which query a
detection is; its centre does, since each query's centre is its own learned
reference point moved by the regression branch. A served detection is
paired with the reference query whose centre lies nearest its own (the
largest difference of the three coordinates, each as a fraction of
pc_range), where that query is at least twice as near as any other.
  * ``logit_gap``: the mean, over the paired detections of every checked
    answer, of the difference between the logit of the served score and of
    the reference's score of the paired query in the served class (a wrong
    label, a wrong score or another sample's answer reads high).
  * ``box_gap``: the mean, over the same detections, of the largest
    difference of the box in the head's units: the centre as a fraction of
    pc_range, log sizes and velocities in m/s, each over the larger of 1 and
    the reference's magnitude. The yaw is left out, since atan2 of two codes
    near 0 amplifies any rounding.
  An answer with fewer than half its detections paired makes both inf.
Means over every checked answer's detections, and not the worst answer's:
at random weights a few queries of a bf16 forward tip against the fp32
reference's, and the worst answer reads those as much as the precision
(PERF.md).
Training: each checked step's loss, the first step's gradient (the
optimiser's, the clip undone) and the parameters' change after the checked
steps, by the median leaf (``median_leaf_gap``).
``judge`` holds a run's numbers to a cell's limits, for the benchmark's
runs and for the calibration's control and faults alike.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


def judge(numbers: Mapping[str, float], limits: Mapping[str, Optional[float]]) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, checks): every number the limits name, each beside its
    limit; correct only where each is there and at most its limit (NaN
    fails, and so does a number without a limit)."""
    checks, correct = {}, bool(limits)
    for key, limit in limits.items():
        value = numbers.get(key, math.nan)
        checks[key] = {"value": value, "limit": limit}
        if limit is None or not (value <= limit):
            correct = False
    for key in numbers.keys() - limits.keys():
        checks[key] = {"value": numbers[key], "limit": None}
        correct = False
    return correct, checks


def box_units(boxes: torch.Tensor, pc_range: Sequence[float]) -> torch.Tensor:
    """(..., 9) boxes -> (..., 8) in the head's units, the yaw left out: the
    centre as a fraction of pc_range, log w, l, h, vx, vy."""
    lo = torch.tensor(pc_range[:3], dtype=boxes.dtype, device=boxes.device)
    ext = torch.tensor(pc_range[3:], dtype=boxes.dtype, device=boxes.device) - lo
    return torch.cat([(boxes[..., :3] - lo) / ext, boxes[..., 3:6].clamp(min=1e-30).log(), boxes[..., 7:9]], dim=-1)


def paired_gaps(served: Mapping[str, np.ndarray], ref_scores: torch.Tensor, ref_boxes: torch.Tensor,
                pc_range: Sequence[float]) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(logit gaps, box gaps) of one served answer's paired detections
    against the reference's (Q, C) scores and (Q, 9) boxes; None where fewer
    than half its detections pair, or where it holds a value out of range."""
    dev = ref_scores.device
    s = torch.as_tensor(np.asarray(served["scores"]), dtype=torch.float32, device=dev)
    labels = torch.as_tensor(np.asarray(served["labels"]), dtype=torch.int64, device=dev)
    boxes = torch.as_tensor(np.asarray(served["boxes"]), dtype=torch.float32, device=dev)
    if not (torch.isfinite(s).all() and torch.isfinite(boxes).all()) or (
            (labels < 0) | (labels >= ref_scores.shape[1])).any():
        return None
    ref, got = box_units(ref_boxes, pc_range), box_units(boxes, pc_range)
    near = (got[:, None, :3] - ref[None, :, :3]).abs().amax(-1).topk(2, dim=1, largest=False)
    paired = near.values[:, 1] >= 2.0 * near.values[:, 0]
    if 2 * int(paired.sum()) < s.numel():
        return None
    q = near.indices[paired, 0]
    logit = lambda p: torch.log(p) - torch.log1p(-p)  # noqa: E731
    d_logit = (logit(s[paired].clamp(1e-30, 1 - 1e-7)) - logit(ref_scores[q, labels[paired]].float())).abs()
    d_box = ((got[paired] - ref[q]).abs() / ref[q].abs().clamp(min=1.0)).amax(-1)
    return d_logit, d_box


def detection_gaps(answers: Sequence[Mapping[str, np.ndarray]], tables, pc_range: Sequence[float]) -> Dict[str, float]:
    """logit_gap and box_gap of a run: ``answers`` against the reference's
    ``tables`` ((scores, boxes) of each answer's sample)."""
    gaps = [paired_gaps(a, scores, boxes, pc_range) for a, (scores, boxes) in zip(answers, tables)]
    if not gaps or any(g is None for g in gaps):
        return {"logit_gap": math.inf, "box_gap": math.inf}
    return {"logit_gap": float(torch.cat([g[0] for g in gaps]).mean()),
            "box_gap": float(torch.cat([g[1] for g in gaps]).mean())}


def median_leaf_gap(program: Mapping[str, float], reference: Mapping[str, float], leaves: Sequence[str]) -> float:
    """The median over ``leaves`` of each leaf's gap between the program's
    norm and the reference's, over the larger of the reference's norm of
    that leaf and of the median leaf."""
    med = statistics.median(reference[n] for n in leaves)
    gaps = [abs(program.get(n, 0.0) - reference[n]) / max(reference[n], med, 1e-30) for n in leaves]
    if any(not math.isfinite(g) for g in gaps):
        return math.inf
    return statistics.median(gaps)


def train_gaps(p_losses: List[float], r_losses: List[float], p_grad: Mapping[str, float], r_grad: Mapping[str, float],
               p_change: Mapping[str, float], r_change: Mapping[str, float]) -> Dict[str, float]:
    """loss_gap (the checked steps' worst relative gap), grad_gap (the first
    step's raw gradient, before the clip) and change_gap (the parameters'
    change after the checked steps), each of the median leaf. Both leaf
    gaps leave out leaves whose reference gradient is under a thousandth of
    the median leaf's: their gradient is nought but for rounding (a key
    bias under softmax), and under Adam they move by round-off alone."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(p_losses, r_losses))
    if any(not math.isfinite(p) for p in p_losses):
        loss_gap = math.inf
    leaves = sorted(r_grad)
    med = statistics.median(r_grad[n] for n in leaves)
    moving = [n for n in leaves if r_grad[n] >= 1e-3 * med]
    return {"loss_gap": loss_gap, "grad_gap": median_leaf_gap(p_grad, r_grad, moving),
            "change_gap": median_leaf_gap(p_change, r_change, moving)}
