"""Hungarian matching of queries to GT boxes, solved on the host.

Counterpart of `petr_tpu/ops/matcher.py`, with its semantics: the cost is
``nan_to_num``'d to +-100, padded GT rows are a constant row, GTs are the
rows and queries the columns (G <= Q), and an invalid row's column is
arbitrary (0 here), so that consumers must mask it. petr_tpu solves the LAP
on the device in a while loop; this port solves it with scipy's
``linear_sum_assignment``, as the reference does. The stacked (L, B, Q, G)
cost of a step crosses to the host once, with no gradient: one
device->host sync per train step. A device-resident solver is later work
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def lap_solve(cost: np.ndarray, row_valid: np.ndarray) -> np.ndarray:
    """Min-cost assignment of rows to distinct columns -> (R,) int32 column
    of each row. ``cost`` (R, C) with R <= C; rows where ``row_valid`` is
    False are padding and get column 0."""
    R, C = cost.shape
    if R > C:
        raise ValueError(f"lap_solve expects rows <= cols, got {cost.shape}")
    cost = np.nan_to_num(cost.astype(np.float32), nan=100.0, posinf=100.0, neginf=-100.0)
    row_valid = np.asarray(row_valid, bool)
    # padded rows are a constant row, which leaves the optimum over the valid
    # rows unchanged: so they are left out of the solve
    cost = np.where(row_valid[:, None], cost, np.float32(0.0))
    col_of_row = np.zeros((R,), np.int32)
    rows = np.flatnonzero(row_valid)
    if rows.size:
        r, c = linear_sum_assignment(cost[rows])
        col_of_row[rows[r]] = c
    return col_of_row


def hungarian_match(cost: np.ndarray, gt_valid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """cost (Q, G) between queries and padded GTs -> (query_of_gt (G,),
    match_valid (G,) = gt_valid)."""
    return lap_solve(cost.T, gt_valid), np.asarray(gt_valid, bool)


def match_layers(cost: torch.Tensor, gt_valid: torch.Tensor) -> np.ndarray:
    """The (L, B, G) query of every GT, per decoder layer and sample, from
    the stacked (L, B, Q, G) cost: one copy to the host, then one LAP each."""
    cost_np = cost.detach().float().transpose(-1, -2).cpu().numpy()  # (L, B, G, Q)
    valid = gt_valid.detach().cpu().numpy().astype(bool)  # (B, G)
    L, B, G, _ = cost_np.shape
    out = np.zeros((L, B, G), np.int64)
    for lvl in range(L):
        for b in range(B):
            out[lvl, b] = lap_solve(cost_np[lvl, b], valid[b])
    return out
