"""PETRv2 head: PETR plus the feature-guided PE (FPE), the temporal
velocity normalisation and grouped regression branches (PyTorch).

Counterpart of `petr_tpu/models/petrv2_head.py` (reference
`models/dense_heads/petrv2_head.py`, sty61010/PETR), built on the port's
``PETRHead``:
  * FPE (`:120-121`): the 3D PE out of ``position_encoder`` is gated by
    ``fpe(pos_embed, x)`` with ``x`` the features after ``input_proj``,
    before the sine PE is added.
  * ``with_time`` (`:154-166, :196-197`): the (B, 12) lidar-relative
    timestamps, current 6 views first and previous 6 after, give the mean
    inter-frame step dt = mean(ts[:, 1] - ts[:, 0]) over (B, 2, 6); |dt| <
    1e-3 is clamped to +-1e-3 with its sign (petr_tpu departs here from the
    reference, which gives inf), and the velocity codes (8:) are divided by
    it in fp32, so that the net predicts displacement.
  * ``RegLayer`` (`:40-59`) with ``with_multi_reg``: a trunk and one MLP per
    group of the (2, 1, 3, 2, 2) split of the 10 code dims; otherwise the
    plain ``RegBranch``.
  * one cls and one reg branch per decoder layer (``shared_branches=False``,
    `:184-189`): the reference deep-copies them.
Two frames arrive as 12 views; the rest of the head treats N uniformly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from petr_tpu_torch.models.layers import Linear, SELayer
from petr_tpu_torch.models.petr_head import PETRHead, branch_list

GROUP_DIMS = (2, 1, 3, 2, 2)
MIN_ABS_DT = 1e-3  # seconds; `petrv2_head.py:161-163`
VIEWS_PER_FRAME = 6


class RegLayer(nn.Module):
    """The grouped regression branch (`petr_tpu/models/petrv2_head.py:40-59`):
    ``num_fcs`` x (Linear + ReLU) as a trunk, then per group Linear, ReLU,
    Linear, the groups' outputs concatenated. Names follow the reference
    ``state_dict`` (`petr_tpu/utils/torch_convert.py:271-292`): the trunk is
    ``reg_branch.{3i}`` (the reference's Sequential is Linear, ReLU,
    Dropout(0.0); the dropout, a no-op, is an Identity here) and the groups
    ``task_heads.{g}.{0,2}``."""

    def __init__(self, embed_dim: int, num_fcs: int, group_dims: Sequence[int] = GROUP_DIMS):
        super().__init__()
        trunk = []
        for _ in range(num_fcs):
            trunk += [Linear(embed_dim, embed_dim), nn.ReLU(), nn.Identity()]
        self.reg_branch = nn.Sequential(*trunk)
        self.task_heads = nn.ModuleList(
            nn.Sequential(Linear(embed_dim, embed_dim), nn.ReLU(), Linear(embed_dim, dim)) for dim in group_dims
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.reg_branch(x)
        return torch.cat([head(x) for head in self.task_heads], dim=-1)


def mean_frame_dt(timestamp: torch.Tensor) -> torch.Tensor:
    """(B, N) lidar-relative timestamps, current frame's views first -> (B,)
    fp32 mean step from the current frame to the previous one, |dt| clamped
    to at least MIN_ABS_DT with its sign kept (0 counts as positive)."""
    ts = timestamp.float().reshape(timestamp.shape[0], -1, VIEWS_PER_FRAME)
    dt = (ts[:, 1] - ts[:, 0]).mean(-1)
    clamped = torch.where(dt < 0, -MIN_ABS_DT, MIN_ABS_DT)
    return torch.where(dt.abs() < MIN_ABS_DT, clamped, dt)


class PETRv2Head(PETRHead):
    """``PETRHead`` with ``with_fpe``, ``with_time`` and ``with_multi_reg``
    (`petr_tpu/models/petrv2_head.py:62-214`); branches unshared unless
    ``shared_branches``. The forward takes ``timestamp`` (B, N), needed when
    ``with_time`` holds."""

    def __init__(self, with_fpe: bool = True, with_time: bool = True, with_multi_reg: bool = True,
                 shared_branches: bool = False, num_reg_fcs: int = 2, **kwargs):
        super().__init__(num_reg_fcs=num_reg_fcs, shared_branches=shared_branches, **kwargs)
        self.with_time = with_time
        if with_multi_reg:
            self.reg_branches = branch_list(lambda: RegLayer(self.embed_dim, num_reg_fcs),
                                            len(self.cls_branches), shared_branches)
        self.fpe = SELayer(self.embed_dim) if with_fpe else None

    def _guide_pos_embed(self, pos_embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return pos_embed if self.fpe is None else self.fpe(pos_embed, x)

    def _scale_velocity(self, reg_out: torch.Tensor, timestamp: Optional[torch.Tensor]) -> torch.Tensor:
        if not self.with_time:
            return reg_out
        if timestamp is None:
            raise ValueError("a with_time head needs the (B, N) timestamps")
        dt = mean_frame_dt(timestamp)  # (B,)
        return torch.cat([reg_out[..., :8], reg_out[..., 8:] / dt[:, None, None]], dim=-1)
