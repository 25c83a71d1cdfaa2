"""Learned 3D positional encoding (PyTorch).

Counterpart of `petr_tpu/models/positional.py` (reference
`models/utils/positional_encoding.py:113-167`, sty61010/PETR):
``LearnedPositionalEncoding3D``, one learned table each for the rows, the
columns and the cameras, concatenated per position as camera | row |
column. No shipped config uses it. The tables are drawn U[0, 1), flax's
``uniform(1.0)`` as petr_tpu draws them, not ``nn.Embedding``'s N(0, 1).
The output is channels-last (B, N, H, W, 3 * num_feats), the layout in
which the port's heads take their positional embedding.
"""

from __future__ import annotations

import torch
from torch import nn


class LearnedPositionalEncoding3D(nn.Module):
    def __init__(self, num_feats: int = 128, row_num_embed: int = 50, col_num_embed: int = 50,
                 cam_num_embed: int = 12, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_feats = num_feats
        self.dtype = dtype
        self.row_embed = nn.Parameter(torch.rand(row_num_embed, num_feats))
        self.col_embed = nn.Parameter(torch.rand(col_num_embed, num_feats))
        self.cam_embed = nn.Parameter(torch.rand(cam_num_embed, num_feats))

    def forward(self, masks: torch.Tensor) -> torch.Tensor:
        """masks (B, N, H, W) (only their shape is read) -> (B, N, H, W, 3F)."""
        B, N, H, W = masks.shape
        shape = (B, N, H, W, self.num_feats)
        return torch.cat([
            self.cam_embed[:N][None, :, None, None, :].expand(shape),
            self.row_embed[:H][None, None, :, None, :].expand(shape),
            self.col_embed[:W][None, None, None, :, :].expand(shape),
        ], dim=-1).to(self.dtype)
