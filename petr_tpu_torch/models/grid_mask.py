"""GridMask augmentation (PyTorch), the reference-exact mode.

Counterpart of `petr_tpu/models/grid_mask.py` with ``exact=True``
(reference `models/utils/grid_mask.py`, sty61010/PETR, as the detector
calls it): use_h = use_w = True, mode 1 (the grid BANDS are kept),
ratio 0.5, prob 0.7, integer period d ~ randint[2, H), band length
l = min(max(int(d * ratio + 0.5), 1), d - 1), offsets st ~ randint[0, d),
on a 1.5x canvas center-cropped, never rotated. ONE mask per call,
broadcast over every (batch, view) image, behind one Bernoulli(prob) gate.

The parameters are drawn from the train step's ``torch.Generator`` before
the forward (``draw_grid_params``) and passed in, so that the forward is a
function of its arguments.
"""

from __future__ import annotations

import dataclasses
import math

import torch

PROB = 0.7
RATIO = 0.5


@dataclasses.dataclass(frozen=True)
class GridParams:
    apply: bool  # the Bernoulli(prob) gate
    d: int  # period
    st_h: int  # row offset
    st_w: int  # column offset


def draw_grid_params(generator: torch.Generator, H: int, prob: float = PROB, exact: bool = True) -> GridParams:
    """One call's parameters: the gate, d in [2, H), offsets in [0, d)."""
    if not exact:
        raise NotImplementedError(
            "grid_mask_exact=False (per-sample float-period masks) is not ported yet: "
            "ROADMAP.md §1, item 11"
        )
    apply = bool(torch.rand((), generator=generator).item() < prob)
    d = int(torch.randint(2, H, (), generator=generator).item())
    st_h, st_w = (int(x) for x in torch.randint(0, max(d, 1), (2,), generator=generator))
    return GridParams(apply, d, st_h, st_w)


def _band(coord: torch.Tensor, canvas_len: int, crop_off: int, st: int, d: int, l: int) -> torch.Tensor:
    """Band membership of cropped-window coordinates (`grid_mask.py:96-105`):
    bands start at d*i + st for i in range(canvas_len // d), each l long."""
    u = coord + crop_off - st
    return (u >= 0) & (u % d < l) & (u // d < canvas_len // d)


def exact_mask(H: int, W: int, d: int, st_h: int, st_w: int, *, ratio: float = RATIO,
               mode: int = 1, device=None) -> torch.Tensor:
    """The reference mask for integer (d, st_h, st_w) -> (H, W) float32."""
    l = min(max(int(math.floor(d * ratio + 0.5)), 1), d - 1)
    hh, ww = int(1.5 * H), int(1.5 * W)
    row = _band(torch.arange(H, device=device)[:, None], hh, (hh - H) // 2, st_h, d, l)
    col = _band(torch.arange(W, device=device)[None, :], ww, (ww - W) // 2, st_w, d, l)
    banded = row | col
    keep = banded if mode == 1 else ~banded
    return keep.float()


def grid_mask(images: torch.Tensor, params: GridParams) -> torch.Tensor:
    """images (B, N, H, W, C) times the call's mask (or unchanged when the
    gate is off)."""
    if not params.apply:
        return images
    H, W = images.shape[2:4]
    mask = exact_mask(H, W, params.d, params.st_h, params.st_w, device=images.device)
    return images * mask[:, :, None].to(images.dtype)
