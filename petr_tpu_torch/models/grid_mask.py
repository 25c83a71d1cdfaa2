"""GridMask augmentation (PyTorch), the reference-exact and the float mode.

Counterpart of `petr_tpu/models/grid_mask.py` with ``exact=True``
(reference `models/utils/grid_mask.py`, sty61010/PETR, as the detector
calls it): use_h = use_w = True, mode 1 (the grid BANDS are kept),
ratio 0.5, prob 0.7, integer period d ~ randint[2, H), band length
l = min(max(int(d * ratio + 0.5), 1), d - 1), offsets st ~ randint[0, d),
on a 1.5x canvas center-cropped, never rotated. ONE mask per call,
broadcast over every (batch, view) image, behind one Bernoulli(prob) gate.

``exact=False`` is petr_tpu's per-SAMPLE variant (`grid_mask.py:74-99`):
each sample has its own Bernoulli(prob) gate, a float period
d ~ U[2, H), a band length keep = max(min(round(d * ratio), d - 1), 1)
(round half to even), offsets U[0, 1) * d, and an angle (0 in the
detector's call, so the draws hold 0). Pixel coordinates are rotated about
((H - 1) / 2, (W - 1) / 2) and a pixel is zeroed where both
mod(ry + off_y, d) < keep and mod(rx + off_x, d) < keep (a floor-mod:
``torch.remainder``); the mask is broadcast over the sample's views.

The parameters are drawn from the train step's ``torch.Generator`` before
the forward (``draw_grid_params``) and passed in, so that the forward is a
function of its arguments. The float draws are the global batch's; under
data parallelism each rank masks its rows with theirs.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from petr_tpu_torch.parallel.mesh import data_parallel

PROB = 0.7
RATIO = 0.5


@dataclasses.dataclass(frozen=True)
class GridParams:
    apply: bool  # the Bernoulli(prob) gate
    d: int  # period
    st_h: int  # row offset
    st_w: int  # column offset


@dataclasses.dataclass(frozen=True)
class FloatGridParams:
    """The ``exact=False`` draws, one row per sample of the global batch."""

    apply: torch.Tensor  # (B,) bool, the Bernoulli(prob) gates
    d: torch.Tensor  # (B,) float32 periods in [2, H)
    keep: torch.Tensor  # (B,) band lengths
    off: torch.Tensor  # (B, 2) (row, column) offsets in [0, d)
    ang: torch.Tensor  # (B,) angles in radians


def draw_grid_params(generator: torch.Generator, H: int, prob: float = PROB, exact: bool = True,
                     batch: int = 1):
    """One call's parameters. Exact: the gate, d in [2, H), offsets in
    [0, d) (``GridParams``). Float: ``batch`` samples' (``FloatGridParams``),
    unrotated, as the detector calls petr_tpu's (`detector.py:188`)."""
    if not exact:
        apply = torch.rand(batch, generator=generator) < prob
        d = 2.0 + torch.rand(batch, generator=generator) * (H - 2.0)
        keep = torch.clamp(torch.minimum(torch.round(d * RATIO), d - 1.0), min=1.0)
        off = torch.rand(batch, 2, generator=generator) * d[:, None]
        return FloatGridParams(apply, d, keep, off, torch.zeros(batch))
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


def float_masks(H: int, W: int, d: torch.Tensor, keep: torch.Tensor, off: torch.Tensor,
                ang: torch.Tensor) -> torch.Tensor:
    """petr_tpu's ``one_mask`` for each sample's (d, keep, off, ang) ->
    (B, H, W) float32, 0 where both rotated coordinates fall in a band."""
    dev = d.device
    yy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    c, s = torch.cos(ang)[:, None, None], torch.sin(ang)[:, None, None]
    ry = (yy - cy) * c - (xx - cx) * s + cy
    rx = (yy - cy) * s + (xx - cx) * c + cx
    d, keep = d[:, None, None], keep[:, None, None]
    my = torch.remainder(ry + off[:, 0, None, None], d) < keep
    mx = torch.remainder(rx + off[:, 1, None, None], d) < keep
    return 1.0 - (my & mx).float()


def grid_mask(images: torch.Tensor, params) -> torch.Tensor:
    """images (B, N, H, W, C) times the call's mask (or unchanged when the
    gate is off); with ``FloatGridParams`` each sample times its own mask,
    the rows of this rank under data parallelism."""
    H, W = images.shape[2:4]
    if isinstance(params, FloatGridParams):
        B = images.shape[0]
        mesh = data_parallel()
        b0 = 0 if mesh is None else mesh.batch_rows(B)[1]
        p = [t[b0:b0 + B].to(images.device) for t in (params.apply, params.d, params.keep, params.off, params.ang)]
        masks = torch.where(p[0][:, None, None], float_masks(H, W, *p[1:]), 1.0)
        return images * masks[:, None, :, :, None].to(images.dtype)
    if not params.apply:
        return images
    mask = exact_mask(H, W, params.d, params.st_h, params.st_w, device=images.device)
    return images * mask[:, :, None].to(images.dtype)
