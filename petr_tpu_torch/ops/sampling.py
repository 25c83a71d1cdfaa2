"""Bilinear sampling with zeros outside the plane (PyTorch).

Counterpart of `petr_tpu/ops/sampling.py`: the same signatures, feat
(H, W, C) channels-last and points (..., 2) as (x, y) in pixels, where
(0, 0) is the centre of the top-left pixel. Each of the four corners is read
where it lies inside the plane and counts as 0 where it does not
(`sampling.py:32-38`), so a point half a pixel outside an edge gets half of
the edge pixel. ``bilinear_sample_batched`` is the same over a leading batch
axis, as ``jax.vmap(bilinear_sample)``; the DCN's plain version uses it.

Its corner reads go through ``gather_rows``, whose backward sums in a fixed
order: ``torch.gather``'s backward on CUDA is a ``scatter_add`` with
atomics, so wherever one pixel is a corner of several samples its gradient
was summed in the order the atomics landed, and the bf16 r50dcn train step
(whose DCN backward is autograd of this formulation) gave another
``grad_norm`` on every run.
"""

from __future__ import annotations

import torch


def sum_into_rows_sorted(out: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """out (B, R, C) += grad (B, P, C) summed into rows idx (B, P), by
    ``index_put_(accumulate=True)`` over the flattened rows: on CUDA that
    sorts the row indices (a stable sort) and adds each row's run of
    contributions in the order of the points, with no atomics."""
    B, R, C = out.shape
    rows = (idx + torch.arange(B, device=idx.device)[:, None] * R).reshape(-1)
    out.view(B * R, C).index_put_((rows,), grad.reshape(-1, C), accumulate=True)
    return out


def sum_rows(vals: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """vals (B, P, C) summed into ``rows`` rows by idx (B, P) -> (B, rows, C),
    differentiably and in a fixed order: on CUDA ``sum_into_rows_sorted``
    (no atomics), on the CPU ``scatter_add``, which sums serially in the
    points' order."""
    B, P, C = vals.shape
    out = vals.new_zeros(B, rows, C)
    if vals.device.type == "cuda":
        return sum_into_rows_sorted(out, idx, vals)
    return out.scatter_add(1, idx[..., None].expand(B, P, C), vals)


class _GatherRows(torch.autograd.Function):
    """flat (B, R, C), idx (B, P) -> flat[b, idx[b, p]] as (B, P, C).

    Forward: ``torch.gather``. Backward: each source row's contributions
    summed in a fixed order, the same on every run: on CUDA by
    ``sum_into_rows_sorted``; on the CPU by ``scatter_add_``, which sums
    serially in the points' order (there ``index_put_``'s accumulation is
    the one that is not reproducible)."""

    @staticmethod
    def forward(ctx, flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.rows = flat.shape[1]
        B, P = idx.shape
        return torch.gather(flat, 1, idx[..., None].expand(B, P, flat.shape[2]))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        B, P, C = grad.shape
        out = grad.new_zeros(B, ctx.rows, C)
        if grad.device.type == "cuda":
            return sum_into_rows_sorted(out, idx, grad), None
        return out.scatter_add_(1, idx[..., None].expand(B, P, C), grad), None


def gather_rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(flat, 1, idx[..., None].expand(...))`` for flat
    (B, R, C) and idx (B, P) int64, with a backward that sums each row's
    gradient in a fixed order (``_GatherRows``)."""
    return _GatherRows.apply(flat, idx)


def bilinear_sample_batched(feat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W, C), xy (B, ..., 2) -> (B, ..., C), in feat's dtype
    promoted with fp32 (the weights are fp32)."""
    B, H, W, C = feat.shape
    pts = xy.shape[1:-1]
    x = xy[..., 0].float().reshape(B, -1)
    y = xy[..., 1].float().reshape(B, -1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    flat = feat.reshape(B, H * W, C)

    def gather(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()  # (B, P)
        v = gather_rows(flat, idx)
        return torch.where(inb[..., None], v, 0.0)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    out = (
        v00 * (1 - wx) * (1 - wy)
        + v01 * wx * (1 - wy)
        + v10 * (1 - wx) * wy
        + v11 * wx * wy
    )
    return out.reshape(B, *pts, C)


def bilinear_sample(feat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample ``feat`` (H, W, C) at fractional pixel locations ``xy``
    (..., 2) as (x, y) -> (..., C); out-of-bounds corners read 0."""
    return bilinear_sample_batched(feat[None], xy[None])[0]


def grid_sample_normalized_batched(feat: torch.Tensor, grid: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """torch-style grid_sample with coords in [-1, 1]: feat (B, H, W, C),
    grid (B, ..., 2) normalized (x, y) -> (B, ..., C)."""
    H, W = feat.shape[1:3]
    gx = grid[..., 0]
    gy = grid[..., 1]
    if align_corners:
        x = (gx + 1.0) * 0.5 * (W - 1)
        y = (gy + 1.0) * 0.5 * (H - 1)
    else:
        x = ((gx + 1.0) * W - 1.0) * 0.5
        y = ((gy + 1.0) * H - 1.0) * 0.5
    return bilinear_sample_batched(feat, torch.stack([x, y], dim=-1))


def grid_sample_normalized(feat: torch.Tensor, grid: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """torch-style grid_sample with coords in [-1, 1]: feat (H, W, C), grid
    (..., 2) normalized (x, y)."""
    return grid_sample_normalized_batched(feat[None], grid[None], align_corners)[0]
