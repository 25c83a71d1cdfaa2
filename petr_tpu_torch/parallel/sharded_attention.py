"""Sequence-parallel decoder cross-attention over the token (model) axis.

Counterpart of `petr_tpu/parallel/sharded_attention.py`: K/V tokens are split
over the model group, the queries are replicated, each rank attends over its
own keys, and the partials combine exactly with one all-reduce pair.
``partial_softmax_attention`` is the plain form (a shared max, then the
denominator and numerator summed; dropout from the global mask's slice);
``flash_partial_attention`` runs K3
(``flash_cross_attention_with_lse``: the flash kernels with the lse
differentiable) on each shard and combines the shards by their lse
(`sharded_attention.py:76-104`). On the CPU K3 is its plain version through
the same autograd Function.

The collectives are autograd Functions in conjugate pairs, so that every
rank ends with the gradient of the one replicated loss:
  * ``to_model_region``: a replicated tensor used by shard-local work (the
    queries, the k/v projection weights) — identity forward, all-reduce
    (sum) of the cotangent backward, since each rank holds only its keys'
    share of the gradient;
  * ``scatter_to_model``: a replicated tensor cut to this rank's slice —
    the slice forward, the zero-padded cotangent all-reduced backward;
  * ``reduce_from_model``: shard partials summed into a replicated result —
    all-reduce forward, identity backward. (torch.distributed.nn's
    ``all_reduce`` all-reduces the cotangent too: under a loss replicated
    over the group that multiplies every gradient by the group's size.)
Collectives on CUDA tensors are all-reduce (SUM and MAX) and broadcast
only, which Gloo supports (staged through the host), so several ranks can
share one card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from petr_tpu_torch.ops.cross_attention import flash_cross_attention_with_lse
from petr_tpu_torch.parallel.mesh import Mesh

NEG = -1e30


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in a new tensor."""
    out = x.contiguous().clone()
    if group is not None:
        dist.all_reduce(out, group=group)
    return out


class _ToModelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, start, stop, size, group):
        ctx.meta = (x.shape, dim, start, stop, group)
        part = x.narrow(dim, start, stop - start)
        if stop - start < size:  # a short last shard: zero-padded
            pad = list(part.shape)
            pad[dim] = size - (stop - start)
            part = torch.cat([part, part.new_zeros(pad)], dim)
        return part.contiguous()

    @staticmethod
    def backward(ctx, g):
        shape, dim, start, stop, group = ctx.meta
        full = g.new_zeros(shape)
        full.narrow(dim, start, stop - start).copy_(g.narrow(dim, 0, stop - start))
        return _all_reduce(full, group), None, None, None, None, None


def to_model_region(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` (replicated over the model group) for shard-local work: its
    gradient is summed over the group in the backward."""
    return _ToModelRegion.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every rank's ``x`` over the model group, replicated."""
    return _ReduceFromModel.apply(x, mesh.model_group)


def scatter_to_model(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> Tuple[torch.Tensor, int]:
    """This rank's contiguous slice of ``x`` along ``dim`` (``mesh.token_range``;
    a short last shard zero-padded to the shard length) -> (slice, its first
    global index)."""
    start, stop, size = mesh.token_range(x.shape[dim])
    return _ScatterToModel.apply(x, dim, start, stop, size, mesh.model_group), start


def scatter_mask_to_model(mask: Optional[torch.Tensor], L: int, mesh: Mesh, batch: int,
                          device) -> Optional[torch.Tensor]:
    """This rank's slice of a (B, L) key-padding mask (True = pad), its
    zero-padded tail masked; None when there is no mask and no tail."""
    start, stop, size = mesh.token_range(L)
    if mask is None and stop - start == size:
        return None
    out = torch.ones((batch, size), dtype=torch.bool, device=device)
    out[:, :stop - start] = False if mask is None else mask[:, start:stop].to(torch.bool)
    return out


def _max_over_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise max of every rank's ``x`` over the model group,
    detached: one all-reduce (MAX), which Gloo also runs on CUDA tensors
    (petr_tpu gathers the ranks' values and takes their max)."""
    out = x.detach().contiguous().clone()
    if mesh.model_group is not None:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.model_group)
    return out


class KeyShard(NamedTuple):
    """This rank's slice of the decoder's keys under token sharding."""

    start: int  # its first global key
    total: int  # the global key count


def shard_keep_mask(shape: Tuple[int, int, int, int], rate: float, generator: torch.Generator, mesh: Mesh,
                    key_shard: KeyShard, device) -> torch.Tensor:
    """This rank's slice (B, H, Q, Ls) of the plain attention's dropout keep
    mask: the mask of the global batch and all the keys drawn as the
    unsharded attention draws it (``models.layers.dropout``), this rank's
    rows and keys kept, a padded tail of keys dropped."""
    B, H, Q, Ls = shape
    Bg, b0 = mesh.batch_rows(B) if mesh.data > 1 else (B, 0)
    start, stop = key_shard.start, min(key_shard.start + Ls, key_shard.total)
    u = torch.rand((Bg, H, Q, key_shard.total), generator=generator, device=device)
    keep = torch.zeros(shape, dtype=torch.bool, device=device)
    keep[..., :stop - start] = u[b0:b0 + B, ..., start:stop] >= rate
    return keep


def partial_softmax_attention(
    q: torch.Tensor,  # (B, H, Q, D) replicated
    k_shard: torch.Tensor,  # (B, H, Ls, D) this rank's keys
    v_shard: torch.Tensor,  # (B, H, Ls, D)
    mask_shard: Optional[torch.Tensor],  # (B, Ls) True = pad
    mesh: Mesh,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    key_shard: Optional[KeyShard] = None,
) -> torch.Tensor:
    """Exact masked softmax attention with K/V split over the model group:
    fp32 logits, a shared (detached) max, the denominator and numerator
    summed over the group (`sharded_attention.py:25-48`). With dropout the
    numerator takes the probabilities dropped by this rank's slice of the
    global keep mask (``shard_keep_mask``, from ``generator``; ``key_shard``
    places the slice) and the denominator the undropped ones, so the
    combine is the unsharded plain attention's dropout of its softmax."""
    D = q.shape[-1]
    q = to_model_region(q, mesh)
    s = torch.einsum("bhqd,bhld->bhql", q.float(), k_shard.float()) * (1.0 / math.sqrt(D))
    if mask_shard is not None:
        s = s.masked_fill(mask_shard[:, None, None, :].to(torch.bool), NEG)
    m = _max_over_model(s.amax(-1, keepdim=True), mesh)
    p = torch.exp(s - m)
    pv = p
    if dropout_rate > 0.0:
        if generator is None or key_shard is None:
            raise ValueError("sharded plain attention with dropout needs its generator and key_shard")
        keep = shard_keep_mask(tuple(p.shape), dropout_rate, generator, mesh, key_shard, p.device)
        pv = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    local = torch.cat([torch.einsum("bhql,bhld->bhqd", pv, v_shard.float()), p.sum(-1, keepdim=True)], -1)
    both = reduce_from_model(local, mesh)
    num, denom = both[..., :D], both[..., D:]
    return (num / denom.clamp(min=1e-20)).to(q.dtype)


def flash_partial_attention(
    q: torch.Tensor,  # (B, H, Q, D) replicated
    k_shard: torch.Tensor,  # (B, H, Ls, D) this rank's keys
    v_shard: torch.Tensor,  # (B, H, Ls, D)
    mask_shard: Optional[torch.Tensor],  # (B, Ls) True = pad
    mesh: Mesh,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    dropout_offsets: Tuple[int, int] = (0, 0),  # (first global batch row, first global key)
) -> torch.Tensor:
    """Sequence-parallel flash attention (`sharded_attention.py:76-104`):
    K3 on this rank's keys -> (out_i, lse_i); then
        out = sum_i exp(lse_i - m) out_i / sum_i exp(lse_i - m),
    the kernel's +1e30 lse of a fully masked row mapped to -1e30 so that an
    empty shard weighs 0, m the detached max of the ranks' lse, and one
    all-reduce of (sum w out, sum w). Dropout acts after each shard's
    denominator, on the keep mask of the global coordinates
    (``dropout_offsets``), so the combine equals the unsharded attention
    with dropout too. Returns (B, H, Q, D) in q's dtype, replicated."""
    D = q.shape[-1]
    q = to_model_region(q, mesh)
    out_i, lse_i = flash_cross_attention_with_lse(q, k_shard, v_shard, mask_shard, dropout_rate,
                                                  dropout_seed, dropout_offsets)
    lse_c = torch.where(lse_i >= 1e29, torch.full_like(lse_i, NEG), lse_i)
    w = torch.exp(lse_c - _max_over_model(lse_c, mesh))  # empty shards -> 0
    local = torch.cat([out_i.float() * w[..., None], w[..., None]], -1)
    both = reduce_from_model(local, mesh)
    num, den = both[..., :D], both[..., D:]
    return (num / den.clamp(min=1e-20)).to(q.dtype)


def _shard_inputs(k, v, key_padding_mask, mesh):
    """This rank's key slices of (B, H, L, D) k and v and of the mask."""
    B, L = k.shape[0], k.shape[2]
    ks, k0 = scatter_to_model(k, mesh, dim=2)
    vs, _ = scatter_to_model(v, mesh, dim=2)
    return ks, vs, scatter_mask_to_model(key_padding_mask, L, mesh, B, k.device), k0


def sharded_cross_attention(q, k, v, key_padding_mask, mesh: Mesh) -> torch.Tensor:
    """``partial_softmax_attention`` on this rank's slice of replicated
    (B, H, L, D) k and v (L need not divide evenly: a short last shard is
    padded and masked)."""
    ks, vs, ms, _ = _shard_inputs(k, v, key_padding_mask, mesh)
    return partial_softmax_attention(q, ks, vs, ms, mesh)


def sharded_flash_cross_attention(q, k, v, key_padding_mask, mesh: Mesh, dropout_rate: float = 0.0,
                                  dropout_seed: Optional[int] = None) -> torch.Tensor:
    """``flash_partial_attention`` on this rank's slice of replicated k and v,
    its keys' global offset passed to the dropout hash."""
    ks, vs, ms, k0 = _shard_inputs(k, v, key_padding_mask, mesh)
    return flash_partial_attention(q, ks, vs, ms, mesh, dropout_rate, dropout_seed, (0, k0))


def project_shard(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A linear map of this rank's token slice ``x`` whose (replicated)
    parameters take the gradient summed over the model group."""
    return F.linear(x, to_model_region(weight, mesh).to(x.dtype), to_model_region(bias, mesh).to(x.dtype))
