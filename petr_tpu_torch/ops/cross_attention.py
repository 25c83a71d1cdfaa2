"""Flash cross-attention, forward and backward: the PETR decoder's hot op.

900 object queries attend over the N*H*W tokens of all views (6000 at
800x320/p4) under a key-padding mask. One ``torch.autograd.Function`` carries
it both ways. On CUDA tensors its forward launches K1, a hand-written
kernel of ``petr_tpu_torch/csrc/flash_cross_attention.cu`` (replacing
`petr_tpu/ops/pallas/cross_attention.py::_kernel`), and its backward
launches K2, the two kernels of ``csrc/flash_cross_attention_bwd.cu``
(replacing `_bwd_kernel`): each on the tensor cores for bf16, on the CUDA
cores for fp32, chosen by dtype. On CPU tensors it runs the plain versions,
``flash_cross_attention_reference`` and
``flash_cross_attention_backward_reference``: dense fp32 PyTorch with the
same semantics, which the tests and ``chip_smoke.py`` hold the kernels to.
The bf16 forward rounds the probabilities to bf16 for their product with v;
``flash_cross_attention_reference(..., round_p=True)`` makes that rounding
at the same point (its rounding floor).

Semantics: scale 1/sqrt(D), masked keys (True = padded) take no weight, fp32
softmax, output in the input dtype plus the per-row fp32 logsumexp. A row
whose keys are all masked gives output 0, lse +1e30 and zero gradients.
Attention dropout (the train step's) drops the normalised probabilities by
a keep mask hashed from the global (query, key) coordinates, the seed and
b*H + h, bit for bit `_dropout_keep`; the softmax denominator and lse are
taken before dropout, and the backward regenerates the mask from the hash.
A shard of a larger problem (a rank's batch rows, or its slice of the keys)
passes ``dropout_offsets`` = (its first global batch row, its first global
key), and then draws exactly its slice of the whole problem's mask: petr_tpu
hashes global coordinates because its sharded step is one program over the
global batch (`_dropout_keep`, `cross_attention.py:37-52`). (0, 0), the
default, is the whole problem.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from petr_tpu_torch.ops import build
from petr_tpu_torch.ops.conv3x3 import _sm_count

NEG = -1e30
LOG2E = 1.4426950408889634
HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF

# Kernel launches since the count was last set to 0; only the CUDA path adds.
LAUNCHES = 0  # K1, the forward, bf16 on the tensor cores
LAUNCHES_FP32 = 0  # K1, the forward, fp32 on the CUDA cores
DKDV_LAUNCHES = 0  # K2's dK/dV kernel, bf16 on the tensor cores
DQ_LAUNCHES = 0  # K2's dQ kernel, bf16 on the tensor cores
DKDV_LAUNCHES_FP32 = 0  # K2's dK/dV kernel, fp32 on the CUDA cores
DQ_LAUNCHES_FP32 = 0  # K2's dQ kernel, fp32 on the CUDA cores
# FLOPs of K2's backwards by formula (``backward_flops``), which no dispatcher
# sees (ctypes launches inside an autograd backward): ``utils.mfu.count_flops``
# adds them to what ``torch.utils.flop_counter`` counts. Only the CUDA path adds.
BACKWARD_FLOPS = 0


# ------------------------------------------------------------- dropout hash
def dropout_threshold(rate: float) -> int:
    """The uint32 threshold of the keep test ``hash >= threshold``."""
    return min(int(rate * 4294967296.0), 4294967295)


def _mul32(a, c: int):
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a uint32 constant:
    in 16-bit halves, so that no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash_keep(seed: int, bh, rows: torch.Tensor, cols: torch.Tensor, rate: float) -> torch.Tensor:
    """The keep mask over broadcast int64 ``rows`` (global query indices),
    ``cols`` (global key indices) and ``bh`` (b*H + h, int or int64 tensor):
    `_dropout_keep`'s uint32 arithmetic in int64 masked to 32 bits."""
    seed = int(seed) & _M32  # an int32 seed's bits, as uint32
    mix = ((seed * 0x85EBCA6B) & _M32) + _mul32(torch.as_tensor(bh, dtype=torch.int64), 0xC2B2AE35)
    h = (_mul32(rows, 0x9E3779B9) + cols + mix.to(rows.device)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h >= dropout_threshold(rate)


def _dropout_keep(seed: int, bh: int, qi: int, ki: int, BQ: int, bk: int, rate: float) -> torch.Tensor:
    """`petr_tpu`'s ``_dropout_keep`` with its arguments: the (BQ, bk) keep
    mask of query block ``qi`` and key block ``ki`` of batch*head ``bh``."""
    rows = ((qi * BQ) & _M32) + torch.arange(BQ, dtype=torch.int64)[:, None]
    cols = ((ki * bk) & _M32) + torch.arange(bk, dtype=torch.int64)[None, :]
    return _hash_keep(seed, bh, rows & _M32, cols & _M32, rate)


def dropout_keep_mask(seed: int, B: int, H: int, Q: int, L: int, rate: float,
                      device=None, offsets: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """The (B, H, Q, L) keep mask the kernels hash, as a bool tensor: the
    whole problem's, or with ``offsets`` = (first batch row, first key) the
    slice of a larger problem's mask at those global coordinates."""
    b0, k0 = offsets
    bh = torch.arange(b0 * H, (b0 + B) * H, dtype=torch.int64, device=device).view(B, H, 1, 1)
    rows = torch.arange(Q, dtype=torch.int64, device=device).view(1, 1, Q, 1)
    cols = torch.arange(k0, k0 + L, dtype=torch.int64, device=device).view(1, 1, 1, L)
    return _hash_keep(seed, bh & _M32, rows, cols & _M32, rate)


# ----------------------------------------------------------- plain versions
def flash_cross_attention_reference(
    q: torch.Tensor,  # (B, H, Q, D)
    k: torch.Tensor,  # (B, H, L, D)
    v: torch.Tensor,  # (B, H, L, D)
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, L) True = pad
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    round_p: bool = False,
    dropout_offsets: Tuple[int, int] = (0, 0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense fp32 attention with K1's exact semantics -> (out, lse).

    ``round_p=True`` is the bf16 kernel's rounding floor: the logits in log2
    units (q.k times fp32(scale * log2 e)), p = exp2(t - max) against each
    row's final maximum, and p rounded to bf16 before its product with v,
    where the kernel rounds it; the denominator and lse come from the
    unrounded p, and the dropout scale is applied after the product."""
    B, H, Q, D = q.shape
    L = k.shape[2]
    if L == 0:
        return q.new_zeros(q.shape), torch.full((B, H, Q), -NEG, device=q.device)
    masked = None if key_padding_mask is None else key_padding_mask.to(torch.bool)[:, None, None, :]
    if round_p:
        return _reference_rounded(q, k, v, masked, dropout_rate, dropout_seed, dropout_offsets)
    s = torch.matmul(q.float() * (1.0 / math.sqrt(D)), k.float().transpose(-1, -2))
    if masked is not None:
        s = s.masked_fill(masked, NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if masked is not None:
        # a fully masked row has m == NEG and exp(0) == 1 everywhere: zero it
        p = p.masked_fill(masked, 0.0)
    l = p.sum(-1, keepdim=True)  # the denominator is taken before dropout
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(dropout_seed or 0, B, H, Q, L, dropout_rate, q.device, dropout_offsets)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    out = torch.matmul(p, v.float()) / l.clamp(min=1e-20)
    lse = torch.where(m <= NEG * 0.5, torch.full_like(m, -NEG), m + torch.log(l))
    return out.to(q.dtype), lse[..., 0]


def logit_scale_log2(D: int) -> float:
    """fp32(1/sqrt(D)) * fp32(log2 e), rounded to fp32: the factor by which
    the bf16 kernel takes q.k to log2 units (its ``scale * LOG2E``)."""
    # the product of two fp32 values is exact in fp64, so rounding it once
    # to fp32 gives fp32's product; pure Python, so that tracing sees a constant
    return _fp32(_fp32(1.0 / math.sqrt(D)) * _fp32(LOG2E))


def _fp32(x: float) -> float:
    return struct.unpack("f", struct.pack("f", x))[0]


def _reference_rounded(q, k, v, masked, dropout_rate, dropout_seed, dropout_offsets=(0, 0)):
    """``flash_cross_attention_reference(..., round_p=True)``."""
    B, H, Q, D = q.shape
    L = k.shape[2]
    t = torch.matmul(q.float(), k.float().transpose(-1, -2)) * logit_scale_log2(D)
    if masked is not None:
        t = t.masked_fill(masked, NEG)
    m = t.amax(-1, keepdim=True)
    p = torch.exp2(t - m)
    if masked is not None:
        p = p.masked_fill(masked, 0.0)
    l = p.sum(-1, keepdim=True)
    p = p.bfloat16().float()
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(dropout_seed or 0, B, H, Q, L, dropout_rate, q.device, dropout_offsets)
        p = torch.where(keep, p, 0.0)
    out = torch.matmul(p, v.float()) / (1.0 - dropout_rate) / l.clamp(min=1e-20)
    lse = torch.where(m <= NEG * 0.5, torch.full_like(m, -NEG), (m + torch.log2(l)) * math.log(2.0))
    return out.to(q.dtype), lse[..., 0]


def _delta(gout: torch.Tensor, out: torch.Tensor, glse: Optional[torch.Tensor]) -> torch.Tensor:
    """rowsum(dO * O) - g_lse in fp32, from ``out`` as stored (`:371-373`):
    the lse cotangent folds in here, since d lse / d s = p."""
    delta = (gout.float() * out.float()).sum(-1)
    if glse is not None:
        delta = delta - glse.float()
    return delta.contiguous()


def _backward_plain(q, k, v, key_padding_mask, gout, lse, delta, dropout_rate, dropout_seed,
                    dropout_offsets=(0, 0)):
    """`_bwd_kernel` as dense fp32 math -> fp32 (dq, dk, dv)."""
    B, H, Q, D = q.shape
    L = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), gout.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if key_padding_mask is not None:
        s = s.masked_fill(key_padding_mask.to(torch.bool)[:, None, None, :], NEG)
    # p <= 1: the clamp keeps a recomputed logit a rounding step above the
    # saved lse from overflowing exp (`:235-242`); lse = +1e30 gives p = 0
    p = torch.exp(torch.clamp(s - lse[..., None], max=0.0))
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    p_drop = p
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(dropout_seed or 0, B, H, Q, L, dropout_rate, q.device, dropout_offsets)
        p_drop = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
        dp = torch.where(keep, dp / (1.0 - dropout_rate), 0.0)
    dv = torch.matmul(p_drop.transpose(-1, -2), gf)
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq, dk, dv


def flash_cross_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor],
    out: torch.Tensor,  # the forward's output, as stored
    lse: torch.Tensor,  # (B, H, Q) fp32
    gout: torch.Tensor,  # cotangent of out
    glse: Optional[torch.Tensor] = None,  # cotangent of lse
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    dropout_offsets: Tuple[int, int] = (0, 0),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense fp32 K2 (`_flash_bwd_shared` + `_bwd_kernel`) -> (dq, dk, dv)
    in the input dtype."""
    delta = _delta(gout, out, glse)
    grads = _backward_plain(q, k, v, key_padding_mask, gout, lse, delta, dropout_rate, dropout_seed,
                            dropout_offsets)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


# ------------------------------------------------------------------ FLOPs
def forward_flops(B: int, H: int, Q: int, L: int, D: int) -> int:
    """The plain forward's matmul FLOPs, q.k and p.v: 2 x 2 B H Q L D."""
    return 4 * B * H * Q * L * D


def backward_flops(B: int, H: int, Q: int, L: int, D: int) -> int:
    """The plain backward's matmul FLOPs: the logits again, dP, dV, dQ and
    dK, 5 x 2 B H Q L D (K2's two kernels each recompute the logits and dP;
    the count is of the function, not of its kernels)."""
    return 10 * B * H * Q * L * D


# ------------------------------------------------------------ the op (K1)
@torch.library.custom_op("petr_tpu_torch::flash_cross_attention_fwd", mutates_args=())
def flash_cross_attention_fwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_padding_mask: Optional[torch.Tensor],
    dropout_rate: float, dropout_seed: Optional[int], batch_offset: int, key_offset: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward as a ``torch.library`` op, so that ``torch.export`` keeps
    it whole: K1 on CUDA tensors, the plain version on any other device."""
    return flash_cross_attention_reference(q, k, v, key_padding_mask, dropout_rate, dropout_seed,
                                           dropout_offsets=(batch_offset, key_offset))


@flash_cross_attention_fwd_op.register_kernel("cuda")
def _flash_cross_attention_fwd_cuda(q, k, v, key_padding_mask, dropout_rate, dropout_seed, batch_offset,
                                    key_offset):
    return _forward_cuda(q, k, v, key_padding_mask, dropout_rate, dropout_seed,
                         offsets=(batch_offset, key_offset))


@flash_cross_attention_fwd_op.register_fake
def _flash_cross_attention_fwd_fake(q, k, v, key_padding_mask, dropout_rate, dropout_seed, batch_offset,
                                    key_offset):
    B, H, Q, D = q.shape
    if q.device.type == "cuda":  # K1 writes a (B, H, Q, D) view of a (B, Q, H, D) buffer
        out = q.new_empty((B, Q, H, D)).transpose(1, 2)
    else:
        out = q.new_empty((B, H, Q, D))
    return out, q.new_empty((B, H, Q), dtype=torch.float32)


@register_flop_formula(torch.ops.petr_tpu_torch.flash_cross_attention_fwd)
def _flash_cross_attention_fwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    return forward_flops(*q_shape[:3], k_shape[2], q_shape[3])


# --------------------------------------------------------------- autograd
class _FlashCrossAttention(torch.autograd.Function):
    """(q, k, v) -> (out, lse). Saves q, k, v, the mask, the seed and its
    offsets, out and lse; the backward recomputes the probabilities (and the
    keep mask)."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, dropout_rate, dropout_seed, lse_grad, plain, offsets):
        if plain:
            out, lse = flash_cross_attention_reference(q, k, v, key_padding_mask, dropout_rate, dropout_seed,
                                                       dropout_offsets=offsets)
        else:
            out, lse = flash_cross_attention_fwd_op(q, k, v, key_padding_mask, dropout_rate, dropout_seed, *offsets)
        ctx.save_for_backward(q, k, v, key_padding_mask, out, lse)
        ctx.dropout = (dropout_rate, dropout_seed, offsets)
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        if not lse_grad:
            ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, gout, glse):
        global BACKWARD_FLOPS
        q, k, v, key_padding_mask, out, lse = ctx.saved_tensors
        if gout is None:
            gout = torch.zeros_like(out)
        delta = _delta(gout, out, glse)
        rate, seed, offsets = ctx.dropout
        if ctx.plain or q.device.type == "cpu":
            grads = _backward_plain(q, k, v, key_padding_mask, gout, lse, delta, rate, seed, offsets)
            dq, dk, dv = (g.to(t.dtype) for g, t in zip(grads, (q, k, v)))
        else:
            dq, dk, dv = _backward_cuda(q, k, v, key_padding_mask, gout, lse, delta, rate, seed, offsets=offsets)
            BACKWARD_FLOPS += backward_flops(*q.shape[:3], k.shape[2], q.shape[3])
        return dq, dk, dv, None, None, None, None, None, None


def _check_device(q: torch.Tensor) -> None:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_cross_attention runs on cpu or cuda, not {q.device}")


def flash_cross_attention(
    q: torch.Tensor,  # (B, H, Q, D)
    k: torch.Tensor,  # (B, H, L, D)
    v: torch.Tensor,  # (B, H, L, D)
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, L) True = pad
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,  # int32 (train only)
    dropout_offsets: Tuple[int, int] = (0, 0),  # this shard's (first batch row, first key)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked cross-attention -> (out (B, H, Q, D) in q's dtype, lse (B, H, Q) fp32).

    Differentiable in q, k and v (K2 on CUDA); lse is not (see
    ``flash_cross_attention_with_lse``). q, k and v may be strided views
    (the last axis contiguous), such as the (B, H, ., D) transposes of
    (B, ., H, D) projections. On CUDA the output is a (B, H, Q, D) view of
    a (B, Q, H, D) buffer, so that merging the heads copies nothing.
    """
    _check_device(q)
    return _FlashCrossAttention.apply(q, k, v, key_padding_mask, dropout_rate, dropout_seed, False, False,
                                      tuple(dropout_offsets))


def flash_cross_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    dropout_offsets: Tuple[int, int] = (0, 0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: like ``flash_cross_attention``, but differentiable in lse too, the
    combiner of sequence-parallel attention (`flash_cross_attention_with_lse`,
    `cross_attention.py:402`). The lse cotangent folds into delta."""
    _check_device(q)
    return _FlashCrossAttention.apply(q, k, v, key_padding_mask, dropout_rate, dropout_seed, True, False,
                                      tuple(dropout_offsets))


def flash_cross_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    lse_grad: bool = False,
    dropout_offsets: Tuple[int, int] = (0, 0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same Function on the plain versions both ways, on any device:
    the yardstick ``chip_smoke.py`` holds the kernels' train step to."""
    return _FlashCrossAttention.apply(q, k, v, key_padding_mask, dropout_rate, dropout_seed, lse_grad, True,
                                      tuple(dropout_offsets))


# ------------------------------------------------------------ CUDA launches
def _check_inputs(q, k, v):
    B, H, Q, D = q.shape
    L = k.shape[2]
    if k.shape != (B, H, L, D) or v.shape != (B, H, L, D):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of float32/bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the kernel (supported: {HEAD_DIMS})")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid limit")
    return B, H, Q, L, D


def _last_contiguous(*ts):
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in ts)


def _rows_aligned(*ts):
    """Each tensor as it is when its rows start on 16-byte boundaries (the
    bf16 kernels copy them in 16-byte pieces), else a contiguous
    copy in a new allocation: the (B, H, ., D) views of projections already
    are."""
    return tuple(t if t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
                 else t.clone(memory_format=torch.contiguous_format) for t in ts)


def _mask_ptr(key_padding_mask, B, L, device):
    if key_padding_mask is None:
        return None, None
    if key_padding_mask.shape != (B, L):
        raise ValueError(f"key_padding_mask must be (B, L) = {(B, L)}, got {tuple(key_padding_mask.shape)}")
    mask = key_padding_mask.to(device=device, dtype=torch.bool).contiguous()
    return mask, mask.data_ptr()


def _dropout_args(dropout_rate: float, dropout_seed: Optional[int], H: int = 1,
                  offsets: Tuple[int, int] = (0, 0)):
    """(on, seed bits, threshold, keep probability, first global b*H + h,
    first global key) for the C interface."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate == 0.0:
        return 0, 0, 0, 1.0, 0, 0
    b0, k0 = offsets
    return (1, int(dropout_seed or 0) & _M32, dropout_threshold(dropout_rate), 1.0 - dropout_rate,
            (b0 * H) & _M32, k0 & _M32)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: " + lib.petr_cuda_error_string(err).decode())


def attention_plan(batch_heads: int, Q: int, sms: int) -> int:
    """Query warps per block of the bf16 forward (``query_warps``, 2 or 4):
    its 8 warps hold 16 query rows each in 8 / query_warps key splits. 64-row
    blocks (4 query warps, 2 key splits) where they reach one block per SM;
    else 32-row blocks (4 key splits), twice as many. At the flagship (B=1, 8
    heads, Q = 900) on 132 SMs: 120 blocks of 64 rows, so 232 of 32."""
    return 4 if -(-Q // 64) * batch_heads >= sms else 2


def key_split_plan(L: int, query_warps: int):
    """The keys each key split of the bf16 forward covers, in the order the
    kernel adds their partial sums: split w takes keys w*64 .. w*64 + 63 of
    every staged tile of (8 / query_warps) * 64 keys -> one list of key
    ranges per split."""
    splits = 8 // query_warps
    tile = splits * 64
    return [[(t + 64 * w, min(t + 64 * w + 64, L)) for t in range(0, L, tile) if t + 64 * w < L]
            for w in range(splits)]


def _forward_cuda(q, k, v, key_padding_mask, dropout_rate, dropout_seed, query_warps=None, offsets=(0, 0)):
    """K1: (out, lse), the tensor-core kernel for bf16 and the CUDA-core one
    for fp32. ``query_warps`` overrides ``attention_plan`` (bf16 only);
    ``offsets`` are the hash's (first batch row, first key)."""
    global LAUNCHES, LAUNCHES_FP32
    B, H, Q, L, D = _check_inputs(q, k, v)
    q, k, v = _last_contiguous(q, k, v)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v = _rows_aligned(q, k, v)
        if query_warps is None:
            query_warps = attention_plan(B * H, Q, _sm_count(q.device))
        if query_warps not in (2, 4):
            raise ValueError(f"query_warps must be 2 or 4, got {query_warps}")
    _, mask_ptr = _mask_ptr(key_padding_mask, B, L, q.device)
    drop = _dropout_args(dropout_rate, dropout_seed, H, offsets)
    out = torch.empty((B, Q, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Q), dtype=torch.float32, device=q.device)
    if Q == 0:
        return out, lse
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    lib = _forward_library()
    err = lib.petr_flash_cross_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        lse.data_ptr(), B, H, Q, L, D, _DTYPE_CODES[q.dtype], strides,
        1.0 / math.sqrt(D), *drop, query_warps or 0, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, err, "flash_cross_attention " + ("bf16" if bf16 else "fp32"))
    if bf16:
        LAUNCHES += 1
    else:
        LAUNCHES_FP32 += 1
    return out, lse


def _backward_cuda(q, k, v, key_padding_mask, gout, lse, delta, dropout_rate, dropout_seed,
                   kernels=("dkdv", "dq"), offsets=(0, 0)):
    """K2: (dq, dk, dv) in q's dtype, from the dK/dV kernel and the dQ kernel,
    the tensor-core variants for bf16 and the CUDA-core ones for fp32.
    ``kernels`` names the kernels to launch (a timing can take one alone;
    the outputs of the other are then left unwritten)."""
    global DKDV_LAUNCHES, DQ_LAUNCHES, DKDV_LAUNCHES_FP32, DQ_LAUNCHES_FP32
    B, H, Q, L, D = _check_inputs(q, k, v)
    if gout.shape != q.shape or lse.shape != (B, H, Q) or delta.shape != (B, H, Q):
        raise ValueError(f"gout {tuple(gout.shape)}, lse {tuple(lse.shape)}, delta {tuple(delta.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    q, k, v, gout = _last_contiguous(q, k, v, gout.to(q.dtype))
    if q.dtype == torch.bfloat16:
        q, k, v, gout = _rows_aligned(q, k, v, gout)
    lse = lse.to(torch.float32).contiguous()
    delta = delta.to(torch.float32).contiguous()
    _, mask_ptr = _mask_ptr(key_padding_mask, B, L, q.device)
    drop = _dropout_args(dropout_rate, dropout_seed, H, offsets)
    # (B, H, ., D) views of (B, ., H, D) buffers, like the projections' grads
    dq = torch.empty((B, Q, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    if Q == 0 or L == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    strides = (ctypes.c_longlong * 21)(*(s for t in (q, k, v, gout, dq, dk, dv) for s in t.stride()[:3]))
    lib = _backward_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, gout.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    tail = (_DTYPE_CODES[q.dtype], strides, 1.0 / math.sqrt(D), *drop, stream)
    if "dkdv" in kernels:
        err = lib.petr_flash_cross_attention_bwd_dkdv(*common, dk.data_ptr(), dv.data_ptr(), B, H, Q, L, D, *tail)
        _raise_on(lib, err, "flash_cross_attention dK/dV")
        if q.dtype == torch.bfloat16:
            DKDV_LAUNCHES += 1
        else:
            DKDV_LAUNCHES_FP32 += 1
    if "dq" in kernels:
        err = lib.petr_flash_cross_attention_bwd_dq(*common, dq.data_ptr(), B, H, Q, L, D, *tail)
        _raise_on(lib, err, "flash_cross_attention dQ")
        if q.dtype == torch.bfloat16:
            DQ_LAUNCHES += 1
        else:
            DQ_LAUNCHES_FP32 += 1
    return dq, dk, dv


_P, _I = ctypes.c_void_p, ctypes.c_int
_DROP = [_I, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32]


def _bind(lib: ctypes.CDLL, fn: str, argtypes) -> None:
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
    lib.petr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.petr_cuda_error_string.restype = ctypes.c_char_p


@functools.lru_cache(maxsize=None)
def _forward_library() -> ctypes.CDLL:
    lib = build.load("flash_cross_attention")
    _bind(lib, "petr_flash_cross_attention_fwd", [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, *_DROP, _I, _P,
    ])
    return lib


@functools.lru_cache(maxsize=None)
def _backward_library() -> ctypes.CDLL:
    lib = build.load("flash_cross_attention_bwd")
    head = [_P] * 7
    tail = [_I, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, *_DROP, _P]
    _bind(lib, "petr_flash_cross_attention_bwd_dkdv", head + [_P, _P, _I, _I, _I, _I, _I] + tail)
    _bind(lib, "petr_flash_cross_attention_bwd_dq", head + [_P, _I, _I, _I, _I, _I] + tail)
    return lib
