"""Flash cross-attention forward: the PETR decoder's hot op.

900 object queries attend over the N*H*W tokens of all views (6000 at
800x320/p4) under a key-padding mask. On a CUDA tensor
``flash_cross_attention`` launches the hand-written kernel of
``petr_tpu_torch/csrc/flash_cross_attention.cu``, which replaces
`petr_tpu/ops/pallas/cross_attention.py::_kernel`; on a CPU tensor it runs
``flash_cross_attention_reference``, the dense fp32 version of the same
function, which the tests and ``chip_smoke.py`` hold the kernel to.

Semantics of both: scale 1/sqrt(D), masked keys (True = padded) take no
weight, fp32 softmax, output in the input dtype plus the per-row fp32
logsumexp. A row whose keys are all masked gives output 0 and lse +1e30.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from petr_tpu_torch.ops import build

NEG = -1e30
HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the count was last set to 0; only the CUDA path adds.
LAUNCHES = 0


def _check_dropout(dropout_rate: float) -> None:
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout needs petr_tpu's _dropout_keep hash ported bit for "
            "bit (ROADMAP.md §2, K2: the train slice)"
        )


def flash_cross_attention_reference(
    q: torch.Tensor,  # (B, H, Q, D)
    k: torch.Tensor,  # (B, H, L, D)
    v: torch.Tensor,  # (B, H, L, D)
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, L) True = pad
    dropout_rate: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense fp32 attention with the kernel's exact semantics -> (out, lse)."""
    _check_dropout(dropout_rate)
    B, H, Q, D = q.shape
    L = k.shape[2]
    if L == 0:
        return q.new_zeros(q.shape), torch.full((B, H, Q), -NEG, device=q.device)
    s = torch.matmul(q.float() * (1.0 / math.sqrt(D)), k.float().transpose(-1, -2))
    masked = None
    if key_padding_mask is not None:
        masked = key_padding_mask.to(torch.bool)[:, None, None, :]
        s = s.masked_fill(masked, NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if masked is not None:
        # a fully masked row has m == NEG and exp(0) == 1 everywhere: zero it
        p = p.masked_fill(masked, 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.matmul(p, v.float()) / l.clamp(min=1e-20)
    lse = torch.where(m <= NEG * 0.5, torch.full_like(m, -NEG), m + torch.log(l))
    return out.to(q.dtype), lse[..., 0]


def flash_cross_attention(
    q: torch.Tensor,  # (B, H, Q, D)
    k: torch.Tensor,  # (B, H, L, D)
    v: torch.Tensor,  # (B, H, L, D)
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, L) True = pad
    dropout_rate: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked cross-attention -> (out (B, H, Q, D) in q's dtype, lse (B, H, Q) fp32).

    q, k and v may be strided views (the last axis contiguous), such as the
    (B, H, ., D) transposes of (B, ., H, D) projections. On CUDA the output
    is a (B, H, Q, D) view of a (B, Q, H, D) buffer, so that merging the
    heads back into (B, Q, H*D) copies nothing.
    """
    _check_dropout(dropout_rate)
    if q.device.type == "cpu":
        return flash_cross_attention_reference(q, k, v, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_cross_attention runs on cpu or cuda, not {q.device}")
    return _flash_forward_cuda(q, k, v, key_padding_mask)


def _flash_forward_cuda(q, k, v, key_padding_mask):
    global LAUNCHES
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
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    mask_ptr = None
    if key_padding_mask is not None:
        if key_padding_mask.shape != (B, L):
            raise ValueError(f"key_padding_mask must be (B, L) = {(B, L)}, got {tuple(key_padding_mask.shape)}")
        key_padding_mask = key_padding_mask.to(device=q.device, dtype=torch.bool).contiguous()
        mask_ptr = key_padding_mask.data_ptr()

    out = torch.empty((B, Q, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Q), dtype=torch.float32, device=q.device)
    if Q == 0:
        return out, lse
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    lib = _library()
    err = lib.petr_flash_cross_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        lse.data_ptr(), B, H, Q, L, D, _DTYPE_CODES[q.dtype], strides,
        1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "flash_cross_attention kernel launch failed: "
            + lib.petr_cuda_error_string(err).decode()
        )
    LAUNCHES += 1
    return out, lse


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("flash_cross_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.petr_flash_cross_attention_fwd.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, p,
    ]
    lib.petr_flash_cross_attention_fwd.restype = ctypes.c_int
    lib.petr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.petr_cuda_error_string.restype = ctypes.c_char_p
    return lib
