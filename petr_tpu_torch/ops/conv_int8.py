"""Int8 convolution with int32 accumulation (K6): the int8 PTQ backbone's conv.

Counterpart of petr_tpu's ``ConvBNReLU._int8_forward``
(`petr_tpu/models/layers.py:202-229`), which XLA computes outside any
Pallas kernel:

* the BN-folded weight ``wf = w * mul`` quantised per output channel,
  ``sw = max(max|wf|, 1e-12) / 127``, ``wi = clip(round(wf / sw), +-127)``;
* the activation quantised per tensor from its calibrated max,
  ``sa = max(amax, 1e-6) / 127``, ``xi = clip(round(x_f32 / sa), +-127)``
  (round half to even, a true division);
* the conv of xi and wi over int8 with int32 sums, kernel 1 or 3, stride 1
  or 2, padding k // 2;
* ``y = f32(acc) * (sa * sw) + add``, ReLU if asked, one cast to x's dtype.

The weight quantisation is plain PyTorch here as in petr_tpu (a few small
ops per conv). The rest is one op, ``torch.ops.petr_tpu_torch.conv_int8_bn_act``
(a ``torch.library`` custom op, so ``torch.export`` keeps it whole): on a
CUDA tensor it launches the two kernels of ``csrc/conv_int8.cu``, the
activation quantisation into a channels-last int8 copy and the conv on the
int8 tensor cores with the epilogue; on a CPU tensor it runs the plain
version, ``conv_int8_bn_act_reference``, which convolves the int8 operands
upcast to float64 with ``F.conv2d``: exact, since |acc| <= 9 * 1024 * 127^2
< 2^53. PyTorch has no CUDA call for an int8 conv into int32 sums, and on
the CPU ``F.conv2d`` of int8 tensors returns int8, which wraps.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from petr_tpu_torch.ops import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CHANNEL_STEP = 32  # the kernel's K step: input channels are padded to a multiple of it

# Launches since the count was last set to 0; only the CUDA path adds.
LAUNCHES = 0  # K6's conv kernel (int8 tensor cores, int32 sums, the epilogue)
QUANT_LAUNCHES = 0  # K6's activation quantisation pass (one per conv)


# --------------------------------------------------------------- the math
def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """sa = max(amax, 1e-6) / 127 in fp32, a 0-d tensor."""
    return torch.clamp_min(amax.float(), 1e-6) / 127.0


def quantize_weight(weight: torch.Tensor, mul: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW ``weight`` with the BN scale ``mul`` (Co,) folded in -> (wi int8
    OIHW, sw (Co,) fp32): symmetric per output channel."""
    wf = weight.float() * mul.float()[:, None, None, None]
    sw = torch.clamp_min(wf.abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
    wi = torch.clamp(torch.round(wf / sw[:, None, None, None]), -127.0, 127.0).to(torch.int8)
    return wi, sw


def quantize_activation(x: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """xi = clip(round(x_f32 / sa), -127, 127) as int8, x's layout."""
    return torch.clamp(torch.round(x.float() / sa), -127.0, 127.0).to(torch.int8)


def conv_int8_accumulate_reference(xi: torch.Tensor, wi: torch.Tensor, stride: int) -> torch.Tensor:
    """The int32 sums of the conv of int8 xi (B, C, H, W) and wi (Co, C, k, k),
    padding k // 2: exact through float64."""
    k = wi.shape[-1]
    return F.conv2d(xi.double(), wi.double(), stride=stride, padding=k // 2).to(torch.int32)


def conv_int8_bn_act_reference(x, wi, sa, scale, add, stride: int, relu: bool) -> torch.Tensor:
    """The op's plain version: quantise x, the exact int conv, the epilogue
    in fp32 (``acc * scale + add``, two roundings), ReLU, x's dtype."""
    acc = conv_int8_accumulate_reference(quantize_activation(x, sa), wi, stride)
    y = acc.float() * scale.float()[:, None, None] + add.float()[:, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


# ---------------------------------------------------------------- the op
def _out_shape(x: torch.Tensor, wi: torch.Tensor, stride: int) -> Tuple[int, int, int, int]:
    B, _, H, W = x.shape
    k = wi.shape[-1]
    return B, wi.shape[0], (H + 2 * (k // 2) - k) // stride + 1, (W + 2 * (k // 2) - k) // stride + 1


@torch.library.custom_op("petr_tpu_torch::conv_int8_bn_act", mutates_args=())
def conv_int8_bn_act_op(x: torch.Tensor, wi: torch.Tensor, sa: torch.Tensor, scale: torch.Tensor,
                        add: torch.Tensor, stride: int, relu: bool) -> torch.Tensor:
    """x (B, C, H, W) bf16/fp32, wi (Co, C, k, k) int8, sa () fp32, scale and
    add (Co,) fp32 -> (B, Co, Ho, Wo) in x's dtype. Any device but CUDA:
    the plain version."""
    return conv_int8_bn_act_reference(x, wi, sa, scale, add, stride, relu)


@conv_int8_bn_act_op.register_kernel("cuda")
def _conv_int8_bn_act_cuda(x, wi, sa, scale, add, stride, relu):
    return _forward_cuda(x, wi, sa, scale, add, stride, relu)[0]


@conv_int8_bn_act_op.register_fake
def _conv_int8_bn_act_fake(x, wi, sa, scale, add, stride, relu):
    return x.new_empty(_out_shape(x, wi, stride))


def conv_int8_bn_act(x: torch.Tensor, weight: torch.Tensor, mul: torch.Tensor, add: torch.Tensor,
                     amax: torch.Tensor, stride: int = 1, relu: bool = True) -> torch.Tensor:
    """petr_tpu's int8 ConvBNReLU forward: x (B, C, H, W), the fp32 OIHW conv
    weight, the folded BN ``mul``/``add`` (Co,), the calibrated ``amax`` ()
    -> (B, Co, Ho, Wo) in x's dtype. K6 on CUDA tensors, the plain version
    on CPU tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_int8_bn_act runs on cpu or cuda, not {x.device}")
    wi, sw = quantize_weight(weight, mul)
    sa = act_scale(amax)
    return conv_int8_bn_act_op(x, wi, sa, sa * sw, add.float(), stride, relu)


def conv_int8_bn_act_plain(x, weight, mul, add, amax, stride: int = 1, relu: bool = True) -> torch.Tensor:
    """The same computation on the plain version, on any device: the
    yardstick ``chip_smoke.py`` holds K6 to."""
    wi, sw = quantize_weight(weight, mul)
    sa = act_scale(amax)
    return conv_int8_bn_act_reference(x, wi, sa, sa * sw, add.float(), stride, relu)


# ----------------------------------------------------------- CUDA launch
def pack_weight(wi: torch.Tensor, Cp: int) -> torch.Tensor:
    """int8 OIHW (Co, C, k, k) -> (Co, k, k, Cp), zeros past C: the kernel's K
    order, tap-major and channel-minor."""
    Co, C, k, _ = wi.shape
    out = wi.new_zeros((Co, k, k, Cp))
    out[..., :C] = wi.permute(0, 2, 3, 1)
    return out


def _forward_cuda(x, wi, sa, scale, add, stride, relu, out: bool = True, acc: bool = False):
    """K6: the quantisation pass, then the conv -> (out or None, int32 sums
    or None)."""
    global LAUNCHES, QUANT_LAUNCHES
    if x.dim() != 4 or wi.dim() != 4 or wi.dtype != torch.int8:
        raise ValueError(f"x {tuple(x.shape)} must be NCHW and wi {tuple(wi.shape)} {wi.dtype} int8 OIHW")
    B, C, H, W = x.shape
    Co, Ci, k, k2 = wi.shape
    if Ci != C or k != k2 or k not in (1, 3) or stride not in (1, 2):
        raise ValueError(f"unsupported conv: x {tuple(x.shape)}, wi {tuple(wi.shape)}, stride {stride}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not (wi.device == sa.device == scale.device == add.device == x.device):
        raise ValueError("x, wi, sa, scale and add must be on one device")
    x = x.contiguous()
    sa = sa.to(torch.float32).contiguous()
    scale = scale.to(torch.float32).contiguous()
    add = add.to(torch.float32).contiguous()
    if scale.shape != (Co,) or add.shape != (Co,) or sa.numel() != 1:
        raise ValueError(f"scale {tuple(scale.shape)} and add {tuple(add.shape)} must be ({Co},), sa one value")
    Cp = -(-C // CHANNEL_STEP) * CHANNEL_STEP
    _, _, Ho, Wo = _out_shape(x, wi, stride)
    y = torch.empty((B, Co, Ho, Wo), dtype=x.dtype, device=x.device) if out else None
    sums = torch.empty((B, Co, Ho, Wo), dtype=torch.int32, device=x.device) if acc else None
    if B * Co * Ho * Wo == 0:
        return y, sums
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    xq = torch.empty((B, H, W, Cp), dtype=torch.int8, device=x.device)
    err = lib.petr_quantize_act(x.data_ptr(), _DTYPE_CODES[x.dtype], sa.data_ptr(), xq.data_ptr(),
                                B, C, H, W, Cp, stream)
    _raise_on(lib, err, "activation quantisation")
    QUANT_LAUNCHES += 1
    wq = pack_weight(wi, Cp)
    err = lib.petr_conv_int8_fwd(
        xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), add.data_ptr(),
        None if y is None else y.data_ptr(), None if sums is None else sums.data_ptr(),
        _DTYPE_CODES[x.dtype], B, Cp, H, W, Co, k, stride, Ho, Wo, int(relu), stream)
    _raise_on(lib, err, "conv")
    LAUNCHES += 1
    return y, sums


def conv_int8_accumulate(x: torch.Tensor, wi: torch.Tensor, sa: torch.Tensor, stride: int) -> torch.Tensor:
    """K6's int32 sums of quantised x and wi on a CUDA tensor (the check of the
    accumulators against ``conv_int8_accumulate_reference``)."""
    if x.device.type != "cuda":
        raise ValueError("conv_int8_accumulate launches K6: pass CUDA tensors")
    Co = wi.shape[0]
    zeros = torch.zeros(Co, dtype=torch.float32, device=x.device)
    return _forward_cuda(x, wi, sa, zeros, zeros, stride, False, out=False, acc=True)[1]


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"conv_int8 {what} kernel launch failed: " + lib.petr_cuda_error_string(err).decode())


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("conv_int8")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.petr_quantize_act.argtypes = [P, I, P, P, I, I, I, I, I, P]
    lib.petr_quantize_act.restype = I
    lib.petr_conv_int8_fwd.argtypes = [P] * 6 + [I] * 11 + [P]
    lib.petr_conv_int8_fwd.restype = I
    lib.petr_cuda_error_string.argtypes = [I]
    lib.petr_cuda_error_string.restype = ctypes.c_char_p
    return lib
