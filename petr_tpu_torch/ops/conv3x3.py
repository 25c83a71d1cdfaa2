"""Fused 3x3 convolution + folded frozen BN + ReLU (K5), ConvBNReLU's opt-in route.

Counterpart of `petr_tpu/ops/pallas/conv3x3.py`: out = act(conv3x3(x, w) *
mul + add), stride 1 and padding 1, the conv summed in fp32, the epilogue in
fp32 and one rounding to x's dtype. Layout NCHW: x (B, C, H, W), weight
(Co, C, 3, 3) taken in x's dtype (cast if it is not), ``mul``/``add`` (Co,)
fp32 (the folded BN) or None for a plain conv.

One ``torch.autograd.Function`` carries it. On a CUDA tensor its forward
launches K5, a hand-written kernel of ``csrc/conv3x3_bn_relu.cu``
(replacing `petr_tpu/ops/pallas/conv3x3.py::_conv3x3_raw`), chosen by x's
dtype: bf16 runs the tensor-core kernel (an implicit GEMM on mma.sync, fed
by cp.async), fp32 the CUDA-core kernel, which keeps fp32 callers in fp32.
On a CPU tensor it runs the plain version, ``conv3x3_bn_relu_reference``,
which is `_xla_reference` (`conv3x3.py:113-123`). The backward is autograd
of the plain version, as JAX's `_bwd` (`conv3x3.py:140-143`) is the VJP of
`_xla_reference`.

The default route of ``ConvBNReLU`` stays cuDNN, as petr_tpu's stays XLA;
``PETR_TPU_TORCH_CONV_IMPL=cuda`` opts into K5 (``conv_impl``).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from petr_tpu_torch.ops import build

CONV_IMPL_ENV = "PETR_TPU_TORCH_CONV_IMPL"
CONV_IMPLS = ("cudnn", "cuda")

# K5 launches since the count was last set to 0; only the CUDA path adds.
LAUNCHES = 0  # the bf16 tensor-core kernel
LAUNCHES_FP32 = 0  # the fp32 CUDA-core kernel
SPLITK_LAUNCHES = 0  # the bf16 kernel's ordered reduction of a split K
# the bf16 kernel's output tile (pixels, channels: ``tc::BM``, ``tc::BN``)
# and its chunk of input channels (``tc::CK``)
TILE_PIXELS = 128
TILE_CHANNELS = 64
CHUNK_CHANNELS = 16


def conv_impl() -> str:
    """The route of ConvBNReLU's 3x3 stride-1 convs, from
    ``PETR_TPU_TORCH_CONV_IMPL`` (mirroring petr_tpu's
    ``PETR_TPU_CONV_IMPL=pallas``): 'cudnn' (the default) or 'cuda' (K5)."""
    impl = os.environ.get(CONV_IMPL_ENV, "cudnn")
    if impl not in CONV_IMPLS:
        raise ValueError(f"{CONV_IMPL_ENV}={impl!r}: expected one of {CONV_IMPLS}")
    return impl


def conv3x3_bn_relu_reference(
    x: torch.Tensor,  # (B, C, H, W)
    weight: torch.Tensor,  # (Co, C, 3, 3)
    mul: Optional[torch.Tensor],  # (Co,) fp32 or None
    add: Optional[torch.Tensor],  # (Co,) fp32 or None
    relu: bool = True,
) -> torch.Tensor:
    """`_xla_reference`: the conv of x and the weight in x's dtype summed in
    fp32, ``* mul + add`` in fp32, ReLU, one cast to x's dtype."""
    y = F.conv2d(x.float(), weight.to(x.dtype).float(), padding=1)
    if mul is not None:
        y = y * mul.float()[:, None, None] + add.float()[:, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


@torch.library.custom_op("petr_tpu_torch::conv3x3_bn_relu_fwd", mutates_args=())
def conv3x3_bn_relu_fwd_op(x: torch.Tensor, weight: torch.Tensor, mul: Optional[torch.Tensor],
                           add: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    """The forward as a ``torch.library`` op, so that ``torch.export`` keeps
    it whole: K5 on CUDA tensors, the plain version on any other device."""
    return conv3x3_bn_relu_reference(x, weight, mul, add, relu)


@conv3x3_bn_relu_fwd_op.register_kernel("cuda")
def _conv3x3_bn_relu_fwd_cuda(x, weight, mul, add, relu):
    return _forward_cuda(x, weight, mul, add, relu)


@conv3x3_bn_relu_fwd_op.register_fake
def _conv3x3_bn_relu_fwd_fake(x, weight, mul, add, relu):
    return x.new_empty((x.shape[0], weight.shape[0], *x.shape[2:]))


@register_flop_formula(torch.ops.petr_tpu_torch.conv3x3_bn_relu_fwd)
def _conv3x3_bn_relu_fwd_flops(x_shape, weight_shape, *args, out_shape=None, **kwargs) -> int:
    """The plain version's conv, 2 B H W Co C 9 (the epilogue is elementwise)."""
    B, C, H, W = x_shape
    return 2 * B * H * W * weight_shape[0] * C * 9


class _Conv3x3BNReLU(torch.autograd.Function):
    """(x, weight, mul, add) -> out. Forward: K5 on CUDA, the plain version
    on the CPU or when ``plain``. Backward: autograd of the plain version."""

    @staticmethod
    def forward(ctx, x, weight, mul, add, relu, plain):
        if plain:
            out = conv3x3_bn_relu_reference(x, weight, mul, add, relu)
        else:
            out = conv3x3_bn_relu_fwd_op(x, weight, mul, add, relu)
        ctx.save_for_backward(x, weight, mul, add)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, gout):
        saved = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad[:4])]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            out = conv3x3_bn_relu_reference(*inputs, ctx.relu)
            grads = iter(torch.autograd.grad(out, wanted, gout))
        return (*(next(grads) if t is not None and t.requires_grad else None for t in inputs), None, None)


def conv3x3_bn_relu(
    x: torch.Tensor,
    weight: torch.Tensor,
    mul: Optional[torch.Tensor] = None,
    add: Optional[torch.Tensor] = None,
    relu: bool = True,
) -> torch.Tensor:
    """Fused conv3x3 (stride 1, padding 1) + scale/shift + ReLU -> (B, Co, H, W)
    in x's dtype; K5 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_bn_relu runs on cpu or cuda, not {x.device}")
    if (mul is None) != (add is None):
        raise ValueError("pass mul and add together, or neither")
    return _Conv3x3BNReLU.apply(x, weight, mul, add, relu, False)


def conv3x3_bn_relu_plain(x, weight, mul=None, add=None, relu=True) -> torch.Tensor:
    """The same Function on the plain version, on any device: the yardstick
    ``chip_smoke.py`` holds K5 to."""
    return _Conv3x3BNReLU.apply(x, weight, mul, add, relu, True)


@functools.lru_cache(maxsize=None)
def conv_tile(H: int, W: int, pixels: int = TILE_PIXELS) -> Tuple[int, int]:
    """The (TH, TW) output tile of the bf16 kernel for an H x W plane.

    A block computes ``pixels`` output pixels whatever its tile holds, so the
    tile is chosen to need the fewest blocks: every TH with TW = pixels //
    TH, each balanced over the plane (W = 50 takes two tiles of 25, not 32 +
    18). Within 3% of the fewest, the widest tile wins: its halo rows are
    longer runs of x. At all four VoVNet planes this gives 5 x 25 (2% of
    lanes idle)."""
    cands = []
    for th in range(1, min(H, pixels) + 1):
        ncol = -(-W // (pixels // th))
        tw = -(-W // ncol)
        nrow = -(-H // th)
        cands.append((nrow * ncol, -(-H // nrow), tw))
    fewest = min(c[0] for c in cands)
    _, th, tw = max((c for c in cands if c[0] <= 1.03 * fewest), key=lambda c: (c[2], -c[0], -c[1]))
    return th, tw


def conv_split(blocks: int, chunks: int, sms: int) -> int:
    """Ways the bf16 kernel splits K (its ``chunks`` of CHUNK_CHANNELS inputs)
    when the output tiles give only ``blocks`` blocks for ``sms`` SMs: none
    from two blocks per SM up; below that enough for about four per SM, with
    at least 4 chunks per share. At the VoVNet shapes on 132 SMs: 1 at 80x200
    and 40x100, 3 or 4 at 20x50, 3 or 11 at 10x25."""
    if blocks >= 2 * sms:
        return 1
    return max(1, min(chunks // 4, -(-4 * sms // blocks)))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def repack_weight(weight: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """OIHW (Co, C, 3, 3) -> (Co, 3, 3, Cp) in ``dtype``, Cp = C rounded up to
    8 with zeros past C: the bf16 kernel's K order, tap-major and
    channel-minor, which is petr_tpu's ``weight.reshape(9 * C, Co)`` of the
    HWIO weight (`conv3x3.py:89`) per output channel. One copy kernel that
    also casts (two, with the zero fill, when C is not a multiple of 8)."""
    Co, C = weight.shape[:2]
    Cp = -(-C // 8) * 8
    out = torch.empty((Co, 3, 3, Cp), dtype=dtype, device=weight.device)
    if Cp != C:
        out[..., C:].zero_()
    out[..., :C].copy_(weight.permute(0, 2, 3, 1))
    return out


def _forward_cuda(x, weight, mul, add, relu):
    global LAUNCHES, LAUNCHES_FP32, SPLITK_LAUNCHES
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} and weight {tuple(weight.shape)} must be NCHW and OIHW")
    B, C, H, W = x.shape
    Co = weight.shape[0]
    if weight.shape[1:] != (C, 3, 3):
        raise ValueError(f"weight must be (Co, {C}, 3, 3), got {tuple(weight.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if weight.device != x.device:
        raise ValueError("x and weight must be on one device")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    ptrs = (None, None)
    if mul is not None:
        if mul.shape != (Co,) or add.shape != (Co,):
            raise ValueError(f"mul and add must be ({Co},), got {tuple(mul.shape)} and {tuple(add.shape)}")
        mul = mul.to(device=x.device, dtype=torch.float32).contiguous()
        add = add.to(device=x.device, dtype=torch.float32).contiguous()
        ptrs = (mul.data_ptr(), add.data_ptr())
    out = torch.empty((B, Co, H, W), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        wr = repack_weight(weight)
        th, tw = conv_tile(H, W)
        blocks = -(-H // th) * -(-W // tw) * -(-Co // TILE_CHANNELS) * B
        ksplit = conv_split(blocks, -(-C // CHUNK_CHANNELS), _sm_count(x.device))
        part = torch.empty((ksplit, B, Co, H, W), dtype=torch.float32, device=x.device) if ksplit > 1 else None
        err = lib.petr_conv3x3_bn_relu_tc_fwd(
            x.data_ptr(), wr.data_ptr(), *ptrs, out.data_ptr(), None if part is None else part.data_ptr(),
            B, C, wr.shape[3], H, W, Co, th, tw, ksplit, int(relu), stream)
        _raise_on(lib, err, "bf16")
        LAUNCHES += 1
        SPLITK_LAUNCHES += ksplit > 1
    else:
        weight = weight.to(torch.float32).contiguous()
        err = lib.petr_conv3x3_bn_relu_fp32_fwd(
            x.data_ptr(), weight.data_ptr(), *ptrs, out.data_ptr(), B, C, H, W, Co, int(relu), stream)
        _raise_on(lib, err, "fp32")
        LAUNCHES_FP32 += 1
    return out


def _raise_on(lib, err: int, variant: str) -> None:
    if err != 0:
        raise RuntimeError(f"conv3x3_bn_relu {variant} kernel launch failed: "
                           + lib.petr_cuda_error_string(err).decode())


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("conv3x3_bn_relu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.petr_conv3x3_bn_relu_fp32_fwd.argtypes = [P] * 5 + [I] * 6 + [P]
    lib.petr_conv3x3_bn_relu_fp32_fwd.restype = I
    lib.petr_conv3x3_bn_relu_tc_fwd.argtypes = [P] * 6 + [I] * 10 + [P]
    lib.petr_conv3x3_bn_relu_tc_fwd.restype = I
    lib.petr_cuda_error_string.argtypes = [I]
    lib.petr_cuda_error_string.restype = ctypes.c_char_p
    return lib
