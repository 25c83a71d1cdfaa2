"""Modulated deformable convolution v2 (DCNv2), the r50dcn backbones' op.

Counterpart of `petr_tpu/ops/dcn.py` and `petr_tpu/ops/pallas/dcn.py`
(reference: mmcv's ``ModulatedDeformConv2d`` in the r50dcn configs,
`petr_r50dcn_gridmask_p4.py:41-42`). For each output pixel and each of the
K = kh*kw taps, x is sampled bilinearly (zero outside the plane) at
``o * stride + (tap - pad) * dilation + (dy, dx)``, scaled by the sigmoid of
the tap's mask logit, and the stacked (P, K*Cin) samples are contracted
with the weight.

Layout is NCHW, as the port's convs and mmcv's: x (B, Cin, H, W), off_mask
(B, 3K, Ho, Wo) and weight (Cout, Cin, kh, kw). ``off_mask`` holds the
interleaved (dy, dx) of each tap in its first 2K channels, then the K mask
logits, taps in row-major (kh, kw) order (`dcn.py:11-14`).

One ``torch.autograd.Function`` carries it. On a CUDA tensor its forward
launches K4, a hand-written kernel of ``csrc/deform_conv.cu`` (replacing
`petr_tpu/ops/pallas/dcn.py::_dcn_pallas_raw`), chosen by x's dtype: bf16
runs the tensor-core kernel (wgmma, warp-specialised: sampler warps gather
from a channels-last copy of x, the weight is an image in petr_tpu's patch
order, tap-major, laid out once per weight version: ``weight_image``, kept
by ``weight_images.cached_image``), fp32 the CUDA-core kernel. On a CPU
tensor it runs the plain version,
``modulated_deform_conv_reference``: the XLA gather formulation
(`dcn.py:62-99`), everything in fp32 and one cast of the output to x's
dtype. The bf16 kernel rounds the modulated samples and the weight to bf16
before their products, as petr_tpu's Pallas kernel multiplies in x's dtype;
``operand_dtype=torch.bfloat16`` makes the plain version round them at the
same points (its rounding floor). JAX has no backward kernel here either:
its custom VJP differentiates the XLA formulation
(`pallas/dcn.py:200-217`). So the backward is autograd of the plain
version, recomputed under ``torch.enable_grad()``; it never calls back
into the Function, whose
forward would launch K4 again (petr_tpu's round-3 unbounded recursion,
pinned by `tests/test_pallas_dcn.py::test_pallas_backward_does_not_recurse`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from petr_tpu_torch.ops import build, weight_images
from petr_tpu_torch.ops.sampling import bilinear_sample_batched

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# K4 launches since the count was last set to 0; only the CUDA path adds.
LAUNCHES = 0  # the bf16 tensor-core kernel
LAUNCHES_FP32 = 0  # the fp32 CUDA-core kernel
# The bf16 kernel's tile (``k4::BM`` output pixels, ``k4::BN`` output
# channels) and its chunk of the reduction axis (``k4::KC`` channels of one tap)
TILE_PIXELS = 64
TILE_CHANNELS = 256
CHUNK_CHANNELS = 64
STAGES = 4  # the ring's stages, each the chunk's A (64 x 64) and B (256 x 64) tiles in bf16
THREADS = 512  # two consumer warpgroups and eight sampler warps
# its dynamic shared memory (``k4::SMEM_BYTES``): alignment slack, the ring,
# the corners and fractions of every (tap, pixel), the barriers
SMEM_BYTES = 1024 + STAGES * 2 * (TILE_PIXELS + TILE_CHANNELS) * CHUNK_CHANNELS + 9 * TILE_PIXELS * 28 + 2 * STAGES * 8


# ------------------------------------------------------------ plain version
def modulated_deform_conv_reference(
    x: torch.Tensor,  # (B, Cin, H, W)
    off_mask: torch.Tensor,  # (B, 3K, Ho, Wo)
    weight: torch.Tensor,  # (Cout, Cin, kh, kw)
    stride: int = 1,
    dilation: int = 1,
    operand_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The XLA gather formulation in fp32 -> (B, Cout, Ho, Wo) in x's dtype.

    With ``operand_dtype`` (the bf16 kernel's rounding floor: bfloat16) the
    modulated samples, summed from their corners in fp32, and the weight are
    rounded to it before the fp32 contraction."""
    B, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    K = kh * kw
    Ho, Wo = off_mask.shape[-2:]
    dev = x.device
    om = off_mask.float().permute(0, 2, 3, 1)  # (B, Ho, Wo, 3K)
    off = om[..., : 2 * K].reshape(B, Ho, Wo, K, 2)
    dy, dx = off[..., 0], off[..., 1]
    mask = torch.sigmoid(om[..., 2 * K:])  # (B, Ho, Wo, K)

    pad_h = (kh - 1) * dilation // 2
    pad_w = (kw - 1) * dilation // 2
    oy = torch.arange(Ho, dtype=torch.float32, device=dev) * stride
    ox = torch.arange(Wo, dtype=torch.float32, device=dev) * stride
    ty, tx = torch.meshgrid(
        torch.arange(kh, dtype=torch.float32, device=dev) * dilation - pad_h,
        torch.arange(kw, dtype=torch.float32, device=dev) * dilation - pad_w,
        indexing="ij",
    )
    sy = oy[None, :, None, None] + ty.reshape(K)[None, None, None, :] + dy  # (B, Ho, Wo, K)
    sx = ox[None, None, :, None] + tx.reshape(K)[None, None, None, :] + dx
    xy = torch.stack([sx, sy], dim=-1)  # (B, Ho, Wo, K, 2)

    feat = x.float().permute(0, 2, 3, 1)  # (B, H, W, Cin)
    samples = bilinear_sample_batched(feat, xy) * mask[..., None]  # (B, Ho, Wo, K, Cin)
    w = weight.float().reshape(Cout, Cin, K)
    if operand_dtype is not None:
        samples = samples.to(operand_dtype).float()
        w = w.to(operand_dtype).float()
    out = torch.einsum("bhwkc,ock->bohw", samples, w)
    return out.to(x.dtype)


# ------------------------------------------------------------ the op (K4)
@torch.library.custom_op("petr_tpu_torch::modulated_deform_conv_fwd", mutates_args=())
def modulated_deform_conv_fwd_op(x: torch.Tensor, off_mask: torch.Tensor, weight: torch.Tensor, stride: int,
                                 dilation: int) -> torch.Tensor:
    """The forward as a ``torch.library`` op, so that ``torch.export`` keeps
    it whole: K4 on CUDA tensors, the plain version on any other device."""
    return modulated_deform_conv_reference(x, off_mask, weight, stride, dilation)


@modulated_deform_conv_fwd_op.register_kernel("cuda")
def _modulated_deform_conv_fwd_cuda(x, off_mask, weight, stride, dilation):
    return _forward_cuda(x, off_mask, weight, stride, dilation)


@modulated_deform_conv_fwd_op.register_fake
def _modulated_deform_conv_fwd_fake(x, off_mask, weight, stride, dilation):
    return x.new_empty((x.shape[0], weight.shape[0], *off_mask.shape[-2:]))


def forward_flops(x_shape, off_mask_shape, weight_shape) -> int:
    """The plain version's contraction of the (B Ho Wo, K Cin) samples with
    the weight: 2 B Ho Wo Cout Cin kh kw (the bilinear sampling is
    elementwise and not counted, as ``torch.utils.flop_counter`` counts it)."""
    B, Ho, Wo = x_shape[0], *off_mask_shape[-2:]
    Cout, Cin, kh, kw = weight_shape
    return 2 * B * Ho * Wo * Cout * Cin * kh * kw


@register_flop_formula(torch.ops.petr_tpu_torch.modulated_deform_conv_fwd)
def _modulated_deform_conv_fwd_flops(x_shape, off_mask_shape, weight_shape, *args, out_shape=None, **kwargs) -> int:
    return forward_flops(x_shape, off_mask_shape, weight_shape)


# --------------------------------------------------------------- autograd
class _ModulatedDeformConv(torch.autograd.Function):
    """(x, off_mask, weight) -> out. Forward: K4 on CUDA, the plain version
    on the CPU or when ``plain``. Backward: autograd of the plain version."""

    @staticmethod
    def forward(ctx, x, off_mask, weight, stride, dilation, plain):
        if plain:
            out = modulated_deform_conv_reference(x, off_mask, weight, stride, dilation)
        else:
            out = modulated_deform_conv_fwd_op(x, off_mask, weight, stride, dilation)
        ctx.save_for_backward(x, off_mask, weight)
        ctx.conv = (stride, dilation)
        return out

    @staticmethod
    def backward(ctx, gout):
        x, off_mask, weight = ctx.saved_tensors
        stride, dilation = ctx.conv
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((x, off_mask, weight), ctx.needs_input_grad[:3])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = modulated_deform_conv_reference(*inputs, stride, dilation)
            grads = iter(torch.autograd.grad(out, wanted, gout))
        dx, doff, dw = (next(grads) if t.requires_grad else None for t in inputs)
        return dx, doff, dw, None, None, None


def _check_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"modulated_deform_conv runs on cpu or cuda, not {x.device}")


def modulated_deform_conv(
    x: torch.Tensor,  # (B, Cin, H, W)
    off_mask: torch.Tensor,  # (B, 3K, Ho, Wo)
    weight: torch.Tensor,  # (Cout, Cin, kh, kw)
    stride: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """DCNv2 -> (B, Cout, Ho, Wo) in x's dtype; differentiable in all three
    inputs. K4 on CUDA tensors, the plain version on CPU tensors."""
    _check_device(x)
    return _ModulatedDeformConv.apply(x, off_mask, weight, stride, dilation, False)


def modulated_deform_conv_plain(
    x: torch.Tensor,
    off_mask: torch.Tensor,
    weight: torch.Tensor,
    stride: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """The same Function on the plain version, on any device: the yardstick
    ``chip_smoke.py`` holds K4's forward and train step to."""
    return _ModulatedDeformConv.apply(x, off_mask, weight, stride, dilation, True)


# ------------------------------------------------------------ CUDA launch
def _check_inputs(x, off_mask, weight, stride, dilation):
    if x.dim() != 4 or off_mask.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)}, off_mask {tuple(off_mask.shape)} and weight "
                         f"{tuple(weight.shape)} must be 4-d (NCHW, NCHW, OIHW)")
    B, Cin, H, W = x.shape
    Cout, wc, kh, kw = weight.shape
    if (kh, kw) != (3, 3) or wc != Cin:
        raise ValueError(f"the kernel takes a 3x3 weight over {Cin} input channels, got {tuple(weight.shape)}")
    if stride < 1 or dilation < 1:
        raise ValueError(f"stride {stride} and dilation {dilation} must be >= 1")
    # the output grid is off_mask's, as in the plain version
    Ho, Wo = off_mask.shape[-2:]
    if off_mask.shape[:2] != (B, 27):
        raise ValueError(f"off_mask must be (B, 27, Ho, Wo) with B = {B}, got {tuple(off_mask.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not (x.device == off_mask.device == weight.device):
        raise ValueError("x, off_mask and weight must be on one device")
    return B, Cin, H, W, Cout, Ho, Wo


def channels_last(x: torch.Tensor, Cp: int) -> torch.Tensor:
    """NCHW (B, C, H, W) -> (B, H, W, Cp), zeros past C: the layout in which
    the bf16 kernel reads a corner's 8 channels as one 16-byte load. The
    plain version of the copy the bf16 call makes first
    (``deform_conv_channels_last_kernel``, in the same launch)."""
    B, C, H, W = x.shape
    out = torch.empty((B, H, W, Cp), dtype=x.dtype, device=x.device)
    if Cp != C:
        out[..., C:].zero_()
    out[..., :C].copy_(x.permute(0, 2, 3, 1))
    return out


def padded_channels(Cin: int) -> int:
    """Cp: Cin rounded up to 8, the channels-last copy's row."""
    return -(-Cin // 8) * 8


def weight_image(weight: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> the bf16 kernel's weight image (tiles, 9 nct,
    8, 256, 8) in ``dtype`` (the kernel's: bf16; the CPU tests also take
    float32), nct = ceil(Cp / 64) chunks a tap: tile t, chunk ch (tap
    ch // nct, channels 64 (ch % nct) ..) holds output channels 256 t .. 256 t
    + 255 (zeros past Cout and past Cin) as eight 8-channel groups, groups
    256 x 16 bytes apart: the no-swizzle K-major tiles the wgmma reads, a
    chunk one bulk copy. Along K it is petr_tpu's patch order j = tap * Cin +
    c (its ``weight`` (kh, kw, Cin, Cout) reshaped to (9 Cin, Cout))."""
    Cout, Cin = weight.shape[:2]
    nct = -(-padded_channels(Cin) // CHUNK_CHANNELS)
    tiles = -(-Cout // TILE_CHANNELS)
    w = weight.to(dtype).permute(0, 2, 3, 1).reshape(Cout, 9, Cin)
    w = F.pad(w, (0, nct * CHUNK_CHANNELS - Cin, 0, 0, 0, tiles * TILE_CHANNELS - Cout))
    w = w.reshape(tiles, TILE_CHANNELS, 9, nct, CHUNK_CHANNELS // 8, 8).permute(0, 2, 3, 4, 1, 5)
    return w.reshape(tiles, 9 * nct, CHUNK_CHANNELS // 8, TILE_CHANNELS, 8).contiguous()


def unweight_image(image: torch.Tensor, Cout: int, Cin: int) -> torch.Tensor:
    """``weight_image``'s inverse, to OIHW (Cout, Cin, 3, 3)."""
    tiles, chunks, groups, bn, _ = image.shape
    nct = chunks // 9
    w = image.reshape(tiles, 9, nct, groups, bn, 8).permute(0, 4, 1, 2, 3, 5).reshape(tiles * bn, 9, nct * groups * 8)
    return w[:Cout, :, :Cin].reshape(Cout, 3, 3, Cin).permute(0, 3, 1, 2)


def _forward_cuda(x, off_mask, weight, stride, dilation):
    """K4 on CUDA tensors: the tensor-core kernel for bf16 x, the CUDA-core
    one for fp32."""
    global LAUNCHES, LAUNCHES_FP32
    B, Cin, H, W, Cout, Ho, Wo = _check_inputs(x, off_mask, weight, stride, dilation)
    out = torch.empty((B, Cout, Ho, Wo), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        Cp = padded_channels(Cin)
        x = x.contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
        xs = torch.empty((B, H, W, Cp), dtype=x.dtype, device=x.device)  # the kernels' channels-last copy of x
        wimg = weight_images.cached_image(weight, "deform_conv", weight_image)
        # the offsets and logits in the model's dtype (the kernel reads bf16 or fp32 exactly)
        om = off_mask.contiguous() if off_mask.dtype in (torch.bfloat16, torch.float32) else off_mask.float()
        err = lib.petr_deform_conv_tc_fwd(
            x.data_ptr(), xs.data_ptr(), om.data_ptr(), int(om.dtype == torch.bfloat16), wimg.data_ptr(),
            out.data_ptr(), B, Cin, Cp, H, W, Cout, Ho, Wo, stride, dilation, stream)
        build.check(lib, err, "deform_conv bf16")
        LAUNCHES += 1
    else:
        x = x.contiguous()
        off_mask = off_mask.to(torch.float32).contiguous()
        weight = weight.to(torch.float32).contiguous()
        err = lib.petr_deform_conv_fp32_fwd(
            x.data_ptr(), off_mask.data_ptr(), weight.data_ptr(), out.data_ptr(),
            B, Cin, H, W, Cout, Ho, Wo, stride, dilation, stream)
        build.check(lib, err, "deform_conv fp32")
        LAUNCHES_FP32 += 1
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    return build.library("deform_conv", {
        "petr_deform_conv_fp32_fwd": [P, P, P, P] + [I] * 9 + [P],
        "petr_deform_conv_tc_fwd": [P, P, P, I, P, P] + [I] * 10 + [P],
    })
