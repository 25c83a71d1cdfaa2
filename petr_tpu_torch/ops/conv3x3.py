"""Fused 3x3 convolution + folded frozen BN + ReLU (K5), ConvBNReLU's opt-in route.

Counterpart of `petr_tpu/ops/pallas/conv3x3.py`: out = act(conv3x3(x, w) *
mul + add), stride 1 and padding 1, the conv summed in fp32, the epilogue in
fp32 and one rounding to x's dtype. Layout NCHW: x (B, C, H, W), weight
(Co, C, 3, 3) taken in x's dtype (cast if it is not), ``mul``/``add`` (Co,)
fp32 (the folded BN) or None for a plain conv.

One ``torch.autograd.Function`` carries it. On a CUDA tensor its forward
launches K5, a hand-written kernel of ``csrc/conv3x3_bn_relu.cu``
(replacing `petr_tpu/ops/pallas/conv3x3.py::_conv3x3_raw`), chosen by x's
dtype: bf16 runs the tensor-core pair (a layout pass of x into the
8-channel planes of a zero-padded "flat" grid, then an implicit GEMM on
wgmma fed by bulk copies, K6's plan in bf16: ``conv_plan``), fp32 the
CUDA-core kernel, which keeps fp32 callers in fp32. The bf16 kernel reads
its weight as an image laid out once per weight version (``weight_image``,
kept by ``weight_images.cached_image``). On a CPU tensor it runs the plain
version, ``conv3x3_bn_relu_reference``, which is `_xla_reference`
(`conv3x3.py:113-123`). The backward is autograd of the plain version, as
JAX's `_bwd` (`conv3x3.py:140-143`) is the VJP of `_xla_reference`.

The default route of ``ConvBNReLU`` stays cuDNN, as petr_tpu's stays XLA;
``PETR_TPU_TORCH_CONV_IMPL=cuda`` opts into K5 (``conv_impl``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from petr_tpu_torch.ops import build, conv_int8, weight_images

CONV_IMPL_ENV = "PETR_TPU_TORCH_CONV_IMPL"
CONV_IMPLS = ("cudnn", "cuda")

# K5 launches since the count was last set to 0; only the CUDA path adds.
LAUNCHES = 0  # the bf16 tensor-core kernel (the conv)
LAYOUT_LAUNCHES = 0  # its layout pass, one per bf16 conv
SPLITK_LAUNCHES = 0  # of LAUNCHES, those whose plan splits K (the last split adds the partials, in the same launch)
LAUNCHES_FP32 = 0  # the fp32 CUDA-core kernel
CHANNEL_STEP = 16  # a K slice's input channels (one wgmma k16): C is padded to a multiple of it
TILE_M = 128  # output pixels of the flat grid per tile (two consumer warpgroups of 64 rows)
LAYOUT_PIXELS = 256  # the layout pass's pixels per block (x 16 channels)
THREADS = 288  # a conv block: two consumer warpgroups and the producer warp
SMEM_LIMIT = 232448  # shared memory a block may use on the H100 (227 KB)


def smem_bytes(bn: int) -> int:
    """The conv kernel's dynamic shared memory at tile width bn (its
    ``smem_bytes<BN>``): alignment slack, the ring (K6's ``RING_BYTES``), the
    tile's mul and add, the pixel map, flags and barriers."""
    return 1024 + conv_int8.RING_BYTES[bn] + 2 * bn * 4 + TILE_M * 4 + 16 + 2 * conv_int8.MAX_STAGES * 8


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


# ------------------------------------------------------------- the plan
@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """The bf16 kernel's plan for one shape (``conv_plan``): the flat padded
    grid (output pixel (b, oh, ow) is row b QV + oh Wp + ow, Wp = W + 1; input
    pixel (b, ih, iw) row Wp + 1 + b QV + ih Wp + iw of each 8-channel plane of
    ``rows_alloc`` rows), K6's tiling of it in bf16 (tiles of 128 rows by
    ``bn`` channels, ``splits`` of ``per_split`` K slices, ``stages`` ring
    stages of ``group`` slices), and the layout pass's blocks. The fields up to
    ``pads`` are the kernel's ``Plan`` struct in order (then affine, relu)."""

    B: int
    C: int
    Cp: int  # C rounded up to CHANNEL_STEP
    H: int
    W: int
    Co: int
    chunks: int  # Cp / 16
    slices: int  # 9 chunks: K slice s is chunk s // 9, tap s % 9
    tiles_m: int
    tiles_n: int
    splits: int
    per_split: int
    Wp: int
    QV: int
    rows_alloc: int
    group: int  # K slices a ring stage: 9 (a chunk's taps) or 3 (one kernel row's)
    halo: int  # rows of a plane a stage copies
    stages: int
    stage_bytes: int
    p_blocks: int  # the layout pass: blocks of LAYOUT_PIXELS pixels a view
    data_blocks: int
    pads: int  # zero pixels of the grid
    bn: int

    def kernel_args(self, affine: bool, relu: bool) -> List[int]:
        """The kernel's ``Plan`` struct, 24 ints."""
        names = [f.name for f in dataclasses.fields(self)][:-1]
        return [getattr(self, n) for n in names] + [int(affine), int(relu)]

    @functools.cached_property
    def _c_args(self) -> Dict[Tuple[bool, bool], ctypes.Array]:
        return {}

    def c_kernel_args(self, affine: bool, relu: bool) -> ctypes.Array:
        """``kernel_args`` as a ctypes array, made once per plan and epilogue."""
        args = self._c_args.get((affine, relu))
        if args is None:
            args = self._c_args[(affine, relu)] = (ctypes.c_int * 24)(*self.kernel_args(affine, relu))
        return args

    @property
    def q_rows(self) -> int:
        """Rows of the grid the layout pass writes (the rest are read only
        by the last tile's junk rows)."""
        return (1 + self.B * (self.H + 1)) * self.Wp + 1

    @property
    def planes_numel(self) -> int:
        """bf16 elements of the layout pass's planes."""
        return self.Cp * self.rows_alloc

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n * self.splits

    @property
    def workspace_floats(self) -> int:
        """fp32 partial sums of a split plan (0 unsplit)."""
        return self.tiles_m * self.tiles_n * self.splits * TILE_M * self.bn if self.splits > 1 else 0


@functools.lru_cache(maxsize=None)
def conv_plan(B: int, C: int, H: int, W: int, Co: int, bn: Optional[int] = None) -> ConvPlan:
    """The bf16 kernel's plan for x (B, C, H, W) and a (Co, C, 3, 3) weight;
    ``bn`` fixes the tile width, else K6's time model picks it and the split
    (``conv_int8.choose_tiling``: a k16 slice of bf16 is 32 bytes a row and
    128 bn clocks of the tensor cores, as K6's k32 slice of int8 is)."""
    if min(B, C, H, W, Co) <= 0 or (bn is not None and bn not in conv_int8.TILE_N_CHOICES):
        raise ValueError(f"no plan for {(B, C, H, W, Co, bn)}")
    Cp = -(-C // CHANNEL_STEP) * CHANNEL_STEP
    chunks = Cp // CHANNEL_STEP
    slices = 9 * chunks
    Wp = W + 1
    QV = (H + 1) * Wp
    tiles_m = -(-(B * (H + 1) - 1) * Wp // TILE_M)
    q_rows = (1 + B * (H + 1)) * Wp + 1
    rows_alloc = max(q_rows, tiles_m * TILE_M + 2 * Wp + 2)
    bn, splits, per_split, (group, halo, stages, stage_bytes) = conv_int8.choose_tiling(
        tiles_m, Co, slices, conv_int8.FLAT, 3, Wp, bn)
    p_blocks = -(-H * W // LAYOUT_PIXELS)
    pads = (B + 1) * Wp + B * H + 1
    return ConvPlan(B, C, Cp, H, W, Co, chunks, slices, tiles_m, -(-Co // bn), splits, per_split, Wp, QV, rows_alloc,
                    group, halo, stages, stage_bytes, p_blocks, B * p_blocks * chunks, pads, bn)


def layout_reference(x: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """The layout pass's plain version: x (B, C, H, W) -> the planes
    (Cp / 8, rows_alloc, 8) in x's dtype, zero outside the image and past C
    (the rows past the grid, which the kernel leaves unwritten, zero too)."""
    B, C, H, W, Wp = plan.B, plan.C, plan.H, plan.W, plan.Wp
    grid = x.new_zeros((plan.rows_alloc, plan.Cp))
    rows = (Wp + 1 + torch.arange(B, device=x.device)[:, None, None] * plan.QV
            + torch.arange(H, device=x.device)[None, :, None] * Wp + torch.arange(W, device=x.device)).reshape(-1)
    grid[rows, :C] = x.permute(0, 2, 3, 1).reshape(-1, C)
    return grid.view(plan.rows_alloc, plan.Cp // 8, 8).transpose(0, 1).contiguous()


def unpack_planes(planes: torch.Tensor, plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layout pass's planes -> (x (B, C, H, W), every other element of the
    grid's ``q_rows`` rows, flattened): what the checks hold to x and to zero."""
    grid = planes.reshape(plan.Cp // 8, plan.rows_alloc, 8).transpose(0, 1).reshape(plan.rows_alloc, plan.Cp)
    grid = grid[:plan.q_rows]
    dev = planes.device
    rows = (plan.Wp + 1 + torch.arange(plan.B, device=dev)[:, None, None] * plan.QV
            + torch.arange(plan.H, device=dev)[None, :, None] * plan.Wp + torch.arange(plan.W, device=dev)).reshape(-1)
    pad = torch.ones(plan.q_rows, dtype=torch.bool, device=dev)
    pad[rows] = False
    data = grid[rows]
    x = data[:, :plan.C].reshape(plan.B, plan.H, plan.W, plan.C).permute(0, 3, 1, 2)
    return x, torch.cat([grid[pad].reshape(-1), data[:, plan.C:].reshape(-1)])


def weight_image(weight: torch.Tensor, bn: int, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """OIHW (Co, C, 3, 3) -> the bf16 kernel's weight image (tiles_n, slices,
    2, bn, 8) in ``dtype`` (the kernel's: bf16; the CPU tests' walk takes
    float64): tile t, K slice s (chunk s // 9 of 16 input channels, tap
    s % 9 = 3 kh + kw) holds output channels t bn .. t bn + bn - 1 (zeros past
    Co and past C), each as two 16-byte halves of the slice's 16 channels,
    halves bn x 16 bytes apart: the no-swizzle K-major tiles the wgmma reads,
    a stage's slices one bulk copy. Along K within a chunk it is petr_tpu's
    ``weight.reshape(9 * C, Co)`` order of the HWIO weight, tap-major."""
    Co, C = weight.shape[:2]
    Cp = -(-C // CHANNEL_STEP) * CHANNEL_STEP
    tiles = -(-Co // bn)
    w = weight.to(dtype).permute(0, 2, 3, 1).reshape(Co, 9, C)
    w = F.pad(w, (0, Cp - C, 0, 0, 0, tiles * bn - Co))  # (tiles bn, 9, Cp)
    w = w.reshape(tiles, bn, 9, Cp // CHANNEL_STEP, 2, 8).permute(0, 3, 2, 4, 1, 5)
    return w.reshape(tiles, 9 * (Cp // CHANNEL_STEP), 2, bn, 8).contiguous()


def unweight_image(image: torch.Tensor, Co: int, C: int) -> torch.Tensor:
    """``weight_image``'s inverse, to OIHW (Co, C, 3, 3)."""
    tiles, slices, _, bn, _ = image.shape
    chunks = slices // 9
    w = image.reshape(tiles, chunks, 9, 2, bn, 8).permute(0, 4, 2, 1, 3, 5).reshape(tiles * bn, 9, chunks * 16)
    return w[:Co, :, :C].reshape(Co, 3, 3, C).permute(0, 3, 1, 2)


# ----------------------------------------------------------- CUDA launch
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """A split plan's fp32 partial sums and per-tile counters, one pair per
    device and stream; the counters are zero when allocated and the kernel
    leaves them zero."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    ws, counters = _workspaces.get(key, (None, None))
    tiles = plan.tiles_m * plan.tiles_n
    if ws is None or ws.numel() < plan.workspace_floats or counters.numel() < tiles:
        n_ws = max(plan.workspace_floats, 0 if ws is None else ws.numel())
        n_c = max(tiles, 0 if counters is None else counters.numel())
        ws = torch.empty(n_ws, dtype=torch.float32, device=device)
        counters = torch.zeros(n_c, dtype=torch.int32, device=device)
        _workspaces[key] = (ws, counters)
    return ws, counters


def layout_planes(x: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """The bf16 kernel's layout pass alone on a CUDA tensor (its check):
    x (B, C, H, W) bf16 -> the planes (Cp / 8, rows_alloc, 8), rows past the
    grid unwritten."""
    global LAYOUT_LAUNCHES
    x = _aligned(x)
    lib = _library()
    planes = torch.empty((plan.Cp // 8, plan.rows_alloc, 8), dtype=torch.bfloat16, device=x.device)
    err = lib.petr_conv3x3_layout(x.data_ptr(), planes.data_ptr(), plan.c_kernel_args(False, False),
                                  torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "conv3x3_bn_relu layout")
    LAYOUT_LAUNCHES += 1
    return planes


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _forward_cuda(x, weight, mul, add, relu):
    global LAUNCHES, LAUNCHES_FP32, LAYOUT_LAUNCHES, SPLITK_LAUNCHES
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
    x = _aligned(x)
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
        plan = conv_plan(B, C, H, W, Co)
        wt = weight_images.cached_image(weight, ("conv3x3", plan.bn), lambda w: weight_image(w, plan.bn))
        planes = torch.empty(plan.planes_numel, dtype=torch.bfloat16, device=x.device)
        ws, counters = _workspace(x.device, stream, plan) if plan.splits > 1 else (None, None)
        err = lib.petr_conv3x3_bn_relu_tc_fwd(
            x.data_ptr(), planes.data_ptr(), wt.data_ptr(), *ptrs, out.data_ptr(),
            plan.c_kernel_args(mul is not None, relu), plan.bn, None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), stream)
        build.check(lib, err, "conv3x3_bn_relu bf16")
        LAYOUT_LAUNCHES += 1
        LAUNCHES += 1
        SPLITK_LAUNCHES += plan.splits > 1
    else:
        weight = weight.to(torch.float32).contiguous()
        err = lib.petr_conv3x3_bn_relu_fp32_fwd(
            x.data_ptr(), weight.data_ptr(), *ptrs, out.data_ptr(), B, C, H, W, Co, int(relu), stream)
        build.check(lib, err, "conv3x3_bn_relu fp32")
        LAUNCHES_FP32 += 1
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    return build.library("conv3x3_bn_relu", {
        "petr_conv3x3_bn_relu_fp32_fwd": [P] * 5 + [I] * 6 + [P],
        "petr_conv3x3_layout": [P, P, P, P],
        "petr_conv3x3_bn_relu_tc_fwd": [P] * 7 + [I] + [P] * 3,
    })
