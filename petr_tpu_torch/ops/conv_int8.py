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

The weight side (``prepare_operands``: the BN folded in, quantised, packed
to the kernel's K order (Co, k, k, Cp); ``tile_weight`` then lays it out for
a plan's tile width) is plain PyTorch, run once per weight: by the model
(``models.layers.QuantConv2d.int8_operands``) and by an artifact's replay
(``petr_tpu_torch.runtime``), never per call. The rest is one
op, ``torch.ops.petr_tpu_torch.conv_int8_bn_act`` (a ``torch.library``
custom op, so ``torch.export`` keeps it whole), on the packed weight: on a
CUDA tensor it launches the two kernels of ``csrc/conv_int8.cu``, the
activation quantisation into the channels-last int8 rows the conv reads
and the conv on the int8 tensor cores (wgmma on TMA-fed tiles) with the
epilogue; on a CPU tensor it runs the plain version,
``conv_int8_bn_act_reference``, which convolves the int8 operands upcast to
float64 with ``F.conv2d``: exact, since |acc| <= 9 * 2144 * 127^2 < 2^53.
PyTorch has no CUDA call for an int8 conv into int32 sums, and on the CPU
``F.conv2d`` of int8 tensors returns int8, which wraps.

``conv_plan`` makes the kernel's plan for a shape: the tiling (128 output
pixels by ``bn`` output channels), the split of K where the tiles alone do
not fill the card's SMs, and (``tensor_map_args``) the TMA boxes over the
int8 activation and the packed weight. The CPU tests hold it; the kernel
checks its ranges and trusts its arithmetic.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from petr_tpu_torch.ops import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
CHANNEL_STEP = 32  # the kernel's K slice: input channels are padded to a multiple of it

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


def padded_channels(C: int) -> int:
    """Cp: C rounded up to the kernel's K slice."""
    return -(-C // CHANNEL_STEP) * CHANNEL_STEP


def pack_weight(wi: torch.Tensor, Cp: int) -> torch.Tensor:
    """int8 OIHW (Co, C, k, k) -> (Co, k, k, Cp), zeros past C: the kernel's K
    order, tap-major and channel-minor (K slice s is tap s // (Cp / 32),
    channels 32 (s % (Cp / 32)) ..)."""
    return F.pad(wi.permute(0, 2, 3, 1), (0, Cp - wi.shape[1])).contiguous()


def unpack_weight(wq: torch.Tensor, C: int) -> torch.Tensor:
    """``pack_weight``'s inverse: (Co, k, k, Cp) -> OIHW (Co, C, k, k)."""
    return wq[..., :C].permute(0, 3, 1, 2)


def tile_weight(wq: torch.Tensor, bn: int) -> torch.Tensor:
    """(Co, k, k, Cp) -> the kernel's weight tiles (tiles_n, slices, 2, bn, 16):
    the kernel's K slice s is chunk s // (k k) (32 channels), tap s % (k k);
    tile t, slice s holds output channels t bn .. t bn + bn - 1 (zeros past
    Co), each as two 16-byte halves of the slice's 32 bytes, halves apart
    (the no-swizzle K-major layout the wgmma reads; a stage's slices are one
    bulk copy)."""
    Co, k, _, Cp = wq.shape
    tiles = -(-Co // bn)
    by_chunk = wq.reshape(Co, k * k, Cp // CHANNEL_STEP, CHANNEL_STEP).transpose(1, 2).reshape(Co, -1)
    flat = F.pad(by_chunk, (0, 0, 0, tiles * bn - Co))  # (tiles bn, slices 32)
    return flat.reshape(tiles, bn, -1, 2, 16).permute(0, 2, 3, 1, 4).contiguous()


def untile_weight(wt: torch.Tensor, Co: int, C: int) -> torch.Tensor:
    """``tile_weight``'s inverse, to OIHW (Co, C, k, k)."""
    tiles, slices, _, bn, _ = wt.shape
    Cp = padded_channels(C)
    k = round((slices * CHANNEL_STEP // Cp) ** 0.5)
    by_chunk = wt.permute(0, 3, 1, 2, 4).reshape(tiles * bn, Cp // CHANNEL_STEP, k * k, CHANNEL_STEP)[:Co]
    wq = by_chunk.transpose(1, 2).reshape(Co, k, k, Cp)
    return unpack_weight(wq, C)


def prepare_weight(weight: torch.Tensor, mul: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wq packed (Co, k, k, Cp) int8, sw (Co,) fp32) of the OIHW ``weight``
    with the BN scale ``mul`` folded in."""
    wi, sw = quantize_weight(weight, mul)
    return pack_weight(wi, padded_channels(wi.shape[1])), sw


def fold_bn(weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
            eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """A frozen BN as (mul, add): y = x mul + add (``FrozenBatchNorm``'s)."""
    mul = weight * torch.rsqrt(running_var + eps)
    return mul, bias - running_mean * mul


def prepare_operands(weight: torch.Tensor, mul: torch.Tensor, add: torch.Tensor, amax: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's operands but for the tiles, once per weight: the fp32 OIHW
    ``weight``, the folded BN ``mul``/``add`` (Co,) and the calibrated
    ``amax`` () -> (wq packed int8, sa, scale = sa * sw, add fp32);
    ``tile_weight(wq, plan.bn)`` gives the op's ``wt``."""
    wq, sw = prepare_weight(weight, mul)
    sa = act_scale(amax)
    return wq, sa, sa * sw, add.float()


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
def _out_shape(x: torch.Tensor, wt: torch.Tensor, Co: int, stride: int) -> Tuple[int, int, int, int]:
    B, C, H, W = x.shape
    k = round((wt.shape[1] * CHANNEL_STEP // padded_channels(C)) ** 0.5)
    return B, Co, (H + 2 * (k // 2) - k) // stride + 1, (W + 2 * (k // 2) - k) // stride + 1


@torch.library.custom_op("petr_tpu_torch::conv_int8_bn_act", mutates_args=())
def conv_int8_bn_act_op(x: torch.Tensor, wt: torch.Tensor, sa: torch.Tensor, scale: torch.Tensor,
                        add: torch.Tensor, stride: int, relu: bool) -> torch.Tensor:
    """x (B, C, H, W) bf16/fp32, wt the weight tiles (``tile_weight``: tiles,
    k k Cp / 32, 2, bn, 16) int8, sa () fp32, scale and add (Co,) fp32 ->
    (B, Co, Ho, Wo) in x's dtype. Any device but CUDA: the plain version."""
    return conv_int8_bn_act_reference(x, untile_weight(wt, scale.shape[0], x.shape[1]), sa, scale, add, stride,
                                      relu)


@conv_int8_bn_act_op.register_kernel("cuda")
def _conv_int8_bn_act_cuda(x, wt, sa, scale, add, stride, relu):
    return _forward_cuda(x, wt, sa, scale, add, stride, relu, x.dtype)


@conv_int8_bn_act_op.register_fake
def _conv_int8_bn_act_fake(x, wt, sa, scale, add, stride, relu):
    return x.new_empty(_out_shape(x, wt, scale.shape[0], stride))


@register_flop_formula(torch.ops.petr_tpu_torch.conv_int8_bn_act, get_raw=True)
def _conv_int8_bn_act_flops(x, wt, sa, scale, add, stride, relu, out_val=None, **kwargs) -> int:
    """The plain version's conv of the unpadded channels, 2 B Ho Wo Co C k k
    (the quantisation and the epilogue are elementwise)."""
    B, Co, Ho, Wo = _out_shape(x, wt, scale.shape[0], stride)
    k = round((wt.shape[1] * CHANNEL_STEP // padded_channels(x.shape[1])) ** 0.5)
    return 2 * B * Ho * Wo * Co * x.shape[1] * k * k


def _check_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_int8_bn_act runs on cpu or cuda, not {x.device}")


def conv_int8_bn_act_tiled(x: torch.Tensor, wt: torch.Tensor, sa: torch.Tensor, scale: torch.Tensor,
                           add: torch.Tensor, stride: int = 1, relu: bool = True) -> torch.Tensor:
    """The op on operands prepared once (``prepare_operands``, ``tile_weight``):
    K6 on CUDA tensors, the plain version on CPU tensors."""
    _check_device(x)
    return conv_int8_bn_act_op(x, wt, sa, scale, add, stride, relu)


def conv_int8_bn_act_tiled_plain(x, wt, sa, scale, add, stride: int = 1, relu: bool = True) -> torch.Tensor:
    """``conv_int8_bn_act_tiled`` on the plain version, on any device."""
    wi = untile_weight(wt, scale.shape[0], x.shape[1])
    return conv_int8_bn_act_reference(x, wi, sa, scale, add, stride, relu)


def conv_int8_bn_act_plain(x, weight, mul, add, amax, stride: int = 1, relu: bool = True) -> torch.Tensor:
    """petr_tpu's int8 ConvBNReLU forward from the fp32 OIHW weight, the
    folded BN ``mul``/``add`` and ``amax``, on the plain version, on any
    device: the yardstick ``chip_smoke.py`` holds K6 to."""
    wi, sw = quantize_weight(weight, mul)
    sa = act_scale(amax)
    return conv_int8_bn_act_reference(x, wi, sa, sa * sw, add.float(), stride, relu)


# --------------------------------------------------------------- the plan
SM_COUNT = 132  # the H100 SXM's SMs
TILE_M = 128  # output pixels per tile (the kernel's two consumer warpgroups of 64 rows)
TILE_N_CHOICES = (64, 128, 160, 192, 256)  # the kernel's instantiations (wgmma n)
# blocks an SM holds at each tile width: a consumer thread holds bn / 2 int32
# sums (ptxas: 72 to 154 registers for 288 threads, no spills), and a block
# RING_BYTES of shared memory for its ring of stages (and the epilogue's tile)
RESIDENT = {64: 2, 128: 2, 160: 1, 192: 1, 256: 1}
RING_BYTES = {bn: (104 if bn <= 128 else 200) * 1024 for bn in TILE_N_CHOICES}
MAX_STAGES = 4
MAX_SPLITS = 16
MIN_SLICES_PER_SPLIT = 4
MAX_PADDED_N = 0.25  # a tile width may pad Co by at most this share
# The plan's time model, in SM clocks: a k32 slice costs bn (the tensor
# cores: 128 x bn x 32 products at 4,096 a clock) plus SLICE_CLOCKS of
# bookkeeping; a wave of resident blocks FILL_CLOCKS (the ring's first loads,
# the epilogue); a split block REDUCE_CLOCKS_PER_N x bn (its 128 x bn int32
# partial sums reduced in L2). Blocks beyond SM_COUNT share an SM's tensor
# cores, so they add their slices, and beyond SM_COUNT x RESIDENT a wave.
SLICE_CLOCKS = 32
FILL_CLOCKS = 1500
REDUCE_CLOCKS_PER_N = 64
FLAT, RECT = 0, 1  # the A operand: rows of the flat (padded) layout by bulk copies, or a strided 4-D TMA box
QUANT_PIXELS = 256  # the quantisation pass's pixels per block (x 32 channels)


def ring(mode: int, k: int, Wp: int, bn: int) -> Optional[Tuple[int, int, int, int]]:
    """A block's pipeline at tile width bn -> (group: K slices a stage, halo:
    rows of a plane a flat 3x3 stage copies (0 otherwise), stages,
    stage_bytes), or None if two stages do not fit. A flat 3x3 stage takes a
    32-channel chunk's 9 taps from one copy of each of its two planes, rows
    q0 .. q0 + 2 (W + 1) + 129 (the taps are row shifts of it), or where two
    such stages do not fit one kernel row's 3 taps (130 rows); a 1x1 or rect
    stage 4 slices of 4 KB."""
    if mode == FLAT and k == 3:
        options = [(9, 128 + 2 * Wp + 2), (3, 130)]
    else:
        options = [(4, 0)]
    for group, halo in options:
        a = 2 * (-(-halo // 8) * 8) * 16 if halo else group * TILE_M * CHANNEL_STEP
        stage = -(-(a + group * bn * CHANNEL_STEP) // 1024) * 1024
        stages = min(MAX_STAGES, RING_BYTES[bn] // stage)
        if stages >= 2:
            return group, halo, stages, stage
    return None


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """K6's plan for one conv shape (``conv_plan``). The first 23 fields after
    ``mode`` are the kernel's ``Plan`` struct in order (then rows_alloc,
    out_kind, relu); ``bn`` picks the kernel; the ``q_*`` fields are the
    layout the quantisation pass writes: pixel (b, ih, iw) at row ``q_row0 +
    b q_vstride + ih q_wp + iw`` of ``q_rows`` rows (``pads`` of them zero),
    each row's 16-byte channel group j at 16 (j ``plane_stride`` + row
    ``row_stride``) bytes: 16-channel planes of ``rows_alloc`` rows for the
    flat mode, channels-last rows for the rect mode."""

    mode: int
    B: int
    Cp: int
    H: int
    W: int
    Co: int
    k: int
    stride: int
    pad: int
    Ho: int
    Wo: int
    chunks: int  # Cp / 32: K slices per tap
    slices: int  # k * k * chunks
    tiles_m: int
    tiles_n: int
    splits: int
    per_split: int  # K slices per split (the last may have fewer)
    Wp: int  # flat: the output grid's row pitch (W + 1 for 3x3, W for 1x1)
    QV: int  # flat: output grid pixels per view
    tw: int  # rect: the tile's width and height in output pixels (tw th = 128)
    th: int
    tiles_w: int
    tiles_h: int
    bn: int
    C: int
    q_rows: int
    q_wp: int
    q_row0: int
    q_vstride: int
    pads: int
    rows_alloc: int
    group: int  # K slices per pipeline stage
    halo: int  # flat 3x3: rows of a plane a stage copies
    stages: int
    stage_bytes: int

    def kernel_args(self, out_kind: int, relu: bool) -> List[int]:
        """The kernel's ``Plan`` struct, 30 ints."""
        names = ("mode", "B", "Cp", "H", "W", "Co", "k", "stride", "pad", "Ho", "Wo", "chunks", "slices",
                 "tiles_m", "tiles_n", "splits", "per_split", "Wp", "QV", "tw", "th", "tiles_w", "tiles_h",
                 "rows_alloc", "group", "halo", "stages", "stage_bytes")
        return [getattr(self, n) for n in names] + [out_kind, int(relu)]

    # The launches' C arguments, built on a plan's first launch and kept with
    # it (plans are cached per shape): the ctypes arrays of the two structs
    # and of the rect mode's tensor map arguments.
    @functools.cached_property
    def _c_kernel_args(self) -> Dict[Tuple[int, bool], ctypes.Array]:
        return {}

    def c_kernel_args(self, out_kind: int, relu: bool) -> ctypes.Array:
        args = self._c_kernel_args.get((out_kind, relu))
        if args is None:
            args = self._c_kernel_args[(out_kind, relu)] = (ctypes.c_int * 30)(*self.kernel_args(out_kind, relu))
        return args

    @functools.cached_property
    def c_quant_args(self) -> ctypes.Array:
        return (ctypes.c_int * 15)(*self.quant_args())

    @functools.cached_property
    def c_map_args(self) -> ctypes.Array:
        return _map_array(tensor_map_args(self) if self.mode == RECT else None)

    @property
    def blocked(self) -> bool:
        """1x1: the rows in blocks of 128, each block's 16-channel planes
        contiguous (a stage's chunks are one copy)."""
        return self.mode == FLAT and self.k == 1

    @property
    def plane_stride(self) -> int:
        return self.rows_alloc if self.mode == FLAT else 1

    @property
    def row_stride(self) -> int:
        return 1 if self.mode == FLAT else self.Cp // 16

    def row_offset(self, group: int, row: int) -> int:
        """Byte offset of a row's 16-channel group in ``quantize_rows``' bytes."""
        if self.blocked:
            return ((row // TILE_M) * (self.Cp // 16) + group) * 2048 + (row % TILE_M) * 16
        return 16 * (group * self.plane_stride + row * self.row_stride)

    def quant_args(self) -> List[int]:
        """The quantisation pass's ``QuantPlan`` struct, 15 ints."""
        p_blocks = -(-self.H * self.W // QUANT_PIXELS)
        c_blocks = self.Cp // CHANNEL_STEP
        return [self.B, self.C, self.Cp, self.H, self.W, self.q_wp, self.q_row0, self.q_vstride,
                p_blocks, c_blocks, self.B * p_blocks * c_blocks, self.pads, self.plane_stride, self.row_stride,
                int(self.blocked)]

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n * self.splits

    @property
    def workspace_ints(self) -> int:
        """int32 partial sums of a split plan (0 unsplit)."""
        return self.tiles_m * self.tiles_n * TILE_M * self.bn if self.splits > 1 else 0

    @property
    def rows_bytes(self) -> int:
        """The quantised activation's bytes (``quantize_rows``)."""
        return self.rows_alloc * self.Cp


def tile_n(Co: int) -> int:
    """The tile width that pads Co least, then with the fewest tiles."""
    return min(TILE_N_CHOICES, key=lambda bn: (-(-Co // bn) * bn - Co, -(-Co // bn)))


def rect_tile(Ho: int, Wo: int) -> Tuple[int, int]:
    """(tw, th), tw th = 128: the least padded area of the view, then the widest."""
    shapes = [(tw, TILE_M // tw) for tw in (8, 16, 32, 64, 128)]
    return min(shapes, key=lambda s: (-(-Wo // s[0]) * s[0] * (-(-Ho // s[1])) * s[1], -s[0]))


def modelled_clocks(tiles_m: int, Co: int, slices: int, bn: int, splits: int, unit: int = 1
                    ) -> Tuple[int, int, int]:
    """The time model above for one (tile width, split) -> (clocks, splits,
    slices per split), the split rounded to whole ``unit``s of slices."""
    per = -(-slices // splits)
    per = -(-per // unit) * unit
    splits = -(-slices // per)
    blocks = tiles_m * -(-Co // bn) * splits
    rounds = -(-blocks // SM_COUNT)
    waves = -(-blocks // (SM_COUNT * RESIDENT[bn]))
    block = per * (bn + SLICE_CLOCKS) + (REDUCE_CLOCKS_PER_N * bn if splits > 1 else 0)
    return rounds * block + waves * FILL_CLOCKS, splits, per


def choose_tiling(tiles_m: int, Co: int, slices: int, mode: int, k: int, Wp: int, bn: Optional[int] = None
                  ) -> Tuple[int, int, int, Tuple[int, int, int, int]]:
    """(bn, splits, slices per split, ``ring``): the least modelled time among
    the tile widths that pad Co by at most MAX_PADDED_N (or ``bn`` if given)
    and whose ring fits, and the splits of at least MIN_SLICES_PER_SPLIT
    slices (whole stages of a flat 3x3 conv); then the fewest splits. A full
    wave of SM_COUNT blocks is not asked for: a split block's reduction costs
    more than the SMs it fills save at stage 5's 224 -> 224 (its 56 blocks
    unsplit against 224 in 4 splits, PERF.md)."""
    widths = [bn] if bn is not None else [
        w for w in TILE_N_CHOICES if -(-Co // w) * w - Co <= MAX_PADDED_N * Co] or [tile_n(Co)]
    options = []
    for w in widths:
        pipe = ring(mode, k, Wp, w)
        if pipe is None:
            continue
        unit = pipe[0] if mode == FLAT and k == 3 else 1
        for s in range(1, max(1, min(MAX_SPLITS, slices // max(MIN_SLICES_PER_SPLIT, unit))) + 1):
            clocks, splits, per = modelled_clocks(tiles_m, Co, slices, w, s, unit)
            options.append((clocks, splits, -w, per, pipe))
    if not options:
        raise ValueError(f"no tile width of {widths} fits its ring: Co {Co}, W + 1 = {Wp}")
    _, splits, w, per, pipe = min(options)
    return -w, splits, per, pipe


@functools.lru_cache(maxsize=None)
def conv_plan(B: int, C: int, H: int, W: int, Co: int, k: int, stride: int, bn: Optional[int] = None) -> ConvPlan:
    """K6's plan for x (B, C, H, W) and a (Co, C, k, k) weight at ``stride``;
    ``bn`` fixes the tile width (the weight's tiles), else the plan picks it."""
    if k not in (1, 3) or stride not in (1, 2) or min(B, C, H, W, Co) <= 0 or (
            bn is not None and bn not in TILE_N_CHOICES):
        raise ValueError(f"K6 takes kernel 1 or 3, stride 1 or 2: got {(B, C, H, W, Co, k, stride, bn)}")
    pad = k // 2
    Ho, Wo = (H + 2 * pad - k) // stride + 1, (W + 2 * pad - k) // stride + 1
    Cp = padded_channels(C)
    chunks = Cp // CHANNEL_STEP
    slices = k * k * chunks
    tw = th = tiles_w = tiles_h = 0
    if stride == 1 and k == 3:  # flat over the padded layout: a tap is a shift of at most 2 (W + 1) + 2 rows
        mode, Wp = FLAT, W + 1
        QV = (H + 1) * Wp
        tiles_m = -(-(B * (H + 1) - 1) * Wp // TILE_M)
        # one more zero pixel after the last row: the last view's last tap reads it
        q_rows, q_wp, q_row0, q_vstride = (1 + B * (H + 1)) * Wp + 1, Wp, Wp + 1, QV
        pads = (B + 1) * Wp + B * H + 1
        rows_alloc = max(q_rows, tiles_m * TILE_M + 2 * Wp + 2)
    else:
        q_rows, q_wp, q_row0, q_vstride, pads = B * H * W, W, 0, H * W, 0
        if stride == 1:  # 1x1: the rows themselves
            mode, Wp, QV = FLAT, W, H * W
            tiles_m = -(-B * H * W // TILE_M)
            rows_alloc = tiles_m * TILE_M
        else:
            mode, Wp, QV = RECT, 0, 0
            tw, th = rect_tile(Ho, Wo)
            tiles_w, tiles_h = -(-Wo // tw), -(-Ho // th)
            tiles_m = B * tiles_h * tiles_w
            rows_alloc = q_rows
    bn, splits, per_split, (group, halo, stages, stage_bytes) = choose_tiling(tiles_m, Co, slices, mode, k, Wp, bn)
    return ConvPlan(mode, B, Cp, H, W, Co, k, stride, pad, Ho, Wo, chunks, slices, tiles_m, -(-Co // bn), splits,
                    per_split, Wp, QV, tw, th, tiles_w, tiles_h, bn, C, q_rows, q_wp, q_row0, q_vstride, pads,
                    rows_alloc, group, halo, stages, stage_bytes)


def tensor_map_args(plan: ConvPlan) -> Dict[str, List[int]]:
    """The rect mode's TMA tensor map over the channels-last int8 rows,
    innermost dimension first: dims, strides (bytes, dimensions 1..), box and
    element strides (the conv's stride in both pixel dimensions)."""
    if plan.mode != RECT:
        raise ValueError("only the rect (stride-2) mode reads its activation through a tensor map")
    s = plan.stride
    return {"dims": [plan.Cp, plan.W, plan.H, plan.B],
            "strides": [plan.Cp, plan.W * plan.Cp, plan.H * plan.W * plan.Cp],
            "box": [CHANNEL_STEP, plan.tw * s, plan.th * s, 1], "element_strides": [1, s, s, 1]}


def _map_array(m: Optional[Dict[str, List[int]]]):
    """The C side's layout: [rank, dims[5], strides[4], box[5], element strides[5]]."""
    if m is None:
        return (ctypes.c_longlong * 20)()

    def fill(v, n):
        return list(v) + [0] * (n - len(v))

    vals = [len(m["dims"])] + fill(m["dims"], 5) + fill(m["strides"], 4) + fill(m["box"], 5) + fill(
        m["element_strides"], 5)
    return (ctypes.c_longlong * 20)(*vals)


# ----------------------------------------------------------- CUDA launch
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split plans' int32 partial sums and per-tile counters, one pair per
    device and stream: zero when allocated, and the kernel leaves them zero."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    ws, counters = _workspaces.get(key, (None, None))
    tiles = plan.tiles_m * plan.tiles_n
    if ws is None or ws.numel() < plan.workspace_ints or counters.numel() < tiles:
        n_ws = max(plan.workspace_ints, 0 if ws is None else ws.numel())
        n_c = max(tiles, 0 if counters is None else counters.numel())
        ws = torch.zeros(n_ws, dtype=torch.int32, device=device)
        counters = torch.zeros(n_c, dtype=torch.int32, device=device)
        _workspaces[key] = (ws, counters)
    return ws, counters


def _check_operands(x, wt, sa, scale, add, stride):
    if x.dim() != 4 or wt.dim() != 5 or wt.dtype != torch.int8 or scale.dim() != 1:
        raise ValueError(f"x {tuple(x.shape)} must be NCHW, wt {tuple(wt.shape)} {wt.dtype} int8 weight tiles "
                         f"(tile_weight) and scale (Co,)")
    B, C, H, W = x.shape
    Co = scale.shape[0]
    tiles, slices, halves, bn, width = wt.shape
    Cp = padded_channels(C)
    k = round((slices * CHANNEL_STEP // Cp) ** 0.5)
    if (halves, width) != (2, 16) or bn not in TILE_N_CHOICES or tiles != -(-Co // bn) or k not in (1, 3) or (
            k * k * Cp != slices * CHANNEL_STEP) or stride not in (1, 2):
        raise ValueError(f"unsupported conv: x {tuple(x.shape)}, wt {tuple(wt.shape)}, Co {Co}, stride {stride}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not (wt.device == sa.device == scale.device == add.device == x.device):
        raise ValueError("x, wt, sa, scale and add must be on one device")
    if add.shape != (Co,) or sa.numel() != 1:
        raise ValueError(f"add {tuple(add.shape)} must be ({Co},), sa one value")
    return conv_plan(B, C, H, W, Co, k, stride, bn)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t if t.is_contiguous() else t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fp32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.to(torch.float32).contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_rows(x: torch.Tensor, sa: torch.Tensor, plan: ConvPlan, stream: Optional[int] = None) -> torch.Tensor:
    """K6's activation quantisation pass: x (B, C, H, W) on the card ->
    ``plan``'s int8 rows (``rows_bytes`` bytes), the padding pixels zero."""
    global QUANT_LAUNCHES
    lib = _library()
    xq = torch.empty(plan.rows_bytes, dtype=torch.int8, device=x.device)
    err = lib.petr_quantize_act(x.data_ptr(), _DTYPE_CODES[x.dtype], sa.data_ptr(), xq.data_ptr(), plan.c_quant_args,
                                _stream(x) if stream is None else stream)
    _raise_on(lib, err, "activation quantisation")
    QUANT_LAUNCHES += 1
    return xq


def rows_view(xq: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """``quantize_rows``' bytes as (q_rows, Cp): each pixel row's channels."""
    if plan.blocked:
        blocks = xq.view(plan.rows_alloc // TILE_M, plan.Cp // 16, TILE_M, 16)
        return blocks.permute(0, 2, 1, 3).reshape(plan.rows_alloc, plan.Cp)[:plan.q_rows]
    if plan.mode == FLAT:
        planes = xq.view(plan.Cp // 16, plan.rows_alloc, 16)[:, :plan.q_rows]
        return planes.permute(1, 0, 2).reshape(plan.q_rows, plan.Cp)
    return xq.view(plan.rows_alloc, plan.Cp)[:plan.q_rows]


def unpack_rows(xq: torch.Tensor, plan: ConvPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_rows``' bytes -> (xi (B, C, H, W) int8, the padding rows'
    bytes (pads, Cp) and the data rows' bytes past C, flattened): what the
    checks hold to ``quantize_activation`` and to zero."""
    rows = rows_view(xq, plan)
    B, H, W = plan.B, plan.H, plan.W
    dev = xq.device
    data = (plan.q_row0 + torch.arange(B, device=dev)[:, None, None] * plan.q_vstride
            + torch.arange(H, device=dev)[None, :, None] * plan.q_wp + torch.arange(W, device=dev)).reshape(-1)
    pad = torch.ones(plan.q_rows, dtype=torch.bool, device=dev)
    pad[data] = False
    pixels = rows[data].view(B, H, W, plan.Cp)
    zeros = torch.cat([rows[pad].reshape(-1), pixels[..., plan.C:].reshape(-1)])
    return pixels[..., :plan.C].permute(0, 3, 1, 2), zeros


def conv_rows(xq: torch.Tensor, wt: torch.Tensor, scale: torch.Tensor, add: torch.Tensor, plan: ConvPlan,
              out_dtype: torch.dtype, relu: bool, stream: Optional[int] = None) -> torch.Tensor:
    """K6's conv on the quantised rows and the weight tiles: (B, Co, Ho, Wo)
    in ``out_dtype`` (fp32 or bf16 through the epilogue, int32 the sums
    themselves)."""
    global LAUNCHES
    lib = _library()
    out = torch.empty((plan.B, plan.Co, plan.Ho, plan.Wo), dtype=out_dtype, device=xq.device)
    stream = _stream(xq) if stream is None else stream
    ws, counters = _workspace(xq.device, stream, plan) if plan.splits > 1 else (None, None)
    err = lib.petr_conv_int8_fwd(
        xq.data_ptr(), wt.data_ptr(), scale.data_ptr(), add.data_ptr(), out.data_ptr(),
        plan.c_kernel_args(OUT_KINDS[out_dtype], relu), plan.bn, plan.c_map_args,
        None if ws is None else ws.data_ptr(), None if counters is None else counters.data_ptr(), stream)
    _raise_on(lib, err, "conv")
    LAUNCHES += 1
    return out


def _forward_cuda(x, wt, sa, scale, add, stride, relu, out_dtype):
    """K6: the quantisation pass, then the conv."""
    plan = _check_operands(x, wt, sa, scale, add, stride)
    x, wt, sa, scale, add = _aligned(x), _aligned(wt), _fp32(sa), _fp32(scale), _fp32(add)
    if x.numel() == 0:
        return torch.zeros((plan.B, plan.Co, plan.Ho, plan.Wo), dtype=out_dtype, device=x.device)
    stream = _stream(x)
    return conv_rows(quantize_rows(x, sa, plan, stream), wt, scale, add, plan, out_dtype, relu, stream)


def conv_int8_accumulate(x: torch.Tensor, wi: torch.Tensor, sa: torch.Tensor, stride: int,
                         bn: Optional[int] = None) -> torch.Tensor:
    """K6's int32 sums of quantised x and wi (int8 OIHW) on a CUDA tensor (the
    check of the accumulators against ``conv_int8_accumulate_reference``);
    ``bn`` fixes the tile width."""
    if x.device.type != "cuda":
        raise ValueError("conv_int8_accumulate launches K6: pass CUDA tensors")
    wq = pack_weight(wi, padded_channels(wi.shape[1]))
    B, C, H, W = x.shape
    wt = tile_weight(wq, conv_plan(B, C, H, W, wi.shape[0], wi.shape[-1], stride, bn).bn)
    zeros = torch.zeros(wi.shape[0], dtype=torch.float32, device=x.device)
    return _forward_cuda(x, wt, sa, zeros, zeros, stride, False, torch.int32)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"conv_int8 {what} kernel launch failed ({err}): "
                           + lib.petr_cuda_error_string(err).decode())


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("conv_int8")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.petr_quantize_act.argtypes = [P, I, P, P, P, P]
    lib.petr_quantize_act.restype = I
    lib.petr_conv_int8_fwd.argtypes = [P] * 6 + [I] + [P] * 4
    lib.petr_conv_int8_fwd.restype = I
    lib.petr_cuda_error_string.argtypes = [I]
    lib.petr_cuda_error_string.restype = ctypes.c_char_p
    return lib
