"""Host-side logic of the bf16 tensor-core kernels (K5, K4 and K2), on the CPU.

The kernels themselves run only on the card (``test_torch_port_cuda.py``);
what their wrappers compute around them is checked here. K5: its plan
(``conv_plan``: tile width, split of K, ring stages against the block's
shared memory, the register budget of the tile width) at VoVNet's shapes and
odd ones, its layout pass's plain version, its weight image against
petr_tpu's ``(9 * C, Co)`` order, and the walk the kernel makes (tiles of the
flat padded grid, 16-channel chunks, taps as row shifts of one halo, splits
added in split order) written out in numpy against petr_tpu's
``_xla_reference`` and its Pallas kernel in interpret mode. K4: its tiling
at the r50 shapes, its weight image against petr_tpu's patch order, and its
walk (64-pixel tiles, 64-channel chunks of one tap, the samples summed from
their corners in the plain version's order) against petr_tpu's XLA
formulation, its Pallas kernel in interpret mode and the bf16 rounding
floor. Also the weight images' cache, and K2's check of which inputs its
16-byte copies may read in place.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from petr_tpu.ops.dcn import modulated_deform_conv as jax_dcn
from petr_tpu.ops.pallas.conv3x3 import _conv3x3_raw, _xla_reference
from petr_tpu.ops.pallas.dcn import modulated_deform_conv_pallas
from petr_tpu_torch.ops import conv3x3, conv_int8, dcn, weight_images
from petr_tpu_torch.ops import cross_attention as ca

SM_COUNT = 132
REGISTERS = 65536  # 32-bit registers of an SM
# K5's route: 6 views; (Cin, H, W, Co), as chip_smoke.py's CONV_SHAPES
VOVNET = [(128, 80, 200, 128), (256, 40, 100, 160), (512, 40, 100, 160), (160, 40, 100, 160), (512, 20, 50, 192),
          (768, 20, 50, 192), (192, 20, 50, 192), (768, 10, 25, 224), (1024, 10, 25, 224), (224, 10, 25, 224)]
ODD = [(1, 1, 1, 1, 1), (1, 13, 5, 7, 70), (2, 8, 12, 9, 16), (1, 35, 5, 26, 6), (1, 200, 10, 25, 64),
       (2, 24, 11, 50, 160), (1, 8, 3, 130, 96), (3, 40, 10, 25, 224), (1, 17, 6, 11, 5), (6, 64, 1, 300, 300),
       (1, 2048, 4, 4, 8), (4, 96, 33, 1, 40), (2, 16, 64, 64, 256), (1, 3, 320, 800, 64), (6, 1024, 5, 13, 224),
       (1, 48, 2, 2, 1000)]


def register_budget(threads: int, resident: int) -> int:
    """Registers a thread may hold when ``resident`` blocks of ``threads``
    share an SM (ptxas rounds down to a multiple of 8; at most 255)."""
    return min(255, REGISTERS // (threads * resident) // 8 * 8)


def check_k5_plan(plan):
    """What the kernel's entry point checks, and what the ring and the
    registers must fit."""
    bn = plan.bn
    assert bn in conv_int8.TILE_N_CHOICES and plan.tiles_n == -(-plan.Co // bn)
    assert plan.Cp % conv3x3.CHANNEL_STEP == 0 and plan.C <= plan.Cp < plan.C + conv3x3.CHANNEL_STEP
    assert plan.slices == 9 * plan.chunks == 9 * plan.Cp // 16
    # every output pixel of the flat grid is in a tile, and the last tile's halo in the planes
    assert plan.tiles_m * conv3x3.TILE_M >= (plan.B * (plan.H + 1) - 1) * plan.Wp
    assert plan.rows_alloc >= plan.tiles_m * conv3x3.TILE_M + 2 * plan.Wp + 2 and plan.rows_alloc >= plan.q_rows
    # the splits cover K in whole stages; none is empty
    assert plan.group in (9, 3) and plan.per_split % plan.group == 0 and plan.slices % plan.group == 0
    assert (plan.splits - 1) * plan.per_split < plan.slices <= plan.splits * plan.per_split
    assert plan.halo == 128 + (2 * plan.Wp if plan.group == 9 else 0) + 2
    # the ring: 2 to 4 stages, each A (two planes of the halo) and B (the stage's slices)
    a_bytes = 2 * (-(-plan.halo // 8) * 8) * 16
    assert plan.stage_bytes % 1024 == 0 and plan.stage_bytes >= a_bytes + plan.group * bn * 32
    assert 2 <= plan.stages <= conv_int8.MAX_STAGES
    assert plan.stages * plan.stage_bytes <= conv_int8.RING_BYTES[bn]
    assert bn * (conv3x3.TILE_M + 4) * 4 <= conv_int8.RING_BYTES[bn]  # the epilogue's fp32 tile overlays the ring
    assert conv_int8.RESIDENT[bn] * conv3x3.smem_bytes(bn) <= 233472  # the SM's 228 KB
    assert conv3x3.smem_bytes(bn) <= conv3x3.SMEM_LIMIT
    # a consumer thread holds bn / 2 fp32 sums; leave 40 registers for addresses and the loop
    assert bn // 2 + 40 <= register_budget(conv3x3.THREADS, conv_int8.RESIDENT[bn])
    # the layout pass's blocks and zero pixels
    assert plan.p_blocks == -(-plan.H * plan.W // conv3x3.LAYOUT_PIXELS)
    assert plan.data_blocks == plan.B * plan.p_blocks * plan.Cp // 16
    assert plan.pads == plan.q_rows - plan.B * plan.H * plan.W
    if plan.splits > 1:
        assert plan.workspace_floats == plan.tiles_m * plan.tiles_n * plan.splits * conv3x3.TILE_M * bn


@pytest.mark.parametrize("C,H,W,Co", VOVNET, ids=[f"{c}-{h}x{w}-{co}" for c, h, w, co in VOVNET])
def test_conv_plan_at_the_vovnet_shapes(C, H, W, Co):
    """6 views on 132 SMs: the plan fits the card, pads Co by at most a
    quarter, and splits K only where the tiles leave SMs idle (at 20x50 and
    10x25), never so far that a split holds fewer than 4 slices."""
    plan = conv3x3.conv_plan(6, C, H, W, Co)
    check_k5_plan(plan)
    assert plan.tiles_n * plan.bn - Co <= conv_int8.MAX_PADDED_N * Co
    assert plan.per_split >= conv_int8.MIN_SLICES_PER_SPLIT
    assert plan.splits == 1 or plan.tiles_m * plan.tiles_n < SM_COUNT
    if H >= 40:  # 80x200 and 40x100: 762 and 194 tiles of 128 pixels, more than the SMs
        assert plan.splits == 1 and plan.tiles_m * plan.tiles_n >= SM_COUNT
    assert plan.group == (3 if W == 200 else 9)  # at W = 200 two 9-tap stages of 128 channels do not fit


@pytest.mark.parametrize("B,C,H,W,Co", ODD)
def test_conv_plan_bounds(B, C, H, W, Co):
    plan = conv3x3.conv_plan(B, C, H, W, Co)
    check_k5_plan(plan)
    assert plan.splits <= conv_int8.MAX_SPLITS


@pytest.mark.parametrize("C", [13, 16, 40])
def test_repack_is_petr_tpu_weight_order(C):
    """The weight image of output channel o, read along K (chunk by chunk,
    each chunk's 9 taps), holds column o of petr_tpu's ``wf =
    weight.reshape(9 * C, Co)`` (HWIO) for that chunk's channels, zero past C
    and past Co; and it goes back to the weight."""
    Co = 24
    w_hwio = np.random.RandomState(C).randn(3, 3, C, Co).astype(np.float32)
    w_oihw = torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy())
    image = conv3x3.weight_image(w_oihw, 64, torch.float32)
    Cp = -(-C // 16) * 16
    assert image.shape == (1, 9 * Cp // 16, 2, 64, 8)
    wf = w_hwio.reshape(9, C, Co)  # (tap, c, o): wf.reshape(9 C, Co) row tap * C + c
    for s in range(image.shape[1]):
        chunk, tap = divmod(s, 9)
        got = image[0, s].permute(1, 0, 2).reshape(64, 16).numpy()  # (o, the slice's 16 channels)
        for c16 in range(16):
            c = 16 * chunk + c16
            want = wf[tap, c] if c < C else np.zeros(Co, np.float32)
            np.testing.assert_array_equal(got[:Co, c16], want)
        assert (got[Co:] == 0).all()
    torch.testing.assert_close(conv3x3.unweight_image(image, Co, C), w_oihw, rtol=0, atol=0)
    assert conv3x3.weight_image(w_oihw, 64).dtype == torch.bfloat16


@pytest.mark.parametrize("B,C,H,W", [(1, 13, 5, 7), (2, 16, 3, 9), (3, 40, 4, 1)])
def test_layout_reference_round_trips(B, C, H, W):
    """The layout pass's plain version puts pixel (b, ih, iw) at row Wp + 1 +
    b QV + ih Wp + iw of each 8-channel plane and zeros everywhere else."""
    x = torch.randn(B, C, H, W).bfloat16()
    plan = conv3x3.conv_plan(B, C, H, W, 8)
    planes = conv3x3.layout_reference(x, plan)
    assert planes.shape == (plan.Cp // 8, plan.rows_alloc, 8) and planes.dtype == x.dtype
    back, zeros = conv3x3.unpack_planes(planes, plan)
    assert torch.equal(back, x) and (zeros == 0).all()
    assert zeros.numel() == plan.q_rows * plan.Cp - B * C * H * W
    b, ih, iw, c = B - 1, H - 1, W - 1, C - 1
    assert planes[c // 8, plan.Wp + 1 + b * plan.QV + ih * plan.Wp + iw, c % 8] == x[b, c, ih, iw]


def implicit_gemm(x, weight, mul, add, relu):
    """The bf16 kernel's walk in float64 numpy: x (B, C, H, W), weight OIHW.
    The plan's tiles of 128 rows of the flat padded grid by bn channels; per
    tile and split, its K slices stage by stage (a chunk's 16 channels, its
    taps as row shifts of the stage's halo of two 8-channel planes) against
    the weight image's slices; the splits' sums added in split order; the
    rows mapped back to NCHW; then the fp32 epilogue."""
    B, C, H, W = x.shape
    Co = weight.shape[0]
    plan = conv3x3.conv_plan(B, C, H, W, Co)
    planes = conv3x3.layout_reference(torch.from_numpy(x).double(), plan).numpy()
    image = conv3x3.weight_image(torch.from_numpy(weight).double(), plan.bn, torch.float64).numpy()
    bn, TM = plan.bn, conv3x3.TILE_M
    flat = np.full((plan.tiles_m * TM, plan.tiles_n * bn), np.nan)
    for tm in range(plan.tiles_m):
        q0 = tm * TM
        for tn in range(plan.tiles_n):
            sums = []
            for split in range(plan.splits):
                acc = np.zeros((TM, bn))
                first_of_split = split * plan.per_split
                n_stage = min(plan.per_split, plan.slices - first_of_split) // plan.group
                for st in range(n_stage):
                    first = first_of_split + st * plan.group
                    chunk, tap0 = divmod(first, 9)
                    row0 = q0 + (tap0 // 3) * plan.Wp
                    halo = planes[2 * chunk:2 * chunk + 2, row0:row0 + plan.halo]  # (2, halo, 8)
                    assert halo.shape[1] == plan.halo, "a stage's copy runs past the planes"
                    for j in range(plan.group):
                        shift = (j // 3) * plan.Wp + j % 3
                        a = halo[:, shift:shift + TM].transpose(1, 0, 2).reshape(TM, 16)
                        b = image[tn, first + j].transpose(1, 0, 2).reshape(bn, 16)
                        acc += a @ b.T
                sums.append(acc)
            total = sums[0]
            for s in sums[1:]:
                total = total + s
            flat[q0:q0 + TM, tn * bn:(tn + 1) * bn] = total
    q = (np.arange(B)[:, None, None] * plan.QV + np.arange(H)[None, :, None] * plan.Wp + np.arange(W)).reshape(-1)
    out = flat[q, :Co].reshape(B, H, W, Co).transpose(0, 3, 1, 2)
    assert not np.isnan(out).any(), "a pixel no tile covered"
    if mul is not None:
        out = out * mul[:, None, None] + add[:, None, None]
    return np.maximum(out, 0.0) if relu else out


@pytest.mark.parametrize("B,C,H,W,Co", [(1, 20, 7, 30, 10), (2, 8, 12, 9, 16), (1, 35, 5, 26, 6)])
def test_implicit_gemm_walk_matches_petr_tpu(B, C, H, W, Co):
    rng = np.random.RandomState(C + W)
    x = rng.randn(B, C, H, W).astype(np.float32)
    weight = (rng.randn(Co, C, 3, 3) * (2.0 / (9 * C)) ** 0.5).astype(np.float32)
    mul = rng.uniform(0.5, 1.5, Co).astype(np.float32)
    add = rng.normal(0.0, 0.3, Co).astype(np.float32)
    got = implicit_gemm(x, weight, mul, add, True).transpose(0, 2, 3, 1)
    jx, jw = jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(weight.transpose(2, 3, 1, 0))
    want = np.asarray(_xla_reference(jx, jw, jnp.asarray(mul), jnp.asarray(add), True))
    scale = np.abs(want).max()
    # fp32 sums (petr_tpu) against float64 ones: within 1e-5 of the largest output
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    if H >= 4 and W >= 8:  # the shapes the Pallas kernel takes (conv3x3_supported)
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(_conv3x3_raw(jx, jw, jnp.asarray(mul), jnp.asarray(add), True))
        np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5 * scale)


def test_implicit_gemm_walk_matches_the_plain_version_without_epilogue():
    """At a shape whose plan splits K (2 views of 10 x 25, 200 channels)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 200, 10, 25).astype(np.float32)
    weight = rng.randn(5, 200, 3, 3).astype(np.float32)
    assert conv3x3.conv_plan(2, 200, 10, 25, 5).splits > 1
    want = conv3x3.conv3x3_bn_relu_reference(torch.from_numpy(x), torch.from_numpy(weight), None, None, False)
    got = implicit_gemm(x, weight, None, None, False)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5 * np.abs(want.numpy()).max())


# ------------------------------------------------------------------- K4
R50 = {"stage3": (6, 256, 32, 88, 256), "stage4": (6, 512, 16, 44, 512),
       "synth-stage3": (24, 256, 8, 20, 256), "synth-stage4": (24, 512, 4, 10, 512)}


@pytest.mark.parametrize("label", list(R50))
def test_k4_tiling_at_the_r50_shapes(label):
    """64 pixels by 256 channels a block: at both r50 stages the grid is 132
    blocks a wave (264 at stage 3, 132 at stage 4), each sample gathered once
    at Cout 256 and twice at 512; the ring and the corner table fit the
    block's shared memory; a consumer thread holds 64 fp32 sums within the
    registers 512 threads leave it."""
    B, Cin, H, W, Cout = R50[label]
    blocks = -(-B * H * W // dcn.TILE_PIXELS) * -(-Cout // dcn.TILE_CHANNELS)
    gathers = -(-Cout // dcn.TILE_CHANNELS)
    if not label.startswith("synth"):
        assert blocks % SM_COUNT == 0
    assert gathers == Cout // 256
    assert dcn.SMEM_BYTES <= conv3x3.SMEM_LIMIT
    assert (dcn.TILE_PIXELS * dcn.TILE_CHANNELS // 256) + 40 <= register_budget(dcn.THREADS, 1)
    # chunks: 64 channels of one tap, 4 k16 products each
    nct = -(-dcn.padded_channels(Cin) // dcn.CHUNK_CHANNELS)
    assert 9 * nct == dcn.weight_image(torch.zeros(Cout, Cin, 3, 3)).shape[1]


@pytest.mark.parametrize("Cin,Cout", [(5, 3), (70, 300), (64, 256)])
def test_k4_weight_image_is_petr_tpu_patch_order(Cin, Cout):
    """Chunk ch of the image (tap ch // nct, 64 channels from 64 (ch % nct))
    holds rows tap * Cin + c of petr_tpu's (9 Cin, Cout) weight for its
    channels, zero past Cin and Cout; and it goes back to the weight."""
    w_hwio = np.random.RandomState(Cin).randn(3, 3, Cin, Cout).astype(np.float32)
    w_oihw = torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy())
    image = dcn.weight_image(w_oihw, torch.float32)
    nct = -(-dcn.padded_channels(Cin) // 64)
    tiles = -(-Cout // 256)
    assert image.shape == (tiles, 9 * nct, 8, 256, 8)
    patch = w_hwio.reshape(9 * Cin, Cout)
    cols = image.permute(0, 3, 1, 2, 4).reshape(tiles * 256, 9, nct * 64).numpy()  # (o, tap, c)
    for tap in range(9):
        np.testing.assert_array_equal(cols[:Cout, tap, :Cin].T, patch[tap * Cin:(tap + 1) * Cin])
    assert (cols[Cout:] == 0).all() and (cols[:, :, Cin:] == 0).all()
    torch.testing.assert_close(dcn.unweight_image(image, Cout, Cin), w_oihw, rtol=0, atol=0)


def k4_walk(x, off_mask, weight, stride, round_operands):
    """The bf16 kernel's walk in numpy: x (B, Cin, H, W) fp32, off_mask (B, 27,
    Ho, Wo), weight OIHW. The corners of each (pixel, tap) of the B Ho Wo
    pixels (one axis, in 64-pixel tiles), their fractions and sigmoid in fp32;
    per chunk (64 channels of one tap) the samples summed from the corners in
    fp32 in the kernel's order and, with ``round_operands``, rounded to bf16
    with the weight; the products summed in float64."""
    f32 = np.float32
    B, Cin, H, W = x.shape
    Ho, Wo = off_mask.shape[2:]
    P, Cp = Ho * Wo, dcn.padded_channels(Cin)
    nct = -(-Cp // 64)
    xs = np.zeros((B * H * W + 1, nct * 64), f32)  # channels-last rows; the last row reads as 0 (a corner outside)
    xs[:-1, :Cin] = x.transpose(0, 2, 3, 1).reshape(-1, Cin)
    wt = torch.from_numpy(weight)
    image = dcn.weight_image(wt, torch.bfloat16 if round_operands else torch.float32).double().numpy()
    M = B * P
    m = np.arange(-(-M // 64) * 64)
    valid = m < M
    b, pix = np.minimum(m, M - 1) // P, np.minimum(m, M - 1) % P
    oy, ox = pix // Wo, pix % Wo
    out = np.zeros((m.size, image.shape[0] * 256))
    for k in range(9):
        dy = off_mask[b, 2 * k, oy, ox].astype(f32)
        dx = off_mask[b, 2 * k + 1, oy, ox].astype(f32)
        logit = off_mask[b, 18 + k, oy, ox].astype(f32)
        sy = (oy * stride + (k // 3 - 1)).astype(f32) + dy
        sx = (ox * stride + (k % 3 - 1)).astype(f32) + dx
        y0, x0 = np.floor(sy), np.floor(sx)
        fy, fx = sy - y0, sx - x0
        mod = torch.sigmoid(torch.from_numpy(logit)).numpy()  # the plain version's; the kernel's is held to it on the card
        rows = []
        for q in range(4):
            yy, xx = y0 + (q >> 1), x0 + (q & 1)
            inside = valid & (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            idx = (b * H + yy.clip(0, H - 1).astype(np.int64)) * W + xx.clip(0, W - 1).astype(np.int64)
            rows.append(np.where(inside, idx, B * H * W))
        wx0, wy0 = f32(1) - fx, f32(1) - fy
        for cc in range(nct):
            v = [xs[r][:, 64 * cc:64 * cc + 64] for r in rows]
            s = (v[0] * wx0[:, None]) * wy0[:, None] + (v[1] * fx[:, None]) * wy0[:, None]
            s = s + (v[2] * wx0[:, None]) * fy[:, None]
            s = (s + (v[3] * fx[:, None]) * fy[:, None]) * mod[:, None]
            assert s.dtype == f32
            if round_operands:
                s = torch.from_numpy(s).bfloat16().double().numpy()
            for t in range(image.shape[0]):
                b_tile = image[t, k * nct + cc].transpose(1, 0, 2).reshape(256, 64)  # (o, c)
                out[:, 256 * t:256 * t + 256] += s.astype(np.float64) @ b_tile.T
    out = out[:M, :weight.shape[0]].reshape(B, P, -1).transpose(0, 2, 1).reshape(B, -1, Ho, Wo)
    return out


def k4_case(stride, B, H, W, Cin, Cout, seed):
    rng = np.random.RandomState(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = rng.randn(B, Cin, H, W).astype(np.float32)
    off_mask = np.concatenate([rng.randn(B, 18, Ho, Wo) * 3.0, rng.randn(B, 9, Ho, Wo) * 1.5], 1).astype(np.float32)
    w = (rng.randn(Cout, Cin, 3, 3) * (2.0 / (9 * Cin)) ** 0.5).astype(np.float32)
    return x, off_mask, w


@pytest.mark.parametrize("stride,B,H,W,Cin,Cout", [(1, 2, 9, 11, 8, 16), (2, 2, 7, 9, 5, 3), (1, 1, 6, 13, 70, 20)])
def test_k4_walk_matches_petr_tpu(stride, B, H, W, Cin, Cout):
    """Tiles spanning two images, a ragged last tile, stride 2, Cin past one
    chunk: fp32 against petr_tpu's XLA formulation and its Pallas kernel."""
    x, off_mask, w = k4_case(stride, B, H, W, Cin, Cout, seed=Cin + W)
    got = k4_walk(x, off_mask, w, stride, False).transpose(0, 2, 3, 1)
    jx, jo, jw = (jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(off_mask.transpose(0, 2, 3, 1)),
                  jnp.asarray(w.transpose(2, 3, 1, 0)))
    xla = np.asarray(jax_dcn(jx, jo, jw, stride=stride, impl="xla"))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(modulated_deform_conv_pallas(jx, jo, jw, stride, 1, "onehot"))
    scale = np.abs(xla).max()
    # fp32 samples, float64 sums against fp32 ones: within 1e-5 of the largest output
    for want in (xla, pallas):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("stride", [1, 2])
def test_k4_walk_rounds_as_its_floor(stride):
    """With the samples and the weight rounded to bf16 the walk is the plain
    version with operand_dtype=bfloat16 (fp32 x: no rounding of the output)
    up to the order of the sums: within 1e-5 of the largest output."""
    x, off_mask, w = k4_case(stride, 2, 8, 10, 24, 12, seed=7 + stride)
    got = k4_walk(x, off_mask, w, stride, True)
    floor = dcn.modulated_deform_conv_reference(torch.from_numpy(x), torch.from_numpy(off_mask), torch.from_numpy(w),
                                                stride, operand_dtype=torch.bfloat16).double().numpy()
    unrounded = k4_walk(x, off_mask, w, stride, False)
    scale = np.abs(floor).max()
    assert (np.abs(got - floor) <= 1e-5 * scale).all()
    assert np.abs(got - unrounded).max() > 1e-4 * scale  # the rounding is there


def test_weight_images_are_made_once_per_weight_version():
    """An image is kept for its weight: made again after an in-place update
    (the version counter) or for another tensor, and forgotten with its
    weight."""
    made = []

    def make(w):
        made.append(1)
        return w * 2

    weight_images.clear()
    w = torch.randn(4, 3)
    a = weight_images.cached_image(w, "t", make)
    assert weight_images.cached_image(w, "t", make) is a and len(made) == 1
    with torch.no_grad():
        w.add_(1.0)
    b = weight_images.cached_image(w, "t", make)
    assert len(made) == 2 and torch.equal(b, w * 2)
    weight_images.cached_image(w, "other", make)
    assert len(made) == 3 and len(weight_images._images) == 2
    del w, a, b
    assert not weight_images._images
    with torch.inference_mode():
        v = torch.randn(2)
    weight_images.cached_image(v, "t", make)
    weight_images.cached_image(v, "t", make)
    assert len(made) == 5 and not weight_images._images  # inference tensors carry no version


# ------------------------------------------------------------------- K2
def test_rows_aligned_keeps_projection_views_and_copies_the_rest():
    """The bf16 backward copies rows in 16-byte pieces: the (B, H, ., D)
    views of (B, ., H, D) projections pass as they are, a view whose rows
    start off a 16-byte boundary becomes a contiguous copy."""
    buf = torch.zeros(2, 50, 4, 40, dtype=torch.bfloat16)
    view = buf[..., :32].transpose(1, 2)  # row stride 160 elements, rows at 320-byte steps
    shifted = buf[..., 3:35].transpose(1, 2)  # rows 6 bytes past the boundary
    narrow = torch.zeros(2, 4, 50, 36, dtype=torch.bfloat16)[..., :32]  # row stride 36
    offset = torch.zeros(2 * 4 * 50 * 32 + 1, dtype=torch.bfloat16)[1:].view(2, 4, 50, 32)  # contiguous, 2 B off
    kept, copied, copied2, copied3 = ca._rows_aligned(view, shifted, narrow, offset)
    assert kept.data_ptr() == view.data_ptr() and kept.stride() == view.stride()
    for before, after in ((shifted, copied), (narrow, copied2), (offset, copied3)):
        assert after.is_contiguous() and after.data_ptr() % 16 == 0
        assert torch.equal(after, before)


def test_cpu_backward_counts_no_launch_of_either_variant():
    q = torch.randn(1, 2, 5, 16)
    k = torch.randn(1, 2, 7, 16)
    counters = ("DKDV_LAUNCHES", "DQ_LAUNCHES", "DKDV_LAUNCHES_FP32", "DQ_LAUNCHES_FP32")
    before = [getattr(ca, c) for c in counters]
    for dtype in (torch.float32, torch.bfloat16):
        qs, ks, vs = (t.to(dtype).requires_grad_() for t in (q, k, k.flip(2)))
        out, _ = ca.flash_cross_attention(qs, ks, vs)
        out.float().sum().backward()
    assert [getattr(ca, c) for c in counters] == before
