"""K6's design on the CPU: the plan, the tensor maps, the packed weight and
the once-per-weight int8 operands.

The kernel itself runs only on the card (``tests/test_torch_port_cuda.py``,
``chip_smoke.py`` phase 13). What surrounds it is Python, and is held here:

* ``conv_plan`` for the 20 conv shapes of the flagship's V-99 at 6 views and
  for odd ones (Co = 300, planes that no tile divides, B = 1, Cin = 3, a 1x1
  stride-2 conv): tile widths, the split of K, one full wave of blocks at
  stages 4 and 5;
* the plan and ``tensor_map_args`` together, by an emulation of what the
  kernel does with them (the quantisation pass's rows and zero pixels, each
  K slice's TMA boxes with their strides and zero fill, the split partial
  sums, each tile row's output pixel): the int32 sums equal petr_tpu's
  (XLA's conv of the same int8 operands) and the plain version's bit for
  bit, every output written once;
* ``pack_weight``'s K order against ``quantize_weight``;
* ``QuantConv2d.int8_operands``: prepared once, and prepared again after any
  change to the weight, the BN statistics or the calibrated maximum, so that
  no stale weight is served; export and replay after such a change.

Tolerances: none; integers and the plain version's outputs are compared
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petr_tpu_torch.cli.quantize import synthetic_batch
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.models import layers
from petr_tpu_torch.models.layers import ConvBNReLU
from petr_tpu_torch.ops import conv_int8 as c8
from petr_tpu_torch.quant import apply_scales, calibrate_detector, quant_convs
from petr_tpu_torch.serve import build_detector, export_serving, load_artifact, make_serving_fn, save_artifact

VIEWS = 6
V99_SHAPES = {  # label: (Cin, H, W, Co, kernel, stride) of the flagship's int8 convs (chip_smoke.py INT8_SHAPES)
    "stem1": (3, 320, 800, 64, 3, 2), "stem2": (64, 160, 400, 64, 3, 1), "stem3": (64, 160, 400, 128, 3, 2),
    "s2": (128, 80, 200, 128, 3, 1), "s2 concat": (768, 80, 200, 256, 1, 1),
    "s3 in256": (256, 40, 100, 160, 3, 1), "s3 in512": (512, 40, 100, 160, 3, 1), "s3": (160, 40, 100, 160, 3, 1),
    "s3 concat1056": (1056, 40, 100, 512, 1, 1), "s3 concat1312": (1312, 40, 100, 512, 1, 1),
    "s4 in512": (512, 20, 50, 192, 3, 1), "s4 in768": (768, 20, 50, 192, 3, 1), "s4": (192, 20, 50, 192, 3, 1),
    "s4 concat1472": (1472, 20, 50, 768, 1, 1), "s4 concat1728": (1728, 20, 50, 768, 1, 1),
    "s5 in768": (768, 10, 25, 224, 3, 1), "s5 in1024": (1024, 10, 25, 224, 3, 1), "s5": (224, 10, 25, 224, 3, 1),
    "s5 concat1888": (1888, 10, 25, 1024, 1, 1), "s5 concat2144": (2144, 10, 25, 1024, 1, 1),
}
ODD_SHAPES = [  # (B, Cin, H, W, Co, kernel, stride)
    (2, 3, 33, 47, 64, 3, 2),  # the stem's first conv (Cin 3 padded to 32), odd planes
    (1, 64, 20, 50, 300, 3, 1),  # Co = 300: two tiles of 160
    (2, 96, 9, 13, 40, 1, 1),
    (1, 128, 17, 19, 72, 3, 2),
    (1, 32, 5, 7, 8, 1, 2),  # a 1x1 stride-2 conv: the strided box with k = 1
    (1, 40, 7, 9, 24, 3, 1),  # Cin 40 -> 64: a slice half past C
]


# ------------------------------------------------------------------ the plan
def _covered(plan):
    """Every output pixel lies in some tile; returns the count of tile rows."""
    if plan.mode == c8.FLAT:
        last_q = (plan.B - 1) * plan.QV + (plan.Ho - 1) * plan.Wp + plan.Wo - 1
        return last_q < plan.tiles_m * c8.TILE_M
    return plan.tiles_w * plan.tw >= plan.Wo and plan.tiles_h * plan.th >= plan.Ho


@pytest.mark.parametrize("label", list(V99_SHAPES))
def test_plan_at_the_flagship_shapes(label):
    C, H, W, Co, k, s = V99_SHAPES[label]
    plan = c8.conv_plan(VIEWS, C, H, W, Co, k, s)
    assert plan.mode == (c8.FLAT if s == 1 else c8.RECT)
    assert plan.bn in c8.TILE_N_CHOICES and plan.tiles_n * plan.bn >= Co
    assert plan.tiles_n * plan.bn - Co <= c8.MAX_PADDED_N * Co
    assert plan.Cp == C if C % 32 == 0 else plan.Cp == 32
    assert plan.slices == k * k * plan.Cp // 32
    assert (plan.splits - 1) * plan.per_split < plan.slices <= plan.splits * plan.per_split
    assert plan.per_split >= c8.MIN_SLICES_PER_SPLIT or plan.splits == 1
    assert _covered(plan)
    clocks = c8.modelled_clocks(plan.tiles_m, Co, plan.slices, plan.bn, plan.splits, _unit(plan))[0]
    assert clocks == _best_modelled(plan), label  # the time model's least, over every width and split
    if plan.mode == c8.RECT:
        assert plan.tw * plan.th == c8.TILE_M and plan.tiles_w * plan.tw == plan.Wo and plan.tiles_h * plan.th == plan.Ho
    assert len(plan.kernel_args(1, True)) == 30 and len(plan.quant_args()) == 15
    assert 2 <= plan.stages <= c8.MAX_STAGES and plan.stages * plan.stage_bytes <= c8.RING_BYTES[plan.bn]


def _unit(plan):
    return plan.group if plan.mode == c8.FLAT and plan.k == 3 else 1


def _best_modelled(plan):
    """The least modelled clocks over every tile width whose ring fits and
    every split of at least MIN_SLICES_PER_SPLIT slices, for plan's shape."""
    best = None
    for bn in c8.TILE_N_CHOICES:
        pipe = c8.ring(plan.mode, plan.k, plan.Wp, bn)
        if pipe is None or -(-plan.Co // bn) * bn - plan.Co > c8.MAX_PADDED_N * plan.Co:
            continue
        unit = pipe[0] if plan.mode == c8.FLAT and plan.k == 3 else 1
        for sp in range(1, max(1, min(c8.MAX_SPLITS, plan.slices // max(c8.MIN_SLICES_PER_SPLIT, unit))) + 1):
            clocks = c8.modelled_clocks(plan.tiles_m, plan.Co, plan.slices, bn, sp, unit)[0]
            best = clocks if best is None else min(best, clocks)
    return best


def test_plan_at_the_deep_stages():
    """Stage 4's 3x3 (36 of a forward's 99 convs) runs three tile columns of
    64 channels, one full wave of blocks, unsplit; its wider-input convs
    split K (the partial sums reduced in L2) where the model says so; a
    given tile width is kept."""
    s4 = c8.conv_plan(VIEWS, 192, 20, 50, 192, 3, 1)
    assert (s4.tiles_m, s4.bn, s4.tiles_n, s4.splits) == (50, 64, 3, 1)  # (6 x 21 - 1) x 51 rows of the padded grid
    assert s4.blocks >= c8.SM_COUNT and s4.workspace_ints == 0
    s4in = c8.conv_plan(VIEWS, 768, 20, 50, 192, 3, 1)
    assert s4in.splits > 1 and s4in.per_split % s4in.group == 0
    assert s4in.workspace_ints == s4in.tiles_m * s4in.tiles_n * c8.TILE_M * s4in.bn
    assert c8.conv_plan(VIEWS, 224, 10, 25, 224, 3, 1).tiles_m == 14
    fixed = c8.conv_plan(VIEWS, 192, 20, 50, 192, 3, 1, 192)
    assert fixed.bn == 192 and fixed.tiles_n == 1


@pytest.mark.parametrize("Co,bn,tiles", [(8, 64, 1), (40, 64, 1), (64, 64, 1), (72, 128, 1), (192, 192, 1),
                                         (300, 160, 2), (512, 256, 2), (768, 256, 3), (1024, 256, 4)])
def test_tile_width(Co, bn, tiles):
    """The width that pads Co least (the fallback when no ring fits)."""
    assert c8.tile_n(Co) == bn and -(-Co // bn) == tiles


def test_plan_refuses_what_the_kernel_does_not_take():
    for bad in [(1, 8, 5, 5, 8, 5, 1), (1, 8, 5, 5, 8, 3, 3), (0, 8, 5, 5, 8, 3, 1)]:
        with pytest.raises(ValueError):
            c8.conv_plan(*bad)


def test_tensor_map_args():
    """The rect mode's TMA box over the channels-last rows, innermost
    dimension first (element stride 2 in both pixel dimensions); the flat
    mode reads by bulk copies and has none."""
    rect = c8.conv_plan(VIEWS, 3, 320, 800, 64, 3, 2)
    a = c8.tensor_map_args(rect)
    assert (rect.tw, rect.th) == (16, 8)
    assert a == {"dims": [32, 800, 320, 6], "strides": [32, 800 * 32, 320 * 800 * 32], "box": [32, 32, 16, 1],
                 "element_strides": [1, 2, 2, 1]}
    assert all(s % 16 == 0 for s in a["strides"])  # TMA: global strides in multiples of 16 bytes
    assert all(0 < x <= 256 for x in a["box"]) and a["box"][0] == 32  # the 32-byte swizzle's span
    assert len(c8._map_array(a)) == 20
    with pytest.raises(ValueError):
        c8.tensor_map_args(c8.conv_plan(VIEWS, 192, 20, 50, 192, 3, 1))


def test_flat_layout_rows():
    """The flat mode's planes: rows of the padded grid, one zero pixel past
    the last row, and room for the last tile's 2 (W + 1) + 2 row shift."""
    p = c8.conv_plan(VIEWS, 192, 20, 50, 192, 3, 1)
    assert (p.q_wp, p.q_row0, p.q_vstride) == (51, 52, 21 * 51)
    assert p.q_rows == (1 + 6 * 21) * 51 + 1 and p.pads == 7 * 51 + 6 * 20 + 1
    assert p.rows_alloc == max(p.q_rows, p.tiles_m * 128 + 2 * 51 + 2)
    assert (p.plane_stride, p.row_stride) == (p.rows_alloc, 1) and p.rows_bytes == p.rows_alloc * 192
    assert p.row_offset(3, 7) == 16 * (3 * p.rows_alloc + 7)
    assert p.group == 9 and p.halo == 128 + 2 * 51 + 2  # a chunk's 9 taps from one halo of rows
    one = c8.conv_plan(VIEWS, 768, 80, 200, 256, 1, 1)
    assert (one.pads, one.q_rows, one.rows_alloc, one.blocked) == (0, 6 * 80 * 200, one.tiles_m * 128, True)
    assert one.row_offset(5, 130) == (1 * 48 + 5) * 2048 + 2 * 16  # 128-row blocks, each block's planes in turn
    rect = c8.conv_plan(VIEWS, 64, 160, 400, 128, 3, 2)
    assert (rect.plane_stride, rect.row_stride, rect.rows_alloc) == (1, 64 // 16, 6 * 160 * 400)


# ------------------------------------------------- an emulation of the kernel
def tma_load(buf, m, coords):
    """cuTensorMapEncodeTiled's tiled load of ``m`` (``tensor_map_args``) at
    ``coords`` from the byte array ``buf``: box[d] / element_strides[d]
    elements along each dimension d > 0 at coords[d] + i * stride, the
    element stride of dimension 0 ignored; out-of-bounds elements zero. ->
    rows of box[0] bytes, dimension 1 fastest."""
    rank = len(m["dims"])
    counts = [m["box"][0]] + [m["box"][d] // m["element_strides"][d] for d in range(1, rank)]
    grids = np.meshgrid(*[coords[d] + np.arange(counts[d]) * (1 if d == 0 else m["element_strides"][d])
                          for d in range(rank)], indexing="ij")
    inside = np.ones(grids[0].shape, bool)
    offset = grids[0].astype(np.int64)
    for d in range(rank):
        inside &= (grids[d] >= 0) & (grids[d] < m["dims"][d])
        if d > 0:
            offset = offset + grids[d].astype(np.int64) * m["strides"][d - 1]
    vals = np.where(inside, buf[np.where(inside, offset, 0)], 0)
    return vals.transpose(*range(rank - 1, -1, -1)).reshape(-1, m["box"][0])


def quantized_rows(plan, xi, rng):
    """The quantisation pass's output for int8 xi (B, C, H, W) as bytes
    (``rows_bytes``, laid out by ``row_offset``): the data pixels at their
    rows; the zero pixels at the rows its pad blocks write (the kernel's
    arithmetic), which must be exactly the rows left over below q_rows; the
    rows past q_rows never written (random bytes here: only junk outputs may
    read them)."""
    B, C, H, W = xi.shape
    rows = rng.randint(-128, 128, (plan.rows_alloc, plan.Cp)).astype(np.int64)
    written = np.zeros(plan.rows_alloc, bool)
    b, ih, iw = np.meshgrid(np.arange(B), np.arange(H), np.arange(W), indexing="ij")
    r = (plan.q_row0 + b * plan.q_vstride + ih * plan.q_wp + iw).ravel()
    rows[r, :] = 0
    rows[r, :C] = xi.transpose(0, 2, 3, 1).reshape(-1, C)
    written[r] = True
    pads = []
    for i in range(plan.pads):  # quantize_act_kernel's pad blocks
        j = i - (B + 1) * plan.q_wp
        if j < 0:
            pads.append((i // plan.q_wp) * (H + 1) * plan.q_wp + i % plan.q_wp)
        elif j < B * H:
            pads.append((1 + (j // H) * (H + 1) + j % H) * plan.q_wp)
        else:
            pads.append((1 + B * (H + 1)) * plan.q_wp)
    assert len(set(pads)) == plan.pads and not written[pads].any()
    rows[pads, :] = 0
    written[pads] = True
    assert written[:plan.q_rows].all() and not written[plan.q_rows:].any()
    qa = plan.quant_args()
    assert qa[10] * 32 * c8.QUANT_PIXELS >= B * H * W * plan.Cp  # its data blocks cover every pixel's channels
    out = np.zeros(plan.rows_bytes, np.int64)
    for j in range(plan.Cp // 16):
        for row in range(plan.rows_alloc):
            o = plan.row_offset(j, row)
            out[o:o + 16] = rows[row, 16 * j:16 * j + 16]
    return out


def emulate(plan, xi, wi, rng):
    """What conv_int8_kernel computes with ``plan``: each stage's copies into
    its ring slot (A: a flat 3x3 conv's halo of two planes, a 1x1 conv's
    blocked planes, a rect conv's strided boxes; B: the stage's weight
    slices), each slice's product read at its descriptor's rows, each split's
    partial sums added, each output written once -> the int32 sums (B, Co,
    Ho, Wo)."""
    buf = quantized_rows(plan, xi, rng)
    wq = c8.pack_weight(torch.from_numpy(wi), plan.Cp)
    wt = c8.tile_weight(wq, plan.bn).numpy().astype(np.int64).reshape(-1)
    out = np.zeros((plan.B, plan.Co, plan.Ho, plan.Wo), np.int64)
    written = np.zeros(out.shape, np.int64)
    HoWo, B_BYTES, taps = plan.Ho * plan.Wo, plan.bn * 32, plan.k * plan.k
    halo_pad = -(-plan.halo // 8) * 8
    for tm in range(plan.tiles_m):
        if plan.mode == c8.FLAT:
            q0 = tm * c8.TILE_M
        else:
            per_view = plan.tiles_h * plan.tiles_w
            b, r = divmod(tm, per_view)
            oh0, ow0 = (r // plan.tiles_w) * plan.th, (r % plan.tiles_w) * plan.tw
        for tn in range(plan.tiles_n):
            acc = np.zeros((c8.TILE_M, plan.bn), np.int64)
            for split in range(plan.splits):
                s_begin = split * plan.per_split
                n_iter = min(plan.per_split, plan.slices - s_begin)
                for st in range(-(-n_iter // plan.group)):
                    first = s_begin + st * plan.group
                    n_sl = min(plan.group, n_iter - st * plan.group)
                    chunk, tap0 = divmod(first, taps)
                    if plan.mode == c8.FLAT and plan.k == 3:  # two copies: the planes' rows q0 + kh0 Wp ..
                        start = q0 + (tap0 // 3) * plan.Wp
                        assert start + plan.halo <= plan.rows_alloc
                        halo = np.zeros((2, halo_pad, 16), np.int64)
                        for h in range(2):
                            o = 16 * ((2 * chunk + h) * plan.rows_alloc + start)
                            halo[h, :plan.halo] = buf[o:o + 16 * plan.halo].reshape(plan.halo, 16)
                    elif plan.mode == c8.FLAT:  # one copy: n_sl chunks of the tile's block
                        o = (tm * plan.chunks + first) * 4096
                        blocked = buf[o:o + n_sl * 4096].reshape(n_sl, 2, 128, 16)
                    o = (tn * plan.slices + first) * B_BYTES  # one copy: the stage's weight slices
                    bstage = wt[o:o + n_sl * B_BYTES].reshape(n_sl, 2, plan.bn, 16)
                    for j in range(n_sl):
                        s = first + j
                        c, tap = divmod(s, taps)
                        kh, kw = divmod(tap, plan.k)
                        if plan.mode == c8.FLAT and plan.k == 3:
                            r0 = (kh - tap0 // 3) * plan.Wp + kw
                            assert r0 + 128 <= plan.halo
                            a = np.concatenate([halo[0, r0:r0 + 128], halo[1, r0:r0 + 128]], axis=1)
                        elif plan.mode == c8.FLAT:
                            a = np.concatenate([blocked[j, 0], blocked[j, 1]], axis=1)
                        else:
                            a = tma_load(buf, c8.tensor_map_args(plan), [c * 32, ow0 * plan.stride - plan.pad + kw,
                                                                         oh0 * plan.stride - plan.pad + kh, b])
                        bt = np.concatenate([bstage[j, 0], bstage[j, 1]], axis=1)
                        acc += a @ bt.T
            for m in range(c8.TILE_M):  # the epilogue's pixel table
                if plan.mode == c8.FLAT:
                    vb, r = divmod(q0 + m, plan.QV)
                    oh, ow = divmod(r, plan.Wp)
                    if not (vb < plan.B and oh < plan.Ho and ow < plan.Wo):
                        continue
                else:
                    vb, oh, ow = b, oh0 + m // plan.tw, ow0 + m % plan.tw
                    if not (oh < plan.Ho and ow < plan.Wo):
                        continue
                pix = vb * plan.Co * HoWo + oh * plan.Wo + ow
                n = np.arange(tn * plan.bn, min(plan.Co, (tn + 1) * plan.bn))
                np.add.at(out.reshape(-1), pix + n * HoWo, acc[m, :len(n)])
                np.add.at(written.reshape(-1), pix + n * HoWo, 1)
    assert (written == 1).all(), "an output written other than once"
    return out


EMULATED = ODD_SHAPES + [(2, 64, 6, 9, 64, 3, 1), (1, 64, 20, 50, 192, 3, 1), (1, 224, 10, 25, 224, 3, 1),
                        (1, 32, 3, 700, 64, 3, 1)]  # W + 1 = 701: one kernel row's taps a stage (group 3)


@pytest.mark.parametrize("B,C,H,W,Co,k,s", EMULATED)
def test_emulated_kernel_matches_petr_tpu(B, C, H, W, Co, k, s):
    """The plan's arithmetic, end to end: the emulated kernel's int32 sums
    equal XLA's int8 conv (petr_tpu's ``_int8_forward``) and the plain
    version's, bit for bit, whatever the rows past the layout hold."""
    rng = np.random.RandomState(C + H + Co)
    xi = rng.randint(-127, 128, (B, C, H, W)).astype(np.int8)
    wi = rng.randint(-127, 128, (Co, C, k, k)).astype(np.int8)
    plan = c8.conv_plan(B, C, H, W, Co, k, s)
    got = emulate(plan, xi, wi, rng)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xi.transpose(0, 2, 3, 1)), jnp.asarray(wi.transpose(2, 3, 1, 0)), (s, s), [(k // 2, k // 2)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got, want)
    ref = c8.conv_int8_accumulate_reference(torch.from_numpy(xi), torch.from_numpy(wi), s)
    np.testing.assert_array_equal(got, ref.numpy())


def test_emulation_sees_every_branch():
    """The emulated shapes take every branch: split and unsplit, flat
    (padded and not) and rect, more than one tile column."""
    plans = [c8.conv_plan(*shape) for shape in EMULATED]
    assert {p.splits > 1 for p in plans} == {True, False}
    assert {p.mode for p in plans} == {c8.FLAT, c8.RECT}
    assert any(p.pads for p in plans) and any(p.mode == c8.FLAT and not p.pads for p in plans)
    assert any(p.tiles_n > 1 for p in plans)
    assert {p.group for p in plans} == {9, 3, 4}


# --------------------------------------------------------------- the weight
@pytest.mark.parametrize("C,k", [(3, 3), (40, 3), (64, 1), (160, 3)])
def test_packed_weight_order(C, k):
    """(Co, k, k, Cp): K slice s holds tap s // (Cp / 32)'s channels
    32 (s % (Cp / 32)) ..; zeros past C; the tiles hold slice s of output
    channels t bn .. as two 16-byte halves; both invert to OIHW."""
    rng = np.random.RandomState(C)
    w = torch.from_numpy(rng.randn(24, C, k, k).astype(np.float32))
    mul = torch.from_numpy(rng.uniform(0.5, 2.0, 24).astype(np.float32))
    wi, sw = c8.quantize_weight(w, mul)
    wq, sw2 = c8.prepare_weight(w, mul)
    Cp = c8.padded_channels(C)
    assert wq.shape == (24, k, k, Cp) and wq.dtype == torch.int8 and wq.is_contiguous()
    assert torch.equal(sw, sw2)
    flat = wq.reshape(24, -1)
    for s in range(k * k * Cp // 32):
        tap, c0 = divmod(s, Cp // 32)
        kh, kw = divmod(tap, k)
        for j in range(32):
            c = c0 * 32 + j
            want = wi[:, c, kh, kw] if c < C else torch.zeros(24, dtype=torch.int8)
            assert torch.equal(flat[:, s * 32 + j], want)
    assert torch.equal(c8.unpack_weight(wq, C), wi)
    for bn in (64, 160):
        wt = c8.tile_weight(wq, bn)
        assert wt.shape == (1, k * k * Cp // 32, 2, bn, 16) and wt.is_contiguous()
        for s in range(k * k * Cp // 32):  # the kernel's slice s: chunk s // (k k), tap s % (k k)
            chunk, tap = divmod(s, k * k)
            want = flat[:, (tap * (Cp // 32) + chunk) * 32:][:, :32]
            assert torch.equal(wt[0, s, :, :24].permute(1, 0, 2).reshape(24, 32), want)
        assert not wt[0, :, :, 24:].any()
        assert torch.equal(c8.untile_weight(wt, 24, C), wi)


def _conv(C=16, Co=24, k=3, s=1, seed=0):
    rng = np.random.RandomState(seed)
    port = ConvBNReLU("c", C, Co, k, s, quant="int8")
    with torch.no_grad():
        port[0].weight.copy_(torch.from_numpy(rng.randn(Co, C, k, k).astype(np.float32) * 0.2))
        port[1].running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, Co).astype(np.float32)))
        port[1].running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, Co).astype(np.float32)))
        port[1].weight.copy_(torch.from_numpy(rng.normal(1, 0.2, Co).astype(np.float32)))
        port[0].act_amax.fill_(2.5)
    x = torch.from_numpy(rng.randn(2, C, 9, 11).astype(np.float32))
    return port, x


def _expected(port, x):
    """The int8 conv on freshly prepared operands (no cache)."""
    mul = port[1].weight * torch.rsqrt(port[1].running_var + port[1].eps)
    add = port[1].bias - port[1].running_mean * mul
    return c8.conv_int8_bn_act_plain(x, port[0].weight, mul, add, port[0].act_amax, port[0].stride[0], True)


def test_int8_operands_prepared_once(monkeypatch):
    port, x = _conv()
    calls = []
    prepare = layers.prepare_operands
    monkeypatch.setattr(layers, "prepare_operands", lambda *a: calls.append(1) or prepare(*a))
    with torch.no_grad():
        first = port(x)
        for _ in range(3):
            assert torch.equal(port(x), first)
    with torch.inference_mode():
        assert torch.equal(port(x), first)
    assert len(calls) == 1
    assert torch.equal(first, _expected(port, x))
    assert "act_amax" not in port.state_dict() and not any("int8" in k for k in port.state_dict())


@pytest.mark.parametrize("change", ["weight", "bn_weight", "bn_bias", "running_mean", "running_var", "act_amax",
                                    "load_state_dict", "optimizer_step"])
def test_int8_operands_never_stale(change):
    """Any change after the switch to int8 changes the output: the operands
    are prepared again, and equal freshly prepared ones."""
    port, x = _conv(seed=3)
    with torch.no_grad():
        before = port(x)
        conv, bn = port[0], port[1]
        if change == "weight":
            conv.weight.mul_(1.5)
        elif change == "bn_weight":
            bn.weight.mul_(0.5)
        elif change == "bn_bias":
            bn.bias.add_(1.0)
        elif change == "running_mean":
            bn.running_mean.add_(0.5)
        elif change == "running_var":
            bn.running_var.mul_(4.0)
        elif change == "act_amax":
            conv.act_amax.fill_(1.0)
        elif change == "load_state_dict":
            other, _ = _conv(seed=4)
            port.load_state_dict(other.state_dict())
    if change == "optimizer_step":
        opt = torch.optim.SGD(port.parameters(), lr=0.5)
        for p in port.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
    with torch.no_grad():
        after = port(x)
    assert not torch.equal(after, before), change
    assert torch.equal(after, _expected(port, x)), change


def test_int8_operands_never_stale_after_assigned_weights():
    """``load_state_dict(assign=True)`` twice, the second time with new
    tensors at the first ones' addresses and version counters (numpy arrays
    shared, then rewritten): the new tensor objects prepare the operands
    again."""
    port, x = _conv(seed=6)
    arrays = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    port.load_state_dict({k: torch.from_numpy(a) for k, a in arrays.items()}, assign=True)
    with torch.no_grad():
        before = port(x)
    for k, a in arrays.items():
        a *= 2.0 if k.endswith("running_var") else -0.5
    second = {k: torch.from_numpy(a) for k, a in arrays.items()}
    assert all(t._version == 0 for t in second.values())
    port.load_state_dict(second, assign=True)
    assert port[0].weight.data_ptr() == arrays["c/conv.weight"].ctypes.data
    with torch.no_grad():
        after = port(x)
    assert not torch.equal(after, before)
    assert torch.equal(after, _expected(port, x))


def test_drop_int8_operands_after_a_write_through_data():
    """A write through ``.data`` bypasses the version counter; dropping the
    operands prepares them again."""
    port, x = _conv(seed=5)
    with torch.no_grad():
        before = port(x)
    port[0].weight.data.mul_(2.0)
    port[0].drop_int8_operands()
    with torch.no_grad():
        after = port(x)
    assert not torch.equal(after, before) and torch.equal(after, _expected(port, x))


def test_int8_detector_served_after_a_weight_change(tmp_path):
    """tiny_debug int8: the eager serving step after a weight and a BN
    statistic change equals a freshly built detector with those weights,
    and an artifact exported before the change, replayed on the changed
    weights, equals it bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_config("tiny_debug")
        model = build_detector(cfg, seed=0, device="cpu")
        scales = calibrate_detector(cfg, model, [synthetic_batch(cfg, 1, 0)])
        inputs = [synthetic_batch(cfg, 1, 1)[k] for k in ("images", "img2lidar", "img_hw")]
        fn = make_serving_fn(cfg, model, "cpu", quant_scales=scales)
        before = fn(*inputs)
        path = str(tmp_path / "int8.petrx")
        save_artifact(path, export_serving(cfg, model), cfg, model, batch_size=1, embed_params=False)
        convs = quant_convs(model)
        name = sorted(convs)[5]
        norm = model.get_submodule(name.rsplit("/", 1)[0] + "/norm")
        with torch.no_grad():
            convs[name].weight.mul_(-1.0)
            norm.running_var.mul_(3.0)
        after = fn(*inputs)
        assert not np.array_equal(after["scores"], before["scores"])
        fresh = build_detector(cfg, seed=0, device="cpu")
        fresh.load_state_dict(model.state_dict())
        want = make_serving_fn(cfg, fresh, "cpu", quant_scales=scales)(*inputs)
        replay, _ = load_artifact(path, list(model.state_dict().values()))
        got = replay(*inputs)
        for key, v in want.items():
            np.testing.assert_array_equal(after[key], v, err_msg=key)
            np.testing.assert_array_equal(np.asarray(got[key]), v, err_msg=key)
    finally:
        torch.set_num_threads(threads)


def test_plan_dataclass_is_the_kernel_struct():
    """``kernel_args`` lists ConvPlan's first 23 fields in the struct's
    order, then the pipeline's fields, the output kind and ReLU."""
    names = [f.name for f in dataclasses.fields(c8.ConvPlan)][:23]
    plan = c8.conv_plan(2, 64, 6, 9, 64, 3, 1)
    assert plan.kernel_args(0, False)[:23] == [getattr(plan, n) for n in names]
    assert plan.kernel_args(2, True)[23:] == [plan.rows_alloc, plan.group, plan.halo, plan.stages,
                                              plan.stage_bytes, 2, 1]


@pytest.mark.parametrize("embed", [True, False], ids=["embedded", "external"])
def test_int8_artifact_takes_prepared_operands(embed, tmp_path):
    """tiny_debug int8: the exported program quantises no weight. Every call
    of the int8 op reads its weight tiles, sa, scale and add straight from
    the program's inputs (constants when the weights are embedded; else
    inputs after the weights, which the runtime prepares once at load, as
    ``meta["int8_operands"]`` says); the replay equals the eager step bit for
    bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_config("tiny_debug")
        model = build_detector(cfg, seed=0, device="cpu")
        scales = calibrate_detector(cfg, model, [synthetic_batch(cfg, 1, 0)])
        inputs = [synthetic_batch(cfg, 1, 2)[k] for k in ("images", "img2lidar", "img_hw")]
        want = make_serving_fn(cfg, model, "cpu", quant_scales=scales)(*inputs)
        ep = export_serving(cfg, model, embed_params=embed)
        calls = [n for n in ep.graph.nodes if n.op == "call_function" and "conv_int8_bn_act" in str(n.target)]
        assert len(calls) == len(quant_convs(model))
        for node in calls:
            assert all(a.op == "placeholder" for a in node.args[1:5]), node
        path = str(tmp_path / "int8.petrx")
        meta = save_artifact(path, ep, cfg, model, batch_size=1, embed_params=embed)
        specs = meta["int8_operands"].get("program.pt2", [])
        assert len(specs) == (0 if embed else len(calls))
        fn, _ = load_artifact(path, None if embed else list(model.state_dict().values()))
        got = fn(*inputs)
        for key, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[key]), v, err_msg=key)
    finally:
        torch.set_num_threads(threads)


def test_int8_conv_refuses_a_trace_without_prepared_operands():
    port, x = _conv()
    with pytest.raises(Exception, match="prepared once"):
        torch.export.export(port, (x,), strict=False)
