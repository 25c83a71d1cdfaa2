"""Host-side logic of the bf16 tensor-core kernels (K5 and K2), on the CPU.

The kernels themselves run only on the card (``test_torch_port_cuda.py``);
what their wrappers compute around them is checked here: K5's output tile
(``conv_tile``) and split of K (``conv_split``), its weight repack against
petr_tpu's ``(9 * C, Co)`` order,
the implicit GEMM the kernel walks (tiles, 16-channel chunks, nine shifted
taps of a zero-padded halo) written out in numpy against petr_tpu's
``_xla_reference`` and its Pallas kernel in interpret mode, and K2's check
of which inputs its 16-byte copies may read in place.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from petr_tpu.ops.pallas.conv3x3 import _conv3x3_raw, _xla_reference
from petr_tpu_torch.ops import conv3x3
from petr_tpu_torch.ops import cross_attention as ca

CK = conv3x3.CHUNK_CHANNELS  # input channels per chunk of the bf16 kernel


@pytest.mark.parametrize("H,W", [(80, 200), (40, 100), (20, 50), (10, 25)])
def test_conv_tile_at_the_vovnet_planes(H, W):
    """5 x 25 tiles: 125 of the 128 pixel slots of a block are used."""
    assert conv3x3.conv_tile(H, W) == (5, 25)


@pytest.mark.parametrize("H,W", [(1, 1), (1, 1000), (1000, 1), (13, 7), (3, 130), (320, 800), (7, 129), (64, 64)])
def test_conv_tile_covers_the_plane_with_nearly_the_fewest_blocks(H, W):
    th, tw = conv3x3.conv_tile(H, W)
    P = conv3x3.TILE_PIXELS
    assert 1 <= th and 1 <= tw and th * tw <= P
    tiles = math.ceil(H / th) * math.ceil(W / tw)
    fewest = min(math.ceil(H / a) * math.ceil(W / (P // a)) for a in range(1, P + 1))
    assert tiles <= 1.03 * fewest
    # no tile row or column is wholly past the plane
    assert (math.ceil(H / th) - 1) * th < H and (math.ceil(W / tw) - 1) * tw < W


@pytest.mark.parametrize("label,shape,split", [
    ("s2", (128, 80, 200, 128), 1), ("s3", (160, 40, 100, 160), 1), ("s4", (192, 20, 50, 192), 3),
    ("s4 in768", (768, 20, 50, 192), 4), ("s5", (224, 10, 25, 224), 3), ("s5 in1024", (1024, 10, 25, 224), 11),
])
def test_split_k_at_the_vovnet_shapes(label, shape, split):
    """6 views on 132 SMs: the planes of 20x50 and 10x25 give 144 and 48
    blocks, too few for the card, so their chunks are split."""
    C, H, W, Co = shape
    th, tw = conv3x3.conv_tile(H, W)
    blocks = math.ceil(H / th) * math.ceil(W / tw) * math.ceil(Co / conv3x3.TILE_CHANNELS) * 6
    assert conv3x3.conv_split(blocks, math.ceil(C / CK), 132) == split


@pytest.mark.parametrize("blocks,chunks", [(1, 1), (1, 3), (1, 4), (2, 13), (48, 64), (263, 80), (264, 80), (5000, 2)])
def test_split_k_bounds(blocks, chunks):
    split = conv3x3.conv_split(blocks, chunks, 132)
    assert 1 <= split <= max(1, chunks // 4)  # at least 4 chunks per share
    if blocks >= 2 * 132:
        assert split == 1
    assert blocks * (split - 1) < 4 * 132  # no more shares than bring the grid to ~4 blocks per SM


@pytest.mark.parametrize("C", [13, 16, 40])
def test_repack_is_petr_tpu_weight_order(C):
    """The repacked weight of output channel o, read along K, is column o of
    petr_tpu's ``wf = weight.reshape(9 * C, Co)`` (HWIO), zero past C."""
    Co = 24
    w_hwio = np.random.RandomState(C).randn(3, 3, C, Co).astype(np.float32)
    w_oihw = torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy())
    wr = conv3x3.repack_weight(w_oihw, torch.float32)
    Cp = wr.shape[3]
    assert wr.shape == (Co, 3, 3, Cp) and Cp % 8 == 0 and C <= Cp < C + 8
    assert (wr[..., C:] == 0).all()
    wf = w_hwio.reshape(9 * C, Co)
    np.testing.assert_array_equal(wr[..., :C].reshape(Co, 9 * C).numpy().T, wf)
    assert conv3x3.repack_weight(w_oihw).dtype == torch.bfloat16


def implicit_gemm(x, weight, mul, add, relu):
    """The bf16 kernel's walk in float64 numpy: x (B, C, H, W), weight OIHW.
    Output tiles from ``conv_tile``; per tile, K = chunks of CK channels x 9
    taps, each tap a shifted view of the tile's zero-padded halo, against the
    repacked weight's rows; then the fp32 epilogue."""
    B, C, H, W = x.shape
    wr = conv3x3.repack_weight(torch.from_numpy(weight), torch.float32).numpy().astype(np.float64)
    Co, Cp = wr.shape[0], wr.shape[3]
    th, tw = conv3x3.conv_tile(H, W)
    xp = np.zeros((B, Cp, H + 2 + th, W + 2 + tw))  # zeros outside the plane and past C
    xp[:, :C, 1:H + 1, 1:W + 1] = x
    out = np.full((B, Co, H, W), np.nan)
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            acc = np.zeros((B, Co, th, tw))
            for c0 in range(0, Cp, CK):
                halo = xp[:, c0:c0 + CK, y0:y0 + th + 2, x0:x0 + tw + 2]
                for t in range(9):
                    kh, kw = divmod(t, 3)
                    a = halo[:, :, kh:kh + th, kw:kw + tw]  # (B, chunk, th, tw)
                    acc += np.einsum("bcyx,oc->boyx", a, wr[:, kh, kw, c0:c0 + a.shape[1]])
            h, w = min(th, H - y0), min(tw, W - x0)
            out[:, :, y0:y0 + h, x0:x0 + w] = acc[:, :, :h, :w]
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
    rng = np.random.RandomState(3)
    x = rng.randn(2, 17, 6, 11).astype(np.float32)
    weight = rng.randn(5, 17, 3, 3).astype(np.float32)
    want = conv3x3.conv3x3_bn_relu_reference(torch.from_numpy(x), torch.from_numpy(weight), None, None, False)
    got = implicit_gemm(x, weight, None, None, False)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5 * np.abs(want.numpy()).max())


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
