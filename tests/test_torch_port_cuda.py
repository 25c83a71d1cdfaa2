"""The hand-written CUDA kernels against their plain PyTorch versions, on the card:
K1 (the forward, with and without dropout), K2 (the backward's dK/dV and dQ
kernels), both with a shard's hash offsets, K3 (the lse cotangent through
the autograd Function), K4 (DCNv2,
forward and the gradients through its Function), K5 (the fused conv3x3) and
K6 (the int8 conv with int32 sums, bf16 and fp32 out, at the classes of V-99's
shapes and odd ones, every split and store branch, the ties case); K1, K2, K4 and K5 in
both variants, bf16 on the tensor cores and fp32 on the CUDA cores. The bf16 K1 and K4 are also held to their rounding floors (the plain
version rounding to bf16 where the kernel does) under KERNEL_TOL. Also the
measurement tools' FLOP count, equal on the kernel and the plain route
(``utils.mfu.count_flops``), and the native loader held to PIL.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False. The card's machine has no JAX, so this file imports none and runs
without the repository's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py
"""

import contextlib

import pytest
import torch

from petr_tpu_torch.ops import cross_attention as ca

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, H, Q, L, D, dtype, seed, masked_row=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # (B, H, ., D) views of (B, ., H, D) buffers, as MultiheadAttention passes them
    q = torch.randn(B, Q, H, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    k = torch.randn(B, L, H, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    v = torch.randn(B, L, H, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    mask = torch.rand(B, L, generator=gen, device="cuda") < 0.25
    if masked_row:
        mask[-1] = True
    return q, k, v, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "B,H,Q,L,D",
    [(1, 8, 900, 6000, 32), (2, 4, 37, 61, 16), (2, 2, 130, 520, 64), (1, 1, 1, 1, 32),
     (1, 8, 900, 12000, 32), (2, 8, 900, 12000, 32),  # PETRv2's 12 views, at B = 1 and 2
     (4, 4, 64, 960, 32)],  # the synthetic recipes' decoder (batch 4, 6 views of 8 x 20 tokens)
)
def test_kernel_matches_plain_version(cuda, dtype, B, H, Q, L, D):
    q, k, v, mask = _inputs(B, H, Q, L, D, dtype, seed=Q + L, masked_row=B > 1)
    counter = "LAUNCHES" if dtype == torch.bfloat16 else "LAUNCHES_FP32"
    before = getattr(ca, counter)
    out, lse = ca.flash_cross_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert getattr(ca, counter) == before + 1
    ref_out, ref_lse = ca.flash_cross_attention_reference(q, k, v, mask)
    assert out.dtype == dtype and out.shape == (B, H, Q, D) and lse.shape == (B, H, Q)
    atol, rtol = (1e-4, 0.0) if dtype == torch.float32 else (2e-3, 1e-2)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol, rtol=rtol)
    live = ref_lse < 1e29
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-3, rtol=0)
    if B > 1:
        assert (out[-1] == 0).all() and (lse[-1] == 1e30).all()


def test_kernel_without_mask_and_contiguous_inputs(cuda):
    q, k, v, _ = _inputs(1, 2, 100, 300, 32, torch.float32, seed=1)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, lse = ca.flash_cross_attention(q, k, v)
    ref_out, ref_lse = ca.flash_cross_attention_reference(q, k, v)
    torch.testing.assert_close(out, ref_out, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mask_shape"])
def test_kernel_refuses_what_it_does_not_take(cuda, bad):
    q, k, v, mask = _inputs(1, 2, 8, 16, 32, torch.float32, seed=2)
    if bad == "head_dim":
        q, k, v = (t[..., :24] for t in (q, k, v))
    elif bad == "dtype":
        q = q.half()
    else:
        mask = mask[:, :8]
    with pytest.raises(ValueError):
        ca.flash_cross_attention(q, k, v, mask)


def test_tiny_detector_on_the_card_matches_the_cpu(cuda):
    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.serve import build_detector

    cfg = get_config("tiny_debug")  # fp32
    N, (H, W) = cfg.data.num_views, cfg.data.image_size
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(2, N, H, W, 3, generator=gen)
    img2lidar = torch.eye(4).expand(2, N, 4, 4).clone()
    img2lidar[..., :3, 3] = torch.randn(2, N, 3, generator=gen)
    img_hw = torch.tensor([H, W], dtype=torch.float32).expand(2, N, 2).clone()
    img_hw[1, 3] = torch.tensor([16.0, 48.0])
    cpu_model = build_detector(cfg, seed=0, device="cpu")
    gpu_model = build_detector(cfg, seed=0, device="cuda")
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        want = cpu_model(images, img2lidar, img_hw)
        before = ca.LAUNCHES_FP32
        got = gpu_model(images.cuda(), img2lidar.cuda(), img_hw.cuda())
        torch.cuda.synchronize()
    assert ca.LAUNCHES_FP32 == before + cfg.model.head.num_layers  # fp32: K1's CUDA-core variant
    for key in ("cls_logits", "bbox_codes"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-3, atol=2e-3)


# The bf16 K1 against its rounding floor (flash_cross_attention_reference
# with round_p=True), elementwise within atol * max|ref| + rtol * |ref|:
# chip_smoke.py's bf16 KERNEL_TOL (both round one fp32 sum to bf16, in other
# orders)
KERNEL_TOL = (2e-5, 2.0 ** -7)


def _grid_inputs(B, H, Q, L, D, seed, masked_row=False):
    """bf16 inputs whose logits are exact in fp32: N(0, 1) draws rounded to
    multiples of 1/8 in [-4, 4], so that every q.k (a sum of D multiples of
    1/64 below 2^9) comes out the same in any order of its sum, and the
    kernel computes every p of its floor bit for bit. On other inputs the
    mma's q.k and torch's differ in the last bit, which flips the bf16
    rounding of a few p (test_kernel_matches_plain_version holds those to
    the unrounded plain version)."""
    q, k, v, mask = _inputs(B, H, Q, L, D, torch.float32, seed, masked_row)
    q, k, v = ((t * 8).round().clamp(-32, 32).div(8).to(torch.bfloat16) for t in (q, k, v))
    return q, k, v, mask


def _assert_within(got, want, tol):
    atol, rtol = tol
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = atol * w.abs().max() + rtol * w.abs()
    assert (err <= bound).all(), f"max abs err {err.max().item():.3e}, max |ref| {w.abs().max().item():.3e}"


# Q and L at no multiple of the tiles (32 or 64 query rows, 128 or 256 keys),
# D = 16, 32 and 64, a fully masked batch row wherever B > 1, both plans
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("query_warps", [2, 4])
@pytest.mark.parametrize("B,H,Q,L,D", [(1, 8, 900, 6000, 32), (2, 4, 37, 61, 16), (2, 2, 130, 1000, 64),
                                       (2, 3, 77, 301, 32), (1, 1, 1, 1, 32), (1, 8, 900, 16896, 32),
                                       (1, 8, 900, 12000, 32), (2, 8, 900, 12000, 32), (4, 4, 64, 960, 32)])
def test_bf16_forward_matches_its_rounding_floor(cuda, rate, query_warps, B, H, Q, L, D):
    q, k, v, mask = _grid_inputs(B, H, Q, L, D, seed=Q + 7 * L, masked_row=B > 1)
    before = ca.LAUNCHES
    out, lse = ca._forward_cuda(q, k, v, mask, rate, -5, query_warps=query_warps)
    torch.cuda.synchronize()
    assert ca.LAUNCHES == before + 1
    want, want_lse = ca.flash_cross_attention_reference(q, k, v, mask, rate, -5, round_p=True)
    _assert_within(out, want, KERNEL_TOL)
    live = want_lse < 1e29
    torch.testing.assert_close(lse[live], want_lse[live], atol=1e-3, rtol=0)
    if B > 1:
        assert (out[-1] == 0).all() and (lse[-1] == 1e30).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_forward_launches_count_on_their_variant(cuda, dtype):
    """bf16 inputs move only the bf16 counters of K1 and K4, fp32 inputs
    only the fp32 ones."""
    from petr_tpu_torch.ops import dcn

    q, k, v, mask = _inputs(1, 2, 40, 100, 32, dtype, seed=4)
    x, om, w = _dcn_inputs(1, 16, 6, 10, 24, 1, dtype, seed=4)
    counters = [(ca, "LAUNCHES"), (ca, "LAUNCHES_FP32"), (dcn, "LAUNCHES"), (dcn, "LAUNCHES_FP32")]
    before = [getattr(m, c) for m, c in counters]
    ca.flash_cross_attention(q, k, v, mask)
    dcn.modulated_deform_conv(x, om, w)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert [getattr(m, c) - b for (m, c), b in zip(counters, before)] == [bf16, not bf16, bf16, not bf16]


# K2 against the plain backward: each gradient within atol * max|ref| +
# rtol * |ref|, as chip_smoke.py holds it (fp32: sums in other orders; bf16:
# one rounding of the fp32 sums in each)
BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (4e-3, 1.6e-2)}


def _assert_grads_close(got, want, dtype):
    atol, rtol = BWD_TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        bound = atol * w.abs().max() + rtol * w.abs()
        assert ((g - w).abs() <= bound).all(), f"{name}: max abs err {(g - w).abs().max().item():.3e}"


def _k2_counts(dtype):
    """K2's launch counters of the variant that serves ``dtype``."""
    if dtype == torch.bfloat16:
        return ca.DKDV_LAUNCHES, ca.DQ_LAUNCHES
    return ca.DKDV_LAUNCHES_FP32, ca.DQ_LAUNCHES_FP32


# Q and L at no multiple of any tile (the bf16 kernels tile 64 and 32
# queries, 128 keys), D = 16 and 64, and a fully masked batch row wherever B > 1
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,H,Q,L,D", [(1, 8, 900, 6000, 32), (1, 8, 900, 16896, 32), (2, 4, 37, 61, 16),
                                       (2, 2, 130, 520, 64), (2, 3, 77, 301, 32), (2, 2, 45, 1000, 16),
                                       (3, 1, 201, 333, 64), (1, 8, 900, 12000, 32), (4, 4, 64, 960, 32)])
def test_backward_kernels_match_plain_version(cuda, dtype, rate, B, H, Q, L, D):
    q, k, v, mask = _inputs(B, H, Q, L, D, dtype, seed=Q + 3 * L, masked_row=B > 1)
    gout = torch.randn(B, H, Q, D, device="cuda").to(dtype)
    out, lse = ca.flash_cross_attention_reference(q, k, v, mask, rate, -7)
    delta = ca._delta(gout, out, None)
    before = _k2_counts(dtype)
    got = ca._backward_cuda(q, k, v, mask, gout, lse, delta, rate, -7)
    torch.cuda.synchronize()
    assert _k2_counts(dtype) == (before[0] + 1, before[1] + 1)
    want = ca.flash_cross_attention_backward_reference(q, k, v, mask, out, lse, gout, None, rate, -7)
    assert all(g.dtype == dtype and g.shape == w.shape for g, w in zip(got, want))
    _assert_grads_close(got, want, dtype)
    if B > 1:  # the fully masked batch row: exact zeros
        assert all((g[-1] == 0).all() for g in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("offsets", [(1, 0), (0, 3000), (3, 517)])
def test_kernels_hash_a_shards_global_coordinates(cuda, dtype, offsets):
    """K1 and K2 with a shard's offsets (its first global batch row and key)
    drop by the plain versions' mask at those coordinates."""
    B, H, Q, L, D = 2, 4, 130, 1000, 32
    q, k, v, mask = _inputs(B, H, Q, L, D, dtype, seed=11)
    out, lse = ca._forward_cuda(q, k, v, mask, 0.1, -5, offsets=offsets)
    want, want_lse = ca.flash_cross_attention_reference(q, k, v, mask, 0.1, -5, dropout_offsets=offsets)
    atol, rtol = (1e-4, 0.0) if dtype == torch.float32 else (2e-3, 1e-2)
    err = (out.float() - want.float()).abs()
    assert (err <= atol + rtol * want.float().abs()).all(), f"out: max abs err {err.max().item():.3e}"
    gout = torch.randn(B, H, Q, D, device="cuda").to(dtype)
    delta = ca._delta(gout, want, None)
    got = ca._backward_cuda(q, k, v, mask, gout, want_lse, delta, 0.1, -7, offsets=offsets)
    _assert_grads_close(got, ca.flash_cross_attention_backward_reference(
        q, k, v, mask, want, want_lse, gout, None, 0.1, -7, dropout_offsets=offsets), dtype)


def test_bf16_backward_takes_unaligned_views(cuda):
    """Rows that do not start on 16-byte boundaries (a head dim sliced out
    of a wider buffer) are copied before the tensor-core kernels run."""
    q, k, v, mask = _inputs(2, 2, 50, 90, 40, torch.bfloat16, seed=5, masked_row=True)
    q, k, v = (t[..., 3:35] for t in (q, k, v))
    gout = torch.randn(2, 2, 50, 32, device="cuda").to(torch.bfloat16)
    out, lse = ca.flash_cross_attention_reference(q, k, v, mask, 0.1, 9)
    delta = ca._delta(gout, out, None)
    got = ca._backward_cuda(q, k, v, mask, gout, lse, delta, 0.1, 9)
    want = ca.flash_cross_attention_backward_reference(q, k, v, mask, out, lse, gout, None, 0.1, 9)
    _assert_grads_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_forward_with_dropout_matches_plain_version(cuda, dtype):
    q, k, v, mask = _inputs(2, 4, 130, 520, 32, dtype, seed=11, masked_row=True)
    out, lse = ca.flash_cross_attention(q, k, v, mask, 0.1, 12345)
    ref_out, ref_lse = ca.flash_cross_attention_reference(q, k, v, mask, 0.1, 12345)
    atol, rtol = (1e-4, 0.0) if dtype == torch.float32 else (2e-3, 1e-2)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol, rtol=rtol)
    live = ref_lse < 1e29
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-3, rtol=0)
    assert (out[-1] == 0).all() and (lse[-1] == 1e30).all()


def test_lse_cotangent_through_the_function(cuda):
    q, k, v, mask = _inputs(2, 4, 100, 300, 32, torch.float32, seed=13, masked_row=True)
    gout = torch.randn(2, 4, 100, 32, device="cuda")
    glse = torch.randn(2, 4, 100, device="cuda")
    grads = []
    for fn in (ca.flash_cross_attention_with_lse,
               lambda *a: ca.flash_cross_attention_plain(*a, lse_grad=True)):
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        out, lse = fn(qs, ks, vs, mask, 0.1, 3)
        loss = (out * gout).sum() + (torch.where(lse < 1e29, lse, 0.0) * glse).sum()
        grads.append(torch.autograd.grad(loss, (qs, ks, vs)))
    _assert_grads_close(grads[0], grads[1], torch.float32)


def test_tiny_train_gradients_on_the_card_match_the_cpu(cuda):
    import dataclasses

    import numpy as np

    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.models import PETRDetector, init_weights
    from petr_tpu_torch.train import create_train_state, make_grad_fn

    cfg = get_config("tiny_debug")  # fp32; dropout off, so that no random bits differ
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, head=dataclasses.replace(cfg.model.head, dropout_rate=0.0)))
    rng = np.random.RandomState(0)
    N, (H, W), G = cfg.data.num_views, cfg.data.image_size, cfg.data.max_gt
    cams = np.tile(np.eye(4, dtype=np.float32), (2, N, 1, 1))
    cams[..., :3, 3] = rng.randn(2, N, 3)
    batch = {"images": rng.randn(2, N, H, W, 3).astype(np.float32), "img2lidar": cams,
             "img_hw": np.tile(np.array([H, W], np.float32), (2, N, 1)),
             "gt_boxes": np.abs(rng.randn(2, G, 9)).astype(np.float32) + 0.5,
             "gt_labels": rng.randint(0, 10, (2, G)), "gt_valid": np.arange(G)[None].repeat(2, 0) < 6}
    torch.backends.cudnn.allow_tf32 = False
    results = []
    for device in ("cpu", "cuda"):
        model = create_train_state(cfg, seed=0, total_steps=10, device=device).model
        # the serving paths' He-scaled draw, on which this test's tolerance was
        # set: at petr_tpu's scales the stem's gradient is ~1e-3 and made of
        # cancelling terms
        model.load_state_dict(init_weights(PETRDetector(cfg.model), 0).state_dict())
        before = (ca.LAUNCHES_FP32, ca.DKDV_LAUNCHES_FP32, ca.DQ_LAUNCHES_FP32)
        results.append(make_grad_fn(cfg)(model, batch, torch.Generator().manual_seed(0)))
        if device == "cuda":  # fp32: K1's and K2's CUDA-core variants
            L = cfg.model.head.num_layers
            got = (ca.LAUNCHES_FP32 - before[0], ca.DKDV_LAUNCHES_FP32 - before[1], ca.DQ_LAUNCHES_FP32 - before[2])
            assert got == (2 * L, L, L)
    (t_cpu, _, g_cpu, i_cpu, _), (t_gpu, _, g_gpu, i_gpu, _) = results
    np.testing.assert_array_equal(i_cpu, i_gpu)
    assert abs(t_cpu.item() - t_gpu.item()) <= 1e-4 * abs(t_cpu.item())
    for name, g in g_cpu.items():
        scale = g.abs().max().item()
        assert (g_gpu[name].cpu() - g).abs().max().item() <= 1e-3 * scale + 1e-7, name


# ------------------------------------------------- K4 (DCNv2) and K5 (conv3x3)
def _dcn_inputs(B, Cin, H, W, Cout, stride, dtype, seed):
    """Offsets of a few pixels (std 3: taps past every edge), mask logits of
    std 1.5, a He-scaled fp32 weight; x in ``dtype``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = torch.randn(B, Cin, H, W, generator=gen, device="cuda").to(dtype)
    off = torch.randn(B, 18, Ho, Wo, generator=gen, device="cuda") * 3.0
    logits = torch.randn(B, 9, Ho, Wo, generator=gen, device="cuda") * 1.5
    w = torch.randn(Cout, Cin, 3, 3, generator=gen, device="cuda") * (2.0 / (9 * Cin)) ** 0.5
    return x, torch.cat([off, logits], 1), w


# The bf16 K4 against the unrounded plain version (atol * max|ref| + rtol *
# |ref|): chip_smoke.py's OPERAND_TOL. Rounding the samples and the weight to
# bf16 moves a sum of thousands of terms by about 2^-9 of their root sum of
# squares; the floor took 0.50-0.65 of this bound at the r50 stages and the
# stride-2 odd shape.
OPERAND_TOL = (4e-3, 1.6e-2)


def _assert_dcn_close(got, want, dtype):
    """fp32: sums in other orders, within 2e-5 of the largest output. bf16:
    both round one fp32 sum, so within one bf16 step of |ref| (at most
    2^-7 |ref|, for |ref| just above a power of two), plus the fp32
    difference where the output is near 0."""
    g, w = got.float(), want.float()
    scale = w.abs().max()
    bound = 2e-5 * scale if dtype == torch.float32 else 2.0 ** -7 * w.abs() + 2e-5 * scale
    err = (g - w).abs()
    assert (err <= bound).all(), f"max abs err {err.max().item():.3e}, max |ref| {scale.item():.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "B,Cin,H,W,Cout,stride",
    [(6, 256, 32, 88, 256, 1), (6, 512, 16, 44, 512, 1), (2, 5, 7, 9, 3, 2), (1, 70, 3, 130, 65, 1),
     (24, 256, 8, 20, 256, 1), (24, 512, 4, 10, 512, 1)],
    ids=["r50-stage3", "r50-stage4", "odd-stride2", "odd-wide", "synth-stage3", "synth-stage4"],
)
def test_dcn_kernel_matches_plain_version(cuda, dtype, B, Cin, H, W, Cout, stride):
    """fp32 against the plain version; bf16 against its rounding floor (the
    kernel rounds the samples and the weight to bf16 before their products,
    operand_dtype makes the plain version round them at the same points)
    under the same bound, and against the unrounded plain version within
    OPERAND_TOL."""
    from petr_tpu_torch.ops import dcn

    x, om, w = _dcn_inputs(B, Cin, H, W, Cout, stride, dtype, seed=Cin + H)
    counter = "LAUNCHES" if dtype == torch.bfloat16 else "LAUNCHES_FP32"
    before = getattr(dcn, counter)
    out = dcn.modulated_deform_conv(x, om, w, stride)
    torch.cuda.synchronize()
    assert getattr(dcn, counter) == before + 1
    want = dcn.modulated_deform_conv_reference(x, om, w, stride)
    assert out.dtype == dtype and out.shape == want.shape
    if dtype == torch.float32:
        _assert_dcn_close(out, want, dtype)
        return
    floor = dcn.modulated_deform_conv_reference(x, om, w, stride, operand_dtype=torch.bfloat16)
    _assert_dcn_close(out, floor, dtype)
    _assert_within(out, want, OPERAND_TOL)


@pytest.mark.parametrize(
    "B,Cin,H,W,Cout,stride",
    [(6, 256, 32, 88, 256, 1), (6, 512, 16, 44, 512, 1), (2, 5, 7, 9, 3, 2), (1, 70, 3, 130, 65, 1),
     (2, 40, 9, 20, 300, 1), (24, 256, 8, 20, 256, 1), (24, 512, 4, 10, 512, 1)],
    ids=["r50-stage3", "r50-stage4", "odd-stride2", "odd-wide", "cout300", "synth-stage3", "synth-stage4"],
)
def test_bf16_dcn_matches_its_rounding_floor(cuda, B, Cin, H, W, Cout, stride):
    from petr_tpu_torch.ops import dcn

    x, om, w = _dcn_inputs(B, Cin, H, W, Cout, stride, torch.bfloat16, seed=Cin + W)
    before = dcn.LAUNCHES
    out = dcn.modulated_deform_conv(x, om, w, stride)
    torch.cuda.synchronize()
    assert dcn.LAUNCHES == before + 1
    floor = dcn.modulated_deform_conv_reference(x, om, w, stride, operand_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == floor.shape
    _assert_dcn_close(out, floor, torch.bfloat16)


def test_dcn_gradients_through_the_function(cuda):
    from petr_tpu_torch.ops import dcn

    x, om, w = _dcn_inputs(2, 32, 12, 20, 24, 1, torch.float32, seed=3)
    gout = torch.randn(2, 24, 12, 20, device="cuda")
    results = []
    for fn in (dcn.modulated_deform_conv, dcn.modulated_deform_conv_plain):
        ins = [t.detach().clone().requires_grad_() for t in (x, om, w)]
        before = dcn.LAUNCHES_FP32
        fn(*ins).backward(gout)
        results.append((dcn.LAUNCHES_FP32 - before, [t.grad for t in ins]))
    (k_launches, k_grads), (p_launches, p_grads) = results
    assert (k_launches, p_launches) == (1, 0), "the backward must not launch K4"
    for name, a, b in zip(("x", "off_mask", "weight"), k_grads, p_grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item(), msg=name)
    cpu = [t.detach().cpu().requires_grad_() for t in (x, om, w)]
    dcn.modulated_deform_conv(*cpu).backward(gout.cpu())
    for name, a, b in zip(("x", "off_mask", "weight"), k_grads, (t.grad for t in cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4 * b.abs().max().item(), msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("affine,relu", [(True, True), (False, False)])
@pytest.mark.parametrize(
    "B,C,H,W,Co",
    [(6, 128, 80, 200, 128), (6, 192, 20, 50, 192), (1, 13, 5, 7, 70), (2, 160, 40, 100, 160),
     (3, 40, 10, 25, 224), (2, 24, 11, 50, 160), (1, 8, 3, 130, 96), (1, 200, 10, 25, 64)],
    ids=["stage2", "stage4", "odd", "co160-w100", "co224-w25-c40", "w50-c24", "one-row-tiles",
         "split-k-uneven"],
)
def test_conv3x3_kernel_matches_plain_version(cuda, dtype, affine, relu, B, C, H, W, Co):
    from petr_tpu_torch.ops import conv3x3

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(C + H)
    x = torch.randn(B, C, H, W, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(Co, C, 3, 3, generator=gen, device="cuda") * (2.0 / (9 * C)) ** 0.5).to(dtype)
    mul = torch.rand(Co, generator=gen, device="cuda") + 0.5 if affine else None
    add = torch.randn(Co, generator=gen, device="cuda") * 0.3 if affine else None
    counter = "LAUNCHES" if dtype == torch.bfloat16 else "LAUNCHES_FP32"
    before = getattr(conv3x3, counter), conv3x3.SPLITK_LAUNCHES
    out = conv3x3.conv3x3_bn_relu(x, w, mul, add, relu)
    torch.cuda.synchronize()
    assert getattr(conv3x3, counter) == before[0] + 1
    th, tw = conv3x3.conv_tile(H, W)
    blocks = -(-H // th) * -(-W // tw) * -(-Co // conv3x3.TILE_CHANNELS) * B
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = dtype == torch.bfloat16 and conv3x3.conv_split(blocks, -(-C // conv3x3.CHUNK_CHANNELS), sms) > 1
    assert conv3x3.SPLITK_LAUNCHES == before[1] + split  # stage 4 and the uneven case split K
    want = conv3x3.conv3x3_bn_relu_reference(x, w, mul, add, relu)
    assert out.dtype == dtype and out.shape == want.shape
    _assert_dcn_close(out, want, dtype)


def test_tiny_r50dcn_detector_on_the_card_matches_the_cpu(cuda):
    import dataclasses

    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.models.resnet import redraw_offset_convs
    from petr_tpu_torch.ops import dcn
    from petr_tpu_torch.serve import build_detector

    cfg = get_config("petr_r50_p4_1408x512")
    head = dataclasses.replace(cfg.model.head, num_query=32, embed_dim=64, num_layers=2, num_heads=4,
                               ffn_dim=128, depth_num=8)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, head=head, compute_dtype="float32"))
    N, H, W = 2, 64, 160
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(1, N, H, W, 3, generator=gen)
    img2lidar = torch.eye(4).expand(1, N, 4, 4).clone()
    img2lidar[..., :3, 3] = torch.randn(1, N, 3, generator=gen)
    img_hw = torch.tensor([H, W], dtype=torch.float32).expand(1, N, 2).clone()
    models = []
    for device in ("cpu", "cuda"):
        model = build_detector(cfg, seed=0, device="cpu")
        redraw_offset_convs(model, seed=1)
        models.append(model.to(device))
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        want = models[0](images, img2lidar, img_hw)
        before = dcn.LAUNCHES_FP32
        got = models[1](images.cuda(), img2lidar.cuda(), img_hw.cuda())
        torch.cuda.synchronize()
    assert dcn.LAUNCHES_FP32 == before + 9  # fp32: K4's CUDA-core variant
    for key in ("cls_logits", "bbox_codes"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-3, atol=2e-3)


def test_tiny_petrv2_on_the_card_matches_the_cpu(cuda):
    """tiny_debug_v2 (fp32, 12 views, FPE, with_time, unshared branches):
    K1's fp32 variant once per decoder layer, the outputs as on the CPU;
    the streaming runtime's frame on the card equal to the full forward."""
    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.serve import StreamingPETRv2, build_detector

    cfg = get_config("tiny_debug_v2")
    N, (H, W) = 12, cfg.data.image_size
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(2, N, H, W, 3, generator=gen)
    img2lidar = torch.eye(4).expand(2, N, 4, 4).clone()
    img2lidar[..., :3, 3] = torch.randn(2, N, 3, generator=gen)
    img_hw = torch.tensor([H, W], dtype=torch.float32).expand(2, N, 2).clone()
    img_hw[1, 9] = torch.tensor([16.0, 48.0])
    ts = torch.cat([torch.zeros(2, 6), torch.full((2, 6), 0.5)], 1)
    cpu_model = build_detector(cfg, seed=0, device="cpu")
    gpu_model = build_detector(cfg, seed=0, device="cuda")
    torch.backends.cudnn.allow_tf32 = False
    args = (images, img2lidar, img_hw)
    with torch.inference_mode():
        want = cpu_model(*args, timestamp=ts)
        before = ca.LAUNCHES_FP32
        got = gpu_model(*(a.cuda() for a in args), timestamp=ts.cuda())
        torch.cuda.synchronize()
    assert ca.LAUNCHES_FP32 == before + cfg.model.head.num_layers  # fp32: K1's CUDA-core variant
    for key in ("cls_logits", "bbox_codes"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-3, atol=2e-3)
    stream = StreamingPETRv2(cfg, gpu_model, decode=False, device="cuda")
    stream.prime(images[:, 6:])
    frame = stream.step(images[:, :6], img2lidar, img_hw, ts)
    for key in ("cls_logits", "bbox_codes"):
        torch.testing.assert_close(frame[key], got[key], rtol=1e-4, atol=1e-4)


def test_tiny_depthr_on_the_card_matches_the_cpu(cuda):
    """depthr_r50_c5_512x1408_gtdepth with a tiny head at 64x192 (fp32):
    the GT depth maps on the card equal to the CPU's bit for bit, K4's
    fp32 variant 9 times per forward, the outputs as on the CPU (rtol
    1e-3, atol 2e-3, as the r50dcn detector above) and unchanged by other
    images, and an eval step's boxes on the card."""
    import dataclasses

    import numpy as np

    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.models.depth_encoder import gt_depth_maps
    from petr_tpu_torch.models.resnet import redraw_offset_convs
    from petr_tpu_torch.ops import dcn
    from petr_tpu_torch.serve import build_detector
    from petr_tpu_torch.train import make_eval_step

    cfg = get_config("depthr_r50_c5_512x1408_gtdepth")
    N, H, W, G = 6, 64, 192, 16
    head = dataclasses.replace(cfg.model.head, num_query=32, embed_dim=64, num_layers=2, num_heads=4, ffn_dim=128,
                               depth_num=8)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, head=head, compute_dtype="float32"),
                              data=dataclasses.replace(cfg.data, image_size=(H, W), max_gt=G))
    rng = np.random.RandomState(0)
    l2i = np.zeros((1, N, 4, 4))
    for i in range(N):
        yaw = 2 * np.pi * i / N
        R = np.array([[-np.sin(yaw), np.cos(yaw), 0], [0, 0, -1], [np.cos(yaw), np.sin(yaw), 0]])
        E = np.eye(4)
        E[:3, :3] = R
        E[:3, 3] = -R @ np.array([np.cos(yaw), np.sin(yaw), 1.5])
        K = np.eye(4)
        K[0, 0] = K[1, 1] = W / 2
        K[0, 2], K[1, 2] = W / 2, H / 2
        l2i[0, i] = K @ E
    bearing = 2 * np.pi * np.arange(G) / N + rng.uniform(-0.3, 0.3, G)
    dist = rng.uniform(5, 30, G)
    boxes = np.concatenate([(dist * np.cos(bearing))[:, None], (dist * np.sin(bearing))[:, None],
                            rng.uniform(-1, 1, (G, 1)), rng.uniform(1, 4, (G, 3)), rng.uniform(-3, 3, (G, 1)),
                            rng.uniform(-1, 1, (G, 2))], -1)[None]
    batch = {
        "images": torch.from_numpy(rng.randn(1, N, H, W, 3).astype(np.float32)),
        "img2lidar": torch.from_numpy(np.linalg.inv(l2i).astype(np.float32)),
        "img_hw": torch.tensor([H, W], dtype=torch.float32).expand(1, N, 2).clone(),
        "gt_boxes": torch.from_numpy(boxes.astype(np.float32)),
        "gt_valid": torch.from_numpy(rng.rand(1, G) < 0.9),
        "lidar2img": torch.from_numpy(l2i.astype(np.float32)),
    }
    maps = [gt_depth_maps(*[batch[k].to(d) for k in ("gt_boxes", "gt_valid", "lidar2img")], (H, W), 8).cpu()
            for d in ("cpu", "cuda")]
    assert (maps[0] > 0).any() and torch.equal(maps[0], maps[1])
    models = []
    for device in ("cpu", "cuda"):
        model = build_detector(cfg, seed=0, device="cpu")
        redraw_offset_convs(model, seed=1)
        models.append(model.to(device))
    oracle = ("gt_boxes", "gt_valid", "lidar2img")
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        want = models[0](batch["images"], batch["img2lidar"], batch["img_hw"], **{k: batch[k] for k in oracle})
        on_card = {k: v.cuda() for k, v in batch.items()}
        before = dcn.LAUNCHES_FP32
        got = models[1](on_card["images"], on_card["img2lidar"], on_card["img_hw"], **{k: on_card[k] for k in oracle})
        other = models[1](torch.randn_like(on_card["images"]), on_card["img2lidar"], on_card["img_hw"],
                          **{k: on_card[k] for k in oracle})
        torch.cuda.synchronize()
    assert dcn.LAUNCHES_FP32 == before + 18  # two forwards, 9 DCN convs each
    for key in ("cls_logits", "bbox_codes"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-3, atol=2e-3)
        assert torch.equal(other[key], got[key]), key
    dec = make_eval_step(cfg)(models[1], batch)
    assert dec["boxes"].is_cuda and torch.isfinite(dec["boxes"]).all()


def test_tiny_evaluate_model_on_the_card_matches_the_cpu(cuda, tmp_path):
    """train.evaluate_model with tiny_debug (fp32) over 2 rendered synthetic
    scenes: K1's fp32 variant once per decoder layer per eval batch, the
    decoded scores (sorted) within 1e-5 of the CPU's, the labels and boxes
    at every rank whose score stands 2e-5 apart from its neighbours equal
    and within 1e-3, and the same metric dict within 1e-6."""
    import numpy as np

    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.data import NuScenesDataset, generate_synthetic_scenes
    from petr_tpu_torch.serve import build_detector
    from petr_tpu_torch.train import evaluate

    cfg = get_config("tiny_debug")
    val = generate_synthetic_scenes(str(tmp_path), n_scenes=2, frames_per_scene=2, image_hw=(64, 160),
                                    val_scenes=2, seed=1)["val"]
    ds = NuScenesDataset(val, cfg.data, training=False, src_hw=(64, 160))
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    for device in ("cpu", "cuda"):
        model = build_detector(cfg, seed=0, device=device)
        rec = {}
        decode = evaluate._decode_dataset
        evaluate._decode_dataset = lambda *a, **k: rec.setdefault("det", decode(*a, **k))
        try:
            before = ca.LAUNCHES_FP32
            metrics = evaluate.evaluate_model(cfg, model, ds, batch_size=2, classes=("car", "bus", "pedestrian"))
            launches = ca.LAUNCHES_FP32 - before
        finally:
            evaluate._decode_dataset = decode
        runs[device] = (metrics, rec["det"][1], launches)
    assert runs["cuda"][2] == cfg.model.head.num_layers * 2 and runs["cpu"][2] == 0
    (want, wdet, _), (got, gdet, _) = runs["cpu"], runs["cuda"]
    for i in range(len(val)):
        ws, gs = wdet["scores"][i], gdet["scores"][i]
        np.testing.assert_allclose(np.sort(gs), np.sort(ws), rtol=0, atol=1e-5)
        ow, og = np.argsort(-ws, kind="stable"), np.argsort(-gs, kind="stable")
        gap = -np.diff(ws[ow])
        apart = np.ones(len(ws), bool)
        apart[1:] &= gap > 2e-5
        apart[:-1] &= gap > 2e-5
        np.testing.assert_array_equal(gdet["labels"][i][og][apart], wdet["labels"][i][ow][apart])
        np.testing.assert_allclose(gdet["boxes"][i][og][apart], wdet["boxes"][i][ow][apart], rtol=0, atol=1e-3)
    assert list(got) == list(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6, (k, got[k], v)


def test_tiny_batch_bn_step_on_the_card_matches_the_cpu(cuda):
    """One tiny_debug fp32 step with bn_mode="batch" (dropout 0) on the card
    and on the CPU from the same weights: the loss within 1e-4 relative and
    the EMA'd BN running statistics within 1e-4 of each layer's largest
    (fp32 sums in other orders, through batch-normalised layers)."""
    import numpy as np

    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.train import create_train_state, make_train_step

    cfg = get_config("tiny_debug", ("model.backbone.bn_mode=batch", "model.head.dropout_rate=0.0"))
    N, (H, W), G = cfg.data.num_views, cfg.data.image_size, cfg.data.max_gt
    rng = np.random.RandomState(4)
    batch = {"images": rng.randn(2, N, H, W, 3).astype(np.float32),
             "img2lidar": np.tile(np.eye(4, dtype=np.float32), (2, N, 1, 1)),
             "img_hw": np.tile(np.array([H, W], np.float32), (2, N, 1)),
             "gt_boxes": np.abs(rng.randn(2, G, 9)).astype(np.float32) + 0.5,
             "gt_labels": rng.randint(0, 10, (2, G)), "gt_valid": np.arange(G)[None].repeat(2, 0) < 6}
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for device in ("cpu", "cuda"):
        state = create_train_state(cfg, seed=0, total_steps=10, device=device)
        state, metrics = make_train_step(cfg)(state, batch, torch.Generator().manual_seed(0))
        out[device] = metrics["loss"].item(), {k: v.cpu() for k, v in state.model.named_buffers()}
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for k, want in out["cpu"][1].items():
        assert (out["cuda"][1][k] - want).abs().max().item() <= 1e-4 * want.abs().max().item() + 1e-7, k


K6_SHAPES = [  # (B, C, H, W, Co, k, s): the classes of V-99's 20 shapes at 6 views, then odd ones
    (6, 3, 320, 800, 64, 3, 2),  # stem1: Cin 3 -> 32, the strided 4-D box, 16-byte stores
    (6, 64, 160, 400, 128, 3, 2),  # stem3: the strided box, tw 8
    (6, 128, 80, 200, 128, 3, 1),  # s2: flat padded rows, unsplit
    (6, 768, 80, 200, 256, 1, 1),  # s2 concat: 1x1 rows, n 256, 16-byte stores
    (6, 256, 40, 100, 160, 3, 1),  # s3 in256: n 160, a chunk's 9 taps from one halo a stage
    (6, 1312, 40, 100, 512, 1, 1),  # s3 concat: two tile columns
    (6, 192, 20, 50, 192, 3, 1),  # s4: n 64, three tile columns, one element a thread stores
    (6, 1728, 20, 50, 768, 1, 1),  # s4 concat: three tile columns
    (6, 768, 20, 50, 192, 3, 1),  # s4 in768: K split in 2, the partial sums reduced in L2
    (6, 224, 10, 25, 224, 3, 1),  # s5: 56 blocks
    (6, 1024, 10, 25, 224, 3, 1),  # s5 in1024: split, four tile columns
    (6, 2144, 10, 25, 1024, 1, 1),  # s5 concat: 1x1, K = 67 slices, a partial last stage
    (2, 3, 33, 47, 64, 3, 2), (1, 64, 20, 50, 300, 3, 1), (2, 96, 9, 13, 40, 1, 1), (1, 128, 17, 19, 72, 3, 2),
    (1, 32, 5, 7, 8, 1, 2), (1, 40, 7, 9, 24, 3, 1),
    (1, 32, 3, 700, 64, 3, 1),  # W + 1 = 701: a stage takes one kernel row's taps (group 3)
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,C,H,W,Co,k,s", K6_SHAPES)
def test_conv_int8_kernel_matches_plain_version(cuda, dtype, B, C, H, W, Co, k, s):
    """K6: the int32 sums bit for bit, the output equal to the plain version's
    (the same fp32 epilogue, one rounding), and its two launches counted."""
    from petr_tpu_torch.ops import conv_int8 as c8

    gen = torch.Generator(device="cuda").manual_seed(C + H)
    x = torch.randn(B, C, H, W, generator=gen, device="cuda").to(dtype)
    w = torch.randn(Co, C, k, k, generator=gen, device="cuda") * (2.0 / (k * k * C)) ** 0.5
    mul = torch.rand(Co, generator=gen, device="cuda") + 0.5
    add = torch.randn(Co, generator=gen, device="cuda")
    amax = x.abs().amax().float() * 0.8
    wi, _ = c8.quantize_weight(w, mul)
    sa = c8.act_scale(amax)
    acc = c8.conv_int8_accumulate(x, wi, sa, s)
    assert torch.equal(acc, c8.conv_int8_accumulate_reference(c8.quantize_activation(x, sa), wi, s))
    wq, sa, scale, addf = c8.prepare_operands(w, mul, add, amax)
    wt = c8.tile_weight(wq, c8.conv_plan(B, C, H, W, Co, k, s).bn)
    before = (c8.LAUNCHES, c8.QUANT_LAUNCHES)
    for relu in (True, False):
        out = c8.conv_int8_bn_act_tiled(x, wt, sa, scale, addf, s, relu)
        assert out.dtype == dtype and torch.equal(out, c8.conv_int8_bn_act_plain(x, w, mul, add, amax, s, relu))
    assert (c8.LAUNCHES, c8.QUANT_LAUNCHES) == (before[0] + 2, before[1] + 2)


def test_conv_int8_rounds_ties_to_even(cuda):
    """Every x / sa a tie (x on half-integers, sa = 1): the quantised rows and
    the sums as the plain version rounds them, half to even."""
    from petr_tpu_torch.ops import conv_int8 as c8

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = (torch.randint(-100, 100, (6, 128, 80, 200), generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
    w = torch.randn(128, 128, 3, 3, generator=gen, device="cuda") * 0.05
    wi, _ = c8.quantize_weight(w, torch.ones(128, device="cuda"))
    sa = c8.act_scale(torch.tensor(127.0, device="cuda"))
    for s, plan in ((1, c8.conv_plan(6, 128, 80, 200, 128, 3, 1)), (2, c8.conv_plan(6, 128, 80, 200, 64, 3, 2))):
        xi, zeros = c8.unpack_rows(c8.quantize_rows(x, sa, plan), plan)
        assert torch.equal(xi, c8.quantize_activation(x, sa)) and not zeros.any(), s
    acc = c8.conv_int8_accumulate(x, wi, sa, 1)
    assert torch.equal(acc, c8.conv_int8_accumulate_reference(c8.quantize_activation(x, sa), wi, 1))


def test_conv_int8_split_workspace_left_zero(cuda):
    """A split plan's workspace and counters are zero again after the launch,
    and a second launch gives the same sums."""
    from petr_tpu_torch.ops import conv_int8 as c8

    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(6, 768, 20, 50, generator=gen, device="cuda").to(torch.bfloat16)
    wi = torch.randint(-127, 128, (192, 768, 3, 3), generator=gen, device="cuda").to(torch.int8)
    sa = c8.act_scale(x.abs().amax())
    assert c8.conv_plan(6, 768, 20, 50, 192, 3, 1).splits > 1
    first = c8.conv_int8_accumulate(x, wi, sa, 1)
    second = c8.conv_int8_accumulate(x, wi, sa, 1)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    for ws, counters in c8._workspaces.values():
        assert not ws.any() and not counters.any()


def test_conv_int8_refuses_what_it_does_not_take(cuda):
    from petr_tpu_torch.ops import conv_int8 as c8

    x = torch.randn(1, 32, 8, 8, device="cuda")
    wt = c8.tile_weight(torch.zeros(16, 3, 3, 32, dtype=torch.int8, device="cuda"), 64)
    one, s16 = torch.ones((), device="cuda"), torch.ones(16, device="cuda")
    for bad in (dict(wt=wt[:, :4]), dict(x=x.half()), dict(stride=3), dict(wt=wt.float()), dict(scale=s16[:8])):
        args = dict(x=x, wt=wt, sa=one, scale=s16, add=s16, stride=1)
        args.update(bad)
        with pytest.raises(ValueError):
            c8.conv_int8_bn_act_tiled(args["x"], args["wt"], args["sa"], args["scale"], args["add"], args["stride"])


def test_tiny_int8_detector_on_the_card_matches_the_cpu(cuda):
    """tiny_debug (fp32) with calibrated scales: K6 once per quantised conv
    (39 in V-39), the outputs as on the CPU's plain int8 conv (fp32 ops
    outside it round apart by an ulp, which may move an activation across a
    quantisation step: the fp32 detector tests' limits)."""
    import numpy as np

    from petr_tpu_torch.cli.quantize import synthetic_batch
    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.ops import conv_int8 as c8
    from petr_tpu_torch.quant import apply_scales, calibrate_detector
    from petr_tpu_torch.serve import build_detector

    cfg = get_config("tiny_debug")
    torch.backends.cudnn.allow_tf32 = False
    cpu = build_detector(cfg, seed=0, device="cpu")
    scales = calibrate_detector(cfg, cpu, [synthetic_batch(cfg, 1, 0)])
    card = build_detector(cfg, seed=0, device="cuda")
    for model in (cpu, card):
        apply_scales(model, scales)
    batch = synthetic_batch(cfg, 1, 1)
    args = [torch.from_numpy(np.asarray(batch[k])) for k in ("images", "img2lidar", "img_hw")]
    with torch.inference_mode():
        want = cpu(*args)
        before = c8.LAUNCHES
        got = card(*[a.cuda() for a in args])
        torch.cuda.synchronize()
    assert c8.LAUNCHES == before + 39
    for key in ("cls_logits", "bbox_codes"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-3, atol=2e-3)


# ------------------------------------------------------ the measurement tools
def test_flop_count_is_equal_on_both_routes(cuda):
    """``utils.mfu.count_flops`` of the tiny_debug forward (K1's op, counted
    by its formula) and train step (K2 launched by ctypes in the backward,
    counted by its formula in ``BACKWARD_FLOPS``) on the card equals the
    count with every kernel routed to its plain version, and the CPU's."""
    from petr_tpu_torch.cli.benchmark import benchmark_batch, forward_inputs
    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.serve import build_detector
    from petr_tpu_torch.train import create_train_state, make_train_step, step_generator
    from petr_tpu_torch.utils import mfu

    cfg = get_config("tiny_debug")
    batch = benchmark_batch(cfg, 1, seed=0)
    forward, step = {}, {}
    for device in ("cuda", "cpu"):
        model = build_detector(cfg, seed=0, device=device)
        args, kwargs = forward_inputs(cfg, batch, device)
        for plain in (False, True):
            with torch.inference_mode(), (mfu.plain_kernels() if plain else contextlib.nullcontext()):
                before = ca.LAUNCHES_FP32
                forward[device, plain] = mfu.count_flops(model, *args, **kwargs)
                assert ca.LAUNCHES_FP32 - before == (2 if device == "cuda" and not plain else 0)
    kept = torch.backends.cudnn.deterministic
    try:
        for device in ("cuda", "cpu"):
            for plain in (False, True):
                state = create_train_state(cfg, 0, 10, device=device)
                before = ca.DKDV_LAUNCHES_FP32, ca.BACKWARD_FLOPS
                with mfu.plain_kernels() if plain else contextlib.nullcontext():
                    step[device, plain] = mfu.count_flops(make_train_step(cfg), state, batch, step_generator(1, 0))
                launched = device == "cuda" and not plain
                assert ca.DKDV_LAUNCHES_FP32 - before[0] == (2 if launched else 0)  # one per decoder layer
                assert (ca.BACKWARD_FLOPS > before[1]) == launched
    finally:
        torch.backends.cudnn.deterministic = kept
    assert len(set(forward.values())) == 1 and len(set(step.values())) == 1, (forward, step)
    assert step["cuda", False] > 3 * forward["cuda", False]


def test_k2_counts_its_formula(cuda):
    q, k, v, mask = _inputs(1, 8, 90, 600, 32, torch.bfloat16, seed=5)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    before = ca.BACKWARD_FLOPS
    ca.flash_cross_attention(q, k, v, mask)[0].float().sum().backward()
    torch.cuda.synchronize()
    assert ca.BACKWARD_FLOPS - before == ca.backward_flops(1, 8, 90, 600, 32)


def test_native_loader_built_and_held_to_pil(cuda, tmp_path):
    """The port's native loader built from ``csrc/dataload.cpp`` into a
    temporary directory, against the PIL path under petr_tpu's limits; skips
    where the machine has no libjpeg headers (then the loader stays on PIL)."""
    import io

    import numpy as np
    from PIL import Image

    from petr_tpu_torch.data import native
    from petr_tpu_torch.data.transforms import IdaParams, apply_ida, normalize_image, pad_image

    kept = native._LIB, native._TRIED
    try:
        try:
            native.build(tmp_path)
        except RuntimeError as e:
            if "jpeglib.h" in str(e):
                pytest.skip("this machine has no jpeglib.h (libjpeg's headers): the loader decodes through PIL")
            raise
        rng = np.random.RandomState(0)
        base = np.asarray(Image.fromarray((rng.rand(113, 201, 3) * 255).astype(np.uint8)).resize((1600, 900)))
        buf = io.BytesIO()
        Image.fromarray(base).save(buf, format="JPEG", quality=95)
        mean, std = (103.53, 116.28, 123.675), (57.375, 57.12, 58.395)
        for flip in (False, True):
            p = IdaParams(0.5, (800, 450), (0, 130, 800, 450), flip, 0.0)
            out = native.process_images([buf.getvalue()], resize_wh=p.resize_dims, crop=p.crop, flip=flip,
                                        out_hw=(320, 800), mean=mean, std=std)[0]
            arr = np.asarray(apply_ida(Image.open(io.BytesIO(buf.getvalue())), p), np.float32)[..., ::-1]
            err = np.abs(out - pad_image(normalize_image(arr, mean, std, False), (320, 800)))
            assert np.median(err) < 0.05, np.median(err)
            assert (err < 0.25).mean() > 0.99, err.max()
    finally:
        native._LIB, native._TRIED = kept
