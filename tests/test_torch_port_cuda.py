"""The hand-written CUDA kernels against their plain PyTorch versions, on the card:
K1 (the forward, with and without dropout), K2 (the backward's dK/dV and dQ
kernels) and K3 (the lse cotangent through the autograd Function).

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False. The card's machine has no JAX, so this file imports none and runs
without the repository's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py
"""

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
    [(1, 8, 900, 6000, 32), (2, 4, 37, 61, 16), (2, 2, 130, 520, 64), (1, 1, 1, 1, 32)],
)
def test_kernel_matches_plain_version(cuda, dtype, B, H, Q, L, D):
    q, k, v, mask = _inputs(B, H, Q, L, D, dtype, seed=Q + L, masked_row=B > 1)
    before = ca.LAUNCHES
    out, lse = ca.flash_cross_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert ca.LAUNCHES == before + 1
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
        before = ca.LAUNCHES
        got = gpu_model(images.cuda(), img2lidar.cuda(), img_hw.cuda())
        torch.cuda.synchronize()
    assert ca.LAUNCHES == before + cfg.model.head.num_layers
    for key in ("cls_logits", "bbox_codes"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-3, atol=2e-3)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,H,Q,L,D", [(1, 8, 900, 6000, 32), (2, 4, 37, 61, 16), (2, 2, 130, 520, 64)])
def test_backward_kernels_match_plain_version(cuda, dtype, rate, B, H, Q, L, D):
    q, k, v, mask = _inputs(B, H, Q, L, D, dtype, seed=Q + 3 * L, masked_row=B > 1)
    gout = torch.randn(B, H, Q, D, device="cuda").to(dtype)
    out, lse = ca.flash_cross_attention_reference(q, k, v, mask, rate, -7)
    delta = ca._delta(gout, out, None)
    before = (ca.DKDV_LAUNCHES, ca.DQ_LAUNCHES)
    got = ca._backward_cuda(q, k, v, mask, gout, lse, delta, rate, -7)
    torch.cuda.synchronize()
    assert (ca.DKDV_LAUNCHES, ca.DQ_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = ca.flash_cross_attention_backward_reference(q, k, v, mask, out, lse, gout, None, rate, -7)
    assert all(g.dtype == dtype and g.shape == w.shape for g, w in zip(got, want))
    _assert_grads_close(got, want, dtype)
    if B > 1:  # the fully masked batch row: exact zeros
        assert all((g[-1] == 0).all() for g in got)


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
        before = (ca.LAUNCHES, ca.DKDV_LAUNCHES, ca.DQ_LAUNCHES)
        results.append(make_grad_fn(cfg)(model, batch, torch.Generator().manual_seed(0)))
        if device == "cuda":
            L = cfg.model.head.num_layers
            assert (ca.LAUNCHES - before[0], ca.DKDV_LAUNCHES - before[1], ca.DQ_LAUNCHES - before[2]) == (2 * L, L, L)
    (t_cpu, _, g_cpu, i_cpu), (t_gpu, _, g_gpu, i_gpu) = results
    np.testing.assert_array_equal(i_cpu, i_gpu)
    assert abs(t_cpu.item() - t_gpu.item()) <= 1e-4 * abs(t_cpu.item())
    for name, g in g_cpu.items():
        scale = g.abs().max().item()
        assert (g_gpu[name].cpu() - g).abs().max().item() <= 1e-3 * scale + 1e-7, name
