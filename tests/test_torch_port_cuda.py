"""The hand-written CUDA kernels against their plain PyTorch versions, on the card.

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
