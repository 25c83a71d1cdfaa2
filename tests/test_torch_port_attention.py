"""K1's plain version (petr_tpu_torch.ops.cross_attention) against the Pallas
flash forward of petr_tpu, run in interpret mode on the CPU.

Both return (out, lse); fully masked rows must give out 0 and lse +1e30 in
both. fp32 tolerance 2e-5, as `tests/test_pallas_attention.py` uses.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petr_tpu.ops.pallas.cross_attention import _flash_forward
from petr_tpu_torch.ops import cross_attention as ca

ATOL = 2e-5


def _inputs(B, H, Q, L, D, seed, mask_kind):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Q, D).astype(np.float32)
    k = rng.randn(B, H, L, D).astype(np.float32)
    v = rng.randn(B, H, L, D).astype(np.float32)
    mask = None
    if mask_kind == "random":
        mask = rng.rand(B, L) < 0.3
    elif mask_kind == "row":
        mask = rng.rand(B, L) < 0.2
        mask[-1] = True  # the last batch row is all padding
    return q, k, v, mask


def _jax(q, k, v, mask, dtype=jnp.float32):
    out, lse = _flash_forward(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        None if mask is None else jnp.asarray(mask), interpret=True,
    )
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


def _port(q, k, v, mask, dtype=torch.float32):
    t = lambda a: torch.from_numpy(a).to(dtype)
    return ca.flash_cross_attention_reference(
        t(q), t(k), t(v), None if mask is None else torch.from_numpy(mask)
    )


@pytest.mark.parametrize(
    "B,H,Q,L,D,mask_kind",
    [
        (1, 2, 128, 512, 32, None),  # unmasked, block-aligned
        (2, 2, 130, 520, 16, "random"),  # Q, L not multiples of 128 / 512
        (2, 1, 37, 61, 64, "row"),  # one batch row fully masked
        (1, 4, 32, 60, 16, "random"),  # tiny_debug's decoder shape
    ],
)
def test_reference_matches_pallas_forward(B, H, Q, L, D, mask_kind):
    q, k, v, mask = _inputs(B, H, Q, L, D, seed=Q + L, mask_kind=mask_kind)
    want_out, want_lse = _jax(q, k, v, mask)
    out, lse = _port(q, k, v, mask)
    assert out.shape == (B, H, Q, D) and lse.shape == (B, H, Q) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=1e-6)
    if mask_kind == "row":
        assert (out[-1] == 0).all() and (lse[-1] == 1e30).all()
        assert (want_out[-1] == 0).all() and (want_lse[-1] == 1e30).all()


def test_reference_bf16_keeps_dtype():
    q, k, v, mask = _inputs(1, 2, 100, 300, 32, seed=7, mask_kind="random")
    want_out, want_lse = _jax(q, k, v, mask, jnp.bfloat16)
    out, lse = _port(q, k, v, mask, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    # both accumulate in fp32 and round once to bf16: outputs may differ by
    # that one rounding step (2^-8 relative)
    np.testing.assert_allclose(out.float().numpy(), want_out, atol=ATOL, rtol=2.0 ** -8)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=1e-6)


def test_masked_keys_take_no_weight():
    q, k, v, mask = _inputs(2, 2, 20, 50, 16, seed=3, mask_kind="random")
    out, lse = _port(q, k, v, mask)
    k2 = np.where(mask[:, None, :, None], 555.0, k).astype(np.float32)
    v2 = np.where(mask[:, None, :, None], -555.0, v).astype(np.float32)
    out2, lse2 = _port(q, k2, v2, mask)
    np.testing.assert_allclose(out2.numpy(), out.numpy(), atol=1e-6)
    np.testing.assert_allclose(lse2.numpy(), lse.numpy(), atol=1e-6)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    q, k, v, mask = _inputs(1, 2, 16, 40, 32, seed=5, mask_kind="random")
    # strided (B, H, ., D) views of (B, ., H, D) tensors, as the model passes them
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).transpose(1, 2)
    before = ca.LAUNCHES
    out, lse = ca.flash_cross_attention(t(q), t(k), t(v), torch.from_numpy(mask))
    assert ca.LAUNCHES == before, "a CPU call must not count as a kernel launch"
    want_out, want_lse = _port(q, k, v, mask)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-6)


@pytest.mark.parametrize("fn", [ca.flash_cross_attention, ca.flash_cross_attention_reference])
def test_dropout_not_ported(fn):
    """Named for the time both entry points refused dropout: now both drop
    by petr_tpu's hash and match its Pallas forward with dropout."""
    q, k, v, mask = _inputs(1, 2, 4, 8, 16, seed=0, mask_kind="random")
    want_out, want_lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), interpret=True,
        dropout_rate=0.1, dropout_seed=jnp.int32(5),
    )
    out, lse = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                  torch.from_numpy(mask), dropout_rate=0.1, dropout_seed=5)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL, rtol=1e-6)


def test_wrapper_rejects_other_devices():
    q = torch.zeros(1, 1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ca.flash_cross_attention(q, q, q)
