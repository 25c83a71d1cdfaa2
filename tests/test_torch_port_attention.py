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


# ------------------------------------------------ the bf16 kernel's rounding floor
# round_p=True rounds p to bf16 for its product with v, where the bf16 kernel
# does; petr_tpu's Pallas forward does not round p. The rounding moves each
# output by about 2^-9 of its terms' root sum of squares: within
# atol * max|ref| + rtol * |ref| with (atol, rtol) = (4e-3, 1.6e-2), of which
# it took 0.27-0.33 at these shapes. The lse comes from the unrounded p in
# both: within ATOL.
FLOOR_TOL = (4e-3, 1.6e-2)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,H,Q,L,D", [(2, 2, 130, 520, 32), (2, 4, 37, 61, 16), (2, 1, 64, 300, 64)])
def test_rounding_floor_matches_pallas_forward_in_bf16(rate, B, H, Q, L, D):
    q, k, v, mask = _inputs(B, H, Q, L, D, seed=Q + 2 * L, mask_kind="row")
    want_out, want_lse = _flash_forward(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(mask), interpret=True,
        dropout_rate=rate, dropout_seed=jnp.int32(5))
    want_out, want_lse = np.asarray(want_out.astype(jnp.float32)), np.asarray(want_lse)
    t = lambda a: torch.from_numpy(a).bfloat16()
    out, lse = ca.flash_cross_attention_reference(t(q), t(k), t(v), torch.from_numpy(mask), rate, 5, round_p=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    atol, rtol = FLOOR_TOL
    err = np.abs(out.float().numpy() - want_out)
    assert (err <= atol * np.abs(want_out).max() + rtol * np.abs(want_out)).all(), err.max()
    assert err.max() > 0  # p was rounded
    live = want_lse < 1e29
    np.testing.assert_allclose(lse.numpy()[live], want_lse[live], atol=ATOL, rtol=1e-6)
    assert (out[-1] == 0).all() and (lse[-1] == 1e30).all()


def test_rounding_floor_rounds_only_p():
    """With every p exact in bf16 (one unmasked key per row: p = 1) the floor
    equals the unrounded plain version, and the logits are taken in log2 units
    with the kernel's fp32 scale."""
    q, k, v, _ = _inputs(2, 2, 16, 40, 32, seed=9, mask_kind=None)
    mask = np.ones((2, 40), bool)
    mask[:, 7] = False
    t = lambda a: torch.from_numpy(a).bfloat16()
    a = ca.flash_cross_attention_reference(t(q), t(k), t(v), torch.from_numpy(mask), round_p=True)
    b = ca.flash_cross_attention_reference(t(q), t(k), t(v), torch.from_numpy(mask))
    assert torch.equal(a[0], b[0])
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), atol=ATOL)
    assert ca.logit_scale_log2(32) == np.float32(np.float32(1 / np.sqrt(32)) * np.float32(ca.LOG2E))


# ------------------------------------------------------ the bf16 kernel's plan
@pytest.mark.parametrize("bh,Q,sms,want", [(8, 900, 132, 2), (16, 900, 132, 4), (48, 900, 132, 4),
                                           (8, 900, 114, 4), (1, 1, 132, 2)])
def test_attention_plan(bh, Q, sms, want):
    """64-row blocks where they reach one block per SM, else 32-row blocks:
    at the flagship (8 heads, Q = 900) 120 blocks of 64 rows would leave 12 of
    132 SMs idle, so 232 of 32 rows."""
    assert ca.attention_plan(bh, Q, sms) == want


@pytest.mark.parametrize("query_warps", [2, 4])
@pytest.mark.parametrize("L", [1, 63, 64, 255, 256, 257, 6000, 16896])
def test_key_split_plan_covers_every_key_once(query_warps, L):
    plan = ca.key_split_plan(L, query_warps)
    assert len(plan) == 8 // query_warps
    keys = [k for ranges in plan for lo, hi in ranges for k in range(lo, hi)]
    assert sorted(keys) == list(range(L))
    for ranges in plan:  # each split walks its ranges in key order, 64 keys at most each
        assert all(lo < hi <= lo + 64 for lo, hi in ranges)
        assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))


def _split_forward(q, k, v, mask, query_warps):
    """The bf16 kernel's two passes in fp32 over ``key_split_plan``: each
    split's row maxima, their maximum, each split's partial (l, P V) against
    it, added in split order; out = acc / l."""
    t = torch.matmul(q.float(), k.float().transpose(-1, -2)) * ca.logit_scale_log2(q.shape[-1])
    t = t.masked_fill(mask[:, None, None, :], ca.NEG)
    plan = ca.key_split_plan(k.shape[2], query_warps)
    cols = [torch.tensor([c for lo, hi in ranges for c in range(lo, hi)], dtype=torch.long) for ranges in plan]
    m = torch.stack([t[..., c].amax(-1) for c in cols]).amax(0, keepdim=False)[..., None]
    l = acc = 0
    for c in cols:  # fixed order: split 0, 1, ...
        p = torch.exp2(t[..., c] - m).masked_fill(mask[:, None, None, c], 0.0)
        l = l + p.sum(-1, keepdim=True)
        acc = acc + torch.matmul(p.bfloat16().float(), v.float()[..., c, :])
    return acc / l.clamp(min=1e-20)


@pytest.mark.parametrize("query_warps", [2, 4])
def test_split_forward_equals_the_rounding_floor(query_warps):
    """Partial sums against each row's exact maximum need no rescaling: added
    in split order they give the floor (fp32 sums in another order, 1e-6 of
    the largest output)."""
    q, k, v, mask = _inputs(2, 2, 33, 700, 32, seed=2, mask_kind="row")
    t = lambda a: torch.from_numpy(a).bfloat16()
    q, k, v, mask = t(q), t(k), t(v), torch.from_numpy(mask)
    got = _split_forward(q, k, v, mask, query_warps)
    want, _ = ca.flash_cross_attention_reference(q, k, v, mask, round_p=True)
    scale = want.float().abs().max()
    # against the floor before its bf16 output rounding: one bf16 step of |ref| plus fp32 noise
    assert ((got - want.float()).abs() <= 2.0 ** -8 * want.float().abs() + 1e-6 * scale).all()
    assert torch.equal(got, _split_forward(q, k, v, mask, query_warps))  # the same order, the same bits
