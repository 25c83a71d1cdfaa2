"""The attention's dropout and backward (petr_tpu_torch.ops.cross_attention)
against petr_tpu's Pallas flash attention, run in interpret mode on the CPU.

* the keep-mask hash equals `_dropout_keep` bit for bit;
* the plain forward with dropout equals `_flash_forward(dropout_rate, seed)`;
* the plain backward equals `jax.vjp` of `flash_cross_attention` (rate 0 and
  0.1) and of `flash_cross_attention_with_lse` with an lse cotangent, and
  torch autograd through the plain forward.

Shapes cover masked keys, Q and L off the Pallas blocks (128, 512) and a
fully masked batch row. fp32 throughout, tolerance 2e-5 as
`tests/test_torch_port_attention.py` uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petr_tpu.ops.pallas.cross_attention import (
    _dropout_keep,
    _flash_forward,
    flash_cross_attention as jax_fca,
    flash_cross_attention_with_lse as jax_fcal,
)
from petr_tpu_torch.ops import cross_attention as ca

ATOL = 2e-5


@pytest.mark.parametrize(
    "seed,bh,qi,ki,BQ,bk,rate",
    [
        (0, 0, 0, 0, 8, 16, 0.1),
        (-5, 3, 2, 7, 128, 512, 0.5),  # a negative int32 seed: its bits as uint32
        (2**31 - 1, 7, 1, 0, 32, 64, 0.1),
        (-(2**31), 65, 3, 11, 16, 32, 0.5),
        (123456, 1000, 40, 90, 128, 128, 0.1),  # rows and columns past 2^12
    ],
)
def test_hash_matches_dropout_keep_bit_for_bit(seed, bh, qi, ki, BQ, bk, rate):
    want = np.asarray(_dropout_keep(jnp.int32(seed), bh, qi, ki, BQ, bk, rate))
    got = ca._dropout_keep(seed, bh, qi, ki, BQ, bk, rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1 - rate)) < 0.05


def test_dense_mask_is_the_blockwise_hash():
    seed, B, H, Q, L, rate = 77, 2, 3, 40, 70, 0.1
    dense = ca.dropout_keep_mask(seed, B, H, Q, L, rate)
    for b, h in ((0, 0), (1, 2)):
        block = ca._dropout_keep(seed, b * H + h, 0, 0, Q, L, rate)
        assert torch.equal(dense[b, h], block)


def _inputs(B, H, Q, L, D, seed, mask_kind):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, n, D).astype(np.float32) for n in (Q, L, L))
    mask = None
    if mask_kind is not None:
        mask = rng.rand(B, L) < 0.3
        if mask_kind == "row":
            mask[-1] = True  # the last batch row is all padding
    g = rng.randn(B, H, Q, D).astype(np.float32)
    glse = rng.randn(B, H, Q).astype(np.float32)
    return q, k, v, mask, g, glse


CASES = [
    (1, 2, 128, 512, 16, None),  # unmasked, block-aligned
    (2, 2, 130, 520, 16, "random"),  # Q, L off the Pallas blocks
    (2, 1, 37, 61, 32, "row"),  # one batch row fully masked
]


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("B,H,Q,L,D,mask_kind", CASES)
def test_plain_forward_with_dropout_matches_pallas(B, H, Q, L, D, mask_kind, rate):
    q, k, v, mask, _, _ = _inputs(B, H, Q, L, D, Q + L, mask_kind)
    want_out, want_lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None if mask is None else jnp.asarray(mask),
        interpret=True, dropout_rate=rate, dropout_seed=jnp.int32(-3),
    )
    out, lse = ca.flash_cross_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), None if mask is None else torch.from_numpy(mask),
        dropout_rate=rate, dropout_seed=-3,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL, rtol=1e-6)


def _port_grads(q, k, v, mask, g, glse, rate, seed, with_lse):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    fn = ca.flash_cross_attention_with_lse if with_lse else ca.flash_cross_attention
    out, lse = fn(tq, tk, tv, tm, rate, seed)
    loss = (out * torch.from_numpy(g)).sum()
    if with_lse:
        live = lse < 1e29  # the +1e30 sentinel of a fully masked row
        loss = loss + (torch.where(live, lse, 0.0) * torch.from_numpy(glse)).sum()
    loss.backward()
    return tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()


@pytest.mark.parametrize("rate,with_lse", [(0.0, False), (0.1, False), (0.1, True)],
                         ids=["rate0", "rate0.1", "rate0.1_lse_cotangent"])
@pytest.mark.parametrize("B,H,Q,L,D,mask_kind", CASES)
def test_backward_matches_jax_vjp(B, H, Q, L, D, mask_kind, rate, with_lse):
    q, k, v, mask, g, glse = _inputs(B, H, Q, L, D, Q + 2 * L, mask_kind)
    jm = None if mask is None else jnp.asarray(mask)
    seed = jnp.int32(11)
    if with_lse:
        fn = lambda q, k, v: jax_fcal(q, k, v, jm, 128, 512, True, rate, seed)
        (out, lse), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
        live = np.asarray(lse) < 1e29
        want = vjp((jnp.asarray(g), jnp.asarray(np.where(live, glse, 0.0))))
    else:
        fn = lambda q, k, v: jax_fca(q, k, v, jm, 128, 512, True, rate, seed)
        _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
        want = vjp(jnp.asarray(g))
    got = _port_grads(q, k, v, mask, g, glse, rate, 11, with_lse)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, err_msg=f"d{name}")
    if mask_kind == "row":
        assert not got[0][-1].any() and not got[1][-1].any() and not got[2][-1].any()


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_backward_matches_autograd_through_plain_forward(rate):
    q, k, v, mask, g, glse = _inputs(2, 2, 33, 70, 16, 4, "random")
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tm = torch.from_numpy(mask)
    out, lse = ca.flash_cross_attention_reference(tq, tk, tv, tm, rate, 9)
    ((out * torch.from_numpy(g)).sum() + (lse * torch.from_numpy(glse)).sum()).backward()
    got = ca.flash_cross_attention_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), tm, out.detach(), lse.detach(),
        torch.from_numpy(g), torch.from_numpy(glse), rate, 9,
    )
    for name, a, b in zip("qkv", got, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, err_msg=f"d{name}")


def test_lse_takes_no_gradient_without_with_lse():
    q, k, v, mask, _, _ = _inputs(1, 1, 5, 9, 16, 6, "random")
    tq = torch.from_numpy(q).requires_grad_()
    out, lse = ca.flash_cross_attention(tq, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mask))
    assert out.requires_grad and not lse.requires_grad
    _, lse2 = ca.flash_cross_attention_with_lse(tq, torch.from_numpy(k), torch.from_numpy(v))
    assert lse2.requires_grad


def test_plain_route_counts_no_launches_and_matches():
    q, k, v, mask, g, _ = _inputs(1, 2, 20, 30, 16, 8, "random")
    before = (ca.LAUNCHES, ca.DKDV_LAUNCHES, ca.DQ_LAUNCHES)
    grads = []
    for fn in (ca.flash_cross_attention, ca.flash_cross_attention_plain):
        tq = torch.from_numpy(q).requires_grad_()
        out, _ = fn(tq, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mask), 0.1, 3)
        (out * torch.from_numpy(g)).sum().backward()
        grads.append(tq.grad)
    assert torch.equal(grads[0], grads[1])
    assert (ca.LAUNCHES, ca.DKDV_LAUNCHES, ca.DQ_LAUNCHES) == before


@pytest.mark.parametrize("rate", [-0.1, 1.0])
def test_kernel_arguments_refuse_bad_rates(rate):
    with pytest.raises(ValueError, match="dropout_rate"):
        ca._dropout_args(rate, 0)
