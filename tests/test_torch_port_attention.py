"""K1's plain version (petr_tpu_torch.ops.cross_attention) against the Pallas
flash forward of petr_tpu, run in interpret mode on the CPU.

Both return (out, lse); fully masked rows must give out 0 and lse +1e30 in
both. fp32 tolerance 2e-5, as `tests/test_pallas_attention.py` uses.
"""

import math

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


# ------------------------------------------ the bf16 kernels' plan and tiling
PHASE3_LS = (960, 3000, 6000, 12000, 16896)  # chip_smoke.py phase 3's key counts


@pytest.mark.parametrize("batch_heads", [8, 16])
@pytest.mark.parametrize("L", PHASE3_LS + (1, 64, 65))
def test_forward_plan_covers_every_key_once(batch_heads, L):
    """The forward's key splits cover every key once, in order, within the
    kernel's list of at most MAX_SPLIT_TILES tiles, each split with two tiles
    or more where the keys have them; the blocks fill the card's two slots
    per SM at most once (132 SMs)."""
    splits = ca.forward_splits(batch_heads, 900, L, 132)
    ranges = ca.split_tiles(L, splits)
    tiles = [t for lo, hi in ranges for t in range(lo, hi)]
    assert tiles == list(range(-(-L // ca.KEY_TILE)))
    assert all(hi - lo <= ca.MAX_SPLIT_TILES for lo, hi in ranges)
    assert all(hi - lo >= min(2, len(tiles)) for lo, hi in ranges)
    blocks = -(-900 // ca.BLOCK_ROWS) * batch_heads * splits
    assert blocks <= 2 * 132 or splits == 1
    if batch_heads == 8 and L >= 6000:  # the flagship's 120 row tiles: split in two
        assert splits == 2


def _grid(B, H, Q, L, D, seed, masked_row=True):
    """bf16 inputs on a grid of 1/8 (every q.k exact in fp32), a key mask
    with a padded tail and a fully masked last batch row."""
    rng = np.random.RandomState(seed)
    q, k, v = (np.clip(np.round(rng.randn(B, H, n, D) * 8), -32, 32) / 8 for n in (Q, L, L))
    mask = rng.rand(B, L) < 0.2
    mask[:, L - L // 8:] = True
    mask[0, :3] = True  # the first unmasked key is not key 0
    if masked_row:
        mask[-1] = True
    t = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16()
    return t(q), t(k), t(v), torch.from_numpy(mask)


_NONE = float("-inf")


def _merge(parts):
    """(K, l, O, P) partials added in order, each rescaled by 2^(K - max K),
    exact powers of two, as the kernels merge warpgroups and splits."""
    K = torch.stack([p[0] for p in parts]).amax(0)
    out = [torch.zeros_like(parts[0][i]) for i in (1, 2, 3)]
    for Kp, *rest in parts:
        a = torch.where(Kp == _NONE, 0.0, torch.exp2(Kp - torch.where(K == _NONE, 0.0, K)))
        out = [o + r * a for o, r in zip(out, rest)]
    return (K, *out)


def _emulate_forward(q, k, v, mask, tile, splits, rate, seed=5):
    """The bf16 forward's one pass in fp32: key tiles of ``tile`` keys cut
    into ``splits`` as split_tiles cuts them, each split's live tiles taken
    by two warpgroups in turn; each keeps integer running maxima K and
    rescales its (l, O) by exact powers of two, the warpgroups are merged
    (0 first), then the splits in order. -> (out, lse, the rounded
    probabilities each key's product used, times the rescales they got)."""
    B, H, Q, D = q.shape
    L = k.shape[2]
    masked = mask[:, None, None, :]
    p_all, _, t_ref, has = ca.rounded_probabilities(q, k, masked)  # for t_ref alone
    t = torch.matmul(q.float(), k.float().transpose(-1, -2)) * ca.logit_scale_log2(D)
    y_all = torch.where(masked, -math.inf, t - t_ref)
    keep = ca.dropout_keep_mask(seed, B, H, Q, L, rate) if rate else torch.ones(B, H, Q, L, dtype=torch.bool)
    split_parts = []
    for lo, hi in ca.split_tiles(L, splits, tile):
        live_tiles = [j for j in range(lo, hi) if (~mask[:, j * tile:(j + 1) * tile]).any()]
        wg_parts = []
        for wg in range(2):
            K = torch.full((B, H, Q, 1), _NONE)
            l = torch.zeros(B, H, Q, 1)
            O = torch.zeros(B, H, Q, D)
            P = torch.zeros(B, H, Q, L)
            for j in live_tiles[wg::2]:
                c = slice(j * tile, min((j + 1) * tile, L))
                y = y_all[..., c]
                Kn = torch.maximum(K, torch.round(y.amax(-1, keepdim=True)))
                a = torch.where(K == _NONE, 0.0, torch.exp2(K - torch.where(Kn == _NONE, 0.0, Kn)))
                l, O, P, K = l * a, O * a, P * a, Kn
                n = torch.round(y)
                ok = y > K - 125
                p = torch.where(ok, torch.exp2(y - n) * torch.exp2(torch.where(ok, n - K, 0.0)), 0.0)
                l = l + p.sum(-1, keepdim=True)
                pb = p.bfloat16().float()
                P[..., c] = pb
                O = O + torch.matmul(torch.where(keep[..., c], pb, 0.0), v.float()[..., c, :])
            wg_parts.append((K, l, O, P))
        split_parts.append(_merge(wg_parts))
    K, l, O, P = _merge(split_parts)
    out = O / (1.0 - rate) / l.clamp(min=1e-20)
    lse = torch.where(has, ((t_ref + K) + torch.log2(l)) * math.log(2.0), 1e30)
    return out, lse[..., 0], P


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("tile", [16, 64, 128])
def test_one_pass_forward_rounds_p_as_the_floor(tile, splits, rate):
    """Whatever the tile width, the splits and the order, the one pass
    rounds every p to the floor's value bit for bit (running integer maxima,
    exact rescales); its output differs from the floor only by fp32 sums in
    another order, and a second run gives the same bits."""
    q, k, v, mask = _grid(2, 2, 33, 700, 32, seed=tile + splits)
    out, lse, P = _emulate_forward(q, k, v, mask, tile, splits, rate)
    p, _, _, _ = ca.rounded_probabilities(q, k, mask[:, None, None, :])
    assert torch.equal(P, p.bfloat16().float())
    want, want_lse = ca.flash_cross_attention_reference(q, k, v, mask, rate, 5, round_p=True)
    w = want.float()
    assert ((out - w).abs() <= 2.0 ** -8 * w.abs() + 1e-6 * w.abs().max()).all()
    live = want_lse < 1e29
    torch.testing.assert_close(lse[live], want_lse[live], atol=1e-5, rtol=0)
    assert (out[-1] == 0).all() and (lse[-1] == 1e30).all()
    again = _emulate_forward(q, k, v, mask, tile, splits, rate)
    assert all(torch.equal(a, b) for a, b in zip((out, lse, P), again))


def _emulate_backward(q, k, v, mask, gout, out, lse, rate, which, sms, seed=7):
    """K2's tiling in fp32. dK/dV: a block per KEY_TILE keys over query tiles
    of BLOCK_ROWS, warpgroup w taking half w of every tile's queries. dQ: a
    block per BLOCK_ROWS queries over the live key tiles of its split
    (forward_splits on ``sms`` SMs, cut by split_tiles), warpgroup w taking
    half w of every tile's keys; the splits' partial sums added in split
    order. P (after dropout) and dS rounded to bf16 for their products; the
    warpgroups' partials added 0 first. -> (gradients, the dQ splits)."""
    B, H, Q, D = q.shape
    L = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), gout.float()
    delta = ca._delta(gout, out, None)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s = s.masked_fill(mask[:, None, None, :], ca.NEG)
    p = torch.exp(torch.clamp(s - lse[..., None], max=0.0))
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    keep = ca.dropout_keep_mask(seed, B, H, Q, L, rate) if rate else torch.ones(B, H, Q, L, dtype=torch.bool)
    kp = 1.0 - rate
    pd = torch.where(keep, p / kp, 0.0).bfloat16().float()
    ds = (p * (torch.where(keep, dp / kp, 0.0) - delta[..., None])).bfloat16().float()
    if which == "dq":
        tile, half = ca.KEY_TILE, ca.KEY_TILE // 2
        splits = ca.forward_splits(B * H, Q, L, sms)
        dq = torch.zeros(B, H, Q, D)
        for lo, hi in ca.split_tiles(L, splits):
            live = [j for j in range(lo, hi) if (~mask[:, j * tile:(j + 1) * tile]).any()]
            part = torch.zeros(B, H, Q, D)
            for wg in range(2):
                acc = torch.zeros(B, H, Q, D)
                for j in live:
                    c = slice(j * tile + wg * half, min(j * tile + (wg + 1) * half, L))
                    acc = acc + torch.matmul(ds[..., c], kf[..., c, :])
                part = part + acc
            dq = dq + part
        return (dq * scale,), splits
    rows, half = ca.BLOCK_ROWS, ca.BLOCK_ROWS // 2
    dk, dv = torch.zeros(B, H, L, D), torch.zeros(B, H, L, D)
    for wg in range(2):
        pk, pv = torch.zeros(B, H, L, D), torch.zeros(B, H, L, D)
        for q0 in range(0, Q, rows):
            r = slice(q0 + wg * half, min(q0 + (wg + 1) * half, Q))
            pk = pk + torch.matmul(ds[..., r, :].transpose(-1, -2), qf[..., r, :])
            pv = pv + torch.matmul(pd[..., r, :].transpose(-1, -2), gf[..., r, :])
        dk, dv = dk + pk, dv + pv
    return (dk * scale, dv), 1


@pytest.mark.parametrize("which,sms", [("dkdv", 132), ("dq", 6), ("dq", 132)])
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_tiling_matches_the_plain_backward(rate, D, which, sms):
    """K2's tiles, warpgroup halves, dQ's key splits and merge order give
    the plain backward's gradients within the bf16 rounding of P and dS
    (BWD_TOL of chip_smoke.py), the same bits on a second run, and exact
    zeros for the fully masked batch row and the masked keys. On 6 SMs dQ
    runs unsplit, on 132 in forward_splits' 2 splits."""
    q, k, v, mask = _grid(2, 2, 150, 300, D, seed=D + int(rate * 10))
    gout = torch.from_numpy(np.random.RandomState(1).randn(2, 2, 150, D).astype(np.float32)).bfloat16()
    out, lse = ca.flash_cross_attention_reference(q, k, v, mask, rate, 7)
    got, splits = _emulate_backward(q, k, v, mask, gout, out, lse, rate, which, sms)
    if which == "dq":
        assert splits == (1 if sms == 6 else 2)
    want = ca.flash_cross_attention_backward_reference(q, k, v, mask, out, lse, gout, None, rate, 7)
    want = want[:1] if which == "dq" else want[1:]
    for g, w in zip(got, want):
        w = w.float()
        assert ((g - w).abs() <= 4e-3 * w.abs().max() + 1.6e-2 * w.abs()).all()
        assert (g[-1] == 0).all()
    if which == "dkdv":
        assert (got[0][:, :, mask[0]] == 0).all() and (got[1][:, :, mask[0]] == 0).all()
    again, _ = _emulate_backward(q, k, v, mask, gout, out, lse, rate, which, sms)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
