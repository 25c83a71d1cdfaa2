"""The port's Object-DGCNN family (``models/dgcnn.py``) and multi-scale
deformable attention (``ops/deformable.py``) against petr_tpu's on the CPU.

Tiny sizes: embed 32, 2 layers, 16 queries, 16x16 BEV grids, 300 points of
5 features (some padded, some outside the range, some just below its lower
edges, where ``pillar_scatter``'s truncation and ``pillar_decorate``'s floor
part). Params are petr_tpu's ``init`` draws with every leaf nudged by
N(0, 0.02) (so that its zero kernels are not zero), carried across by
``utils.convert.state_dict_from_jax``, which raises on a leaf it cannot
place or a port key it leaves unfilled. fp32, eval mode. Tolerances: the
pillar grids and decorations within 1e-5 (fp32 means, summed in other
orders), their ids and masks exactly; deformable attention within 1e-5;
the heads' logits and box codes within 1e-4 (centres in metres), their
input gradients within 1e-4 of the largest entry (fp32 sums in other
orders); ObjDGCNN (the SECOND convs between) within 2e-4, its points'
gradient within 2e-4 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petr_tpu.models import dgcnn as jd
from petr_tpu.ops import deformable as jdef
from petr_tpu_torch.models import dgcnn as td
from petr_tpu_torch.models.layers import MultiheadAttention
from petr_tpu_torch.ops import deformable as tdef
from petr_tpu_torch.utils import state_dict_from_jax

PC = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
GRID = (16, 16)
C, Q, LAYERS = 32, 16, 2
TOL, GRAD_RTOL, OBJ_TOL = 1e-4, 1e-4, 2e-4
PILLAR_TOL, DEF_TOL = 1e-5, 1e-5
HEAD_KW = dict(num_classes=10, embed_dim=C, num_query=Q, num_layers=LAYERS, num_heads=4, ffn_dim=64, knn=5)
OBJ_KW = dict(embed_dim=C, grid_hw=GRID, num_query=Q, num_layers=LAYERS, pillar_channels=8,
              backbone_channels=(8, 16, 32), backbone_layer_nums=(1, 2, 1), neck_channels=(8, 8, 8))


def _points(seed=0, B=2, P=300):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-60, 60, (B, P, 2)), rng.uniform(-6, 4, (B, P, 1)),
                          rng.rand(B, P, 2)], -1).astype(np.float32)
    pts[:, :10, 0] = -51.2 - rng.uniform(0.1, 3.0, 10)  # just below x's edge: trunc -> 0, floor -> -1
    pts[:, 10:20, 1] = -51.2 - rng.uniform(0.1, 3.0, 10)
    pts[:, 20:40, :2] = pts[:, 40:41, :2] + rng.uniform(-1, 1, (B, 20, 2))  # a crowded pillar
    valid = rng.rand(B, P) < 0.9
    return pts, valid


def _nudged(params, seed=0, scale=0.02):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda x: np.asarray(x) + scale * rng.randn(*np.shape(x)).astype(np.float32),
                                  jax.device_get(params))


def _close_grad(got, want, rtol, what):
    err = np.abs(got - want).max()
    assert np.abs(want).max() > 0, f"{what}: no gradient"
    assert err <= rtol * np.abs(want).max(), f"{what}: {err:.3e}"


# ------------------------------------------------------------------ pillars
@pytest.mark.parametrize("fn", ["pillar_scatter", "pillar_decorate"])
def test_pillars_match(fn):
    pts, valid = _points()
    for b in range(2):  # petr_tpu's functions take one sample
        want = getattr(jd, fn)(jnp.asarray(pts[b]), jnp.asarray(valid[b]), PC, GRID)
        got = getattr(td, fn)(torch.from_numpy(pts[b]), torch.from_numpy(valid[b]), PC, GRID)
        if fn == "pillar_scatter":
            want, got = (want,), (got,)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=PILLAR_TOL, atol=PILLAR_TOL)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    batched = getattr(td, fn)(torch.from_numpy(pts), torch.from_numpy(valid), PC, GRID)
    single = getattr(td, fn)(torch.from_numpy(pts[1]), torch.from_numpy(valid[1]), PC, GRID)
    first = lambda x: x if fn == "pillar_scatter" else x[0]  # noqa: E731
    assert torch.equal(first(batched)[1], first(single))


def test_pillar_index_rounding_differs_as_in_petr_tpu():
    """``pillar_scatter`` truncates toward zero, ``pillar_decorate`` floors."""
    pts = np.array([[-51.7, 0.0, 0.0, 1.0, 1.0]], np.float32)
    valid = np.array([True])
    grid = td.pillar_scatter(torch.from_numpy(pts), torch.from_numpy(valid), PC, GRID)
    _, flat, inb = td.pillar_decorate(torch.from_numpy(pts), torch.from_numpy(valid), PC, GRID)
    assert grid[..., -1].sum() == 1.0 and not inb[0] and flat[0] == GRID[0] * GRID[1]


# ------------------------------------------------------- deformable attention
def test_ms_deformable_attention_matches():
    rng = np.random.RandomState(3)
    B, Qn, nh, dh, P = 2, 7, 4, 8, 3
    shapes = ((9, 13), (5, 7))
    vals = [rng.randn(B, h, w, nh, dh).astype(np.float32) for h, w in shapes]
    ref = rng.rand(B, Qn, 2).astype(np.float32)
    off = (3 * rng.randn(B, Qn, nh, len(shapes), P, 2)).astype(np.float32)  # some outside the maps
    w = rng.rand(B, Qn, nh, len(shapes), P).astype(np.float32)
    want = jdef.ms_deformable_attention([jnp.asarray(v) for v in vals], *map(jnp.asarray, (ref, off, w)))
    got = tdef.ms_deformable_attention([torch.from_numpy(v) for v in vals], *map(torch.from_numpy, (ref, off, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DEF_TOL, atol=DEF_TOL)


@pytest.fixture(scope="module")
def msda():
    rng = np.random.RandomState(4)
    B, Qn, L = 2, 7, 2
    query = rng.randn(B, Qn, C).astype(np.float32)
    levels = [rng.randn(B, h, w, C).astype(np.float32) for h, w in ((10, 12), (5, 6))]
    ref = rng.rand(B, Qn, 2).astype(np.float32)
    jmod = jdef.MSDeformableAttention(C, num_heads=4, num_points=3)
    args = (jnp.asarray(query), [jnp.asarray(v) for v in levels], jnp.asarray(ref))
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), *args)["params"])
    return jmod, params, (query, levels, ref), L


def test_msda_module_and_functional_forward_match(msda):
    jmod, params, (query, levels, ref), L = msda
    params = _nudged(params, 5, 0.1)
    model = tdef.MSDeformableAttention(C, num_heads=4, num_points=3, num_levels=L)
    model.load_state_dict(state_dict_from_jax(params, model))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(query), [jnp.asarray(v) for v in levels],
                                 jnp.asarray(ref)))
    got = model(torch.from_numpy(query), [torch.from_numpy(v) for v in levels], torch.from_numpy(ref))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=DEF_TOL, atol=DEF_TOL)
    names = {"sampling_offsets": "sampling_offsets", "attn_weights": "attention_weights",
             "value_proj": "value_proj", "out_proj": "out_proj"}
    kw = {f"{k}_{leaf[0] if leaf == 'bias' else 'w'}": params[v][leaf] for k, v in names.items()
          for leaf in ("kernel", "bias")}
    jfun = jdef.deformable_attention_module_forward(
        jnp.asarray(query), [jnp.asarray(v) for v in levels], jnp.asarray(ref), num_heads=4, num_points=3,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    tfun = tdef.deformable_attention_module_forward(
        torch.from_numpy(query), [torch.from_numpy(v) for v in levels], torch.from_numpy(ref), num_heads=4,
        num_points=3, **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()})
    np.testing.assert_allclose(tfun.numpy(), np.asarray(jfun), rtol=DEF_TOL, atol=DEF_TOL)
    np.testing.assert_allclose(tfun.numpy(), want, rtol=DEF_TOL, atol=DEF_TOL)


def test_msda_init_matches_petr_tpu(msda):
    jmod, params, _, L = msda
    model = tdef.MSDeformableAttention(C, num_heads=4, num_points=3, num_levels=L)
    for name in ("sampling_offsets", "attention_weights"):
        assert torch.count_nonzero(getattr(model, name).weight) == 0
        np.testing.assert_array_equal(np.asarray(params[name]["kernel"]), 0.0)
    assert torch.count_nonzero(model.attention_weights.bias) == 0
    ring = model.sampling_offsets.bias.detach().numpy()
    np.testing.assert_allclose(ring, np.asarray(params["sampling_offsets"]["bias"]), atol=1e-6)
    # head h points along angle 2 pi h / 4, scaled so its larger coordinate is (point index + 1)
    r = ring.reshape(4, L, 3, 2)
    np.testing.assert_allclose(r[1, 0, 2], [0.0, 3.0], atol=1e-6)
    np.testing.assert_allclose(np.abs(r).max(-1), np.broadcast_to(np.arange(1, 4)[None, None], (4, L, 3)), atol=1e-6)
    for name in ("value_proj", "out_proj"):  # flax's lecun-normal: std 1/sqrt(fan_in), truncated at 2 std
        w = getattr(model, name).weight.detach().numpy()
        assert np.abs(w).max() <= 2.0 / np.sqrt(C) / 0.87962566103423978 + 1e-6
        assert torch.count_nonzero(getattr(model, name).bias) == 0


# ------------------------------------------------------------------ heads
def _bev(seed=6, B=2, cin=24):
    return np.random.RandomState(seed).randn(B, *GRID, cin).astype(np.float32)


def _head_pair(attn_kind, decoder_kind, bev):
    jhead = jd.DGCNN3DHead(attn_kind=attn_kind, decoder_kind=decoder_kind, **HEAD_KW)
    params = _nudged(jax.jit(jhead.init)(jax.random.PRNGKey(1), jnp.asarray(bev))["params"])
    head = td.DGCNN3DHead(in_channels=bev.shape[-1], attn_kind=attn_kind, decoder_kind=decoder_kind,
                          **HEAD_KW).eval()
    head.load_state_dict(state_dict_from_jax(params, head))
    return jhead, params, head


def _compare(jfn, tfn, x, tol, grad_rtol, what):
    rng = np.random.RandomState(7)
    jx = jnp.asarray(x)
    cots = {k: rng.randn(*v.shape).astype(np.float32) for k, v in jax.eval_shape(jfn, jx).items()}

    def outputs_and_grad(v, c):
        out, vjp = jax.vjp(jfn, v)
        return out, vjp(c)[0]

    want, jgrad = jax.jit(outputs_and_grad)(jx, {k: jnp.asarray(v) for k, v in cots.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(xt)
    for k in ("cls_logits", "bbox_codes"):
        assert got[k].shape == want[k].shape and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=tol, atol=tol,
                                   err_msg=f"{what} {k}")
    sum((got[k] * torch.from_numpy(c)).sum() for k, c in cots.items()).backward()
    _close_grad(xt.grad.numpy(), np.asarray(jgrad), grad_rtol, what)


KINDS = [(a, d) for a in ("dense", "deformable") for d in ("inline", "deformable_detr")]


@pytest.fixture(scope="module")
def heads():
    """(attn_kind, decoder_kind) -> (petr_tpu head, its nudged params, the port's head carrying them)."""
    bev = _bev()
    return bev, {kinds: _head_pair(*kinds, bev) for kinds in KINDS}


@pytest.fixture(scope="module")
def obj():
    pts, valid = _points(9)
    jmodel = jd.ObjDGCNN(**OBJ_KW)
    params = _nudged(jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.asarray(pts), jnp.asarray(valid))["params"])
    model = td.ObjDGCNN(**OBJ_KW).eval()
    model.load_state_dict(state_dict_from_jax(params, model))
    return jmodel, params, model, pts, valid


@pytest.mark.parametrize("kinds", KINDS, ids=lambda k: "-".join(k))
def test_dgcnn_head_matches(heads, kinds):
    bev, pairs = heads
    jhead, params, head = pairs[kinds]
    _compare(lambda x: jhead.apply({"params": params}, x), head, bev, TOL, GRAD_RTOL, "/".join(kinds))


def test_dgcnn_attn_takes_the_largest_distances():
    """The reference's top-K picks the K FARTHEST queries (reproduced): the
    neighbours of query 0 are the K with the largest distances."""
    q = torch.from_numpy(np.random.RandomState(8).randn(1, 12, C).astype(np.float32))
    attn = td.DGCNNAttn(C, K=4)
    feats = attn._edge_feats(q)  # (1, 12, 4, 2C)
    d = (q[0, 0] - q[0]).norm(dim=-1)
    far = set(torch.topk(d, 4).indices.tolist())
    got = {int((q[0] == n).all(-1).nonzero()[0]) for n in feats[0, 0, :, :C]}
    assert got == far and 0 not in got
    assert torch.equal(feats[0, 0, :, C:], q[0, 0].expand(4, C))


def test_obj_dgcnn_matches(obj):
    jmodel, params, model, pts, valid = obj
    _compare(lambda x: jmodel.apply({"params": params}, x, jnp.asarray(valid)),
             lambda x: model(x, torch.from_numpy(valid)), pts, OBJ_TOL, OBJ_TOL, "ObjDGCNN")
    # the canvas: a feature in occupied pillars only
    with torch.no_grad():
        canvas = model.pts_voxel_encoder(torch.from_numpy(pts), torch.from_numpy(valid))
    occupied = td.pillar_scatter(torch.from_numpy(pts), torch.from_numpy(valid), PC, GRID)[..., -1] > 0
    assert canvas.shape == (2, 8, *GRID)
    assert not ((canvas.abs().sum(1) > 0) & ~occupied).any()


def test_converter_carries_every_family(heads, obj):
    """Every flax tree of the family maps with nothing skipped and nothing
    unfilled: the keys are exactly the port's, every leaf placed."""
    trees = [(params, head) for _, params, head in heads[1].values()] + [(obj[1], obj[2])]
    for params, model in trees:
        sd = state_dict_from_jax(params, model)
        assert set(sd) == set(model.state_dict())
        leaves = jax.tree_util.tree_leaves(params)
        n_mha = sum(isinstance(m, MultiheadAttention) for m in model.modules())
        assert len(sd) == len(leaves) - 4 * n_mha  # q/k/v's 6 leaves pack into in_proj's 2
        assert sum(v.numel() for v in sd.values()) == sum(np.size(x) for x in leaves)


@pytest.mark.parametrize("kinds", [("dense", "inline"), ("deformable", "deformable_detr")], ids=lambda k: "-".join(k))
def test_train_mode_draws_its_dropout_from_the_generator(kinds):
    """In train mode every dropout (DGCNNAttn's, the attentions', the FFNs')
    draws from the caller's generator: the same seed gives the same bits,
    eval mode none of them, and no generator raises."""
    torch.manual_seed(0)
    head = td.DGCNN3DHead(in_channels=24, attn_kind=kinds[0], decoder_kind=kinds[1], **HEAD_KW).train()
    bev = torch.from_numpy(_bev())
    a = head(bev, generator=torch.Generator().manual_seed(3))
    b = head(bev, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], b[k]) for k in a)
    with torch.no_grad():
        ev = head.eval()(bev)
    assert not torch.equal(a["cls_logits"], ev["cls_logits"])
    with pytest.raises(ValueError, match="Generator"):
        head.train()(bev)
