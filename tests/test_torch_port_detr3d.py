"""The port's DETR3D (``models/detr3d.py``) against petr_tpu's on the CPU.

A tiny head (embed 32, 2 layers, 16 queries, 4 heads, FFN 64, 3 views, two
levels of 8x16 and 4x8 over a 320x800 padded image, box refinement) in
fp32 and eval mode, its params drawn by petr_tpu's ``init`` and carried
across by ``utils.convert.state_dict_from_jax`` (which raises on a leaf it
cannot place or a port key it leaves unfilled). The same numpy features
and cameras go to both. Tolerances: the projection within 1e-5 relative
(an fp32 einsum and division, in other orders) and its mask exactly; the
head's logits and box codes within 1e-4 (the codes' centres are in metres,
up to 51.2), the features' gradients within 1e-4 of their largest entry
(fp32 sums in other orders through 2 layers). The init: petr_tpu's zero
weight predictor, Xavier projections and N(0, 1) query embedding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petr_tpu.models.detr3d import Detr3DHead as JHead
from petr_tpu.models.detr3d import project_reference_points as jax_project
from petr_tpu_torch.models.detr3d import Detr3DHead, project_reference_points
from petr_tpu_torch.utils import named_parameters_from_jax, state_dict_from_jax
from tests.test_heads import make_cams

B, N, C, Q, LAYERS = 1, 3, 32, 16, 2
LEVELS = ((8, 16), (4, 8))
PAD_HW = (320, 800)
PC = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
OUT_TOL, GRAD_RTOL, PROJ_RTOL = 1e-4, 1e-4, 1e-5
KW = dict(num_classes=10, embed_dim=C, num_query=Q, num_layers=LAYERS, num_heads=4, ffn_dim=64)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(B, N, h, w, C).astype(np.float32) for h, w in LEVELS]
    l2i = np.linalg.inv(make_cams(B, N)).astype(np.float32)
    return feats, l2i


@pytest.fixture(scope="module")
def run():
    feats, l2i = _inputs()
    jhead = JHead(**KW)
    init = jax.jit(lambda k, fs, m: jhead.init(k, fs, m, PAD_HW))
    params = jax.device_get(init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats], jnp.asarray(l2i))["params"])
    head = Detr3DHead(in_channels=(C, C), num_cams=N, **KW).eval()
    head.load_state_dict(state_dict_from_jax(params, head))
    return params, jhead, head, feats, l2i


def test_projection_matches():
    rng = np.random.RandomState(1)
    ref = rng.rand(B, 40, 3).astype(np.float32)
    l2i = np.linalg.inv(make_cams(B, N)).astype(np.float32)
    uv, mask = project_reference_points(torch.from_numpy(ref), torch.from_numpy(l2i), PC, PAD_HW)
    juv, jmask = jax_project(jnp.asarray(ref), jnp.asarray(l2i), PC, PAD_HW)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert 0 < mask.sum() < mask.numel()  # some references seen, some not
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=PROJ_RTOL, atol=PROJ_RTOL)


def test_head_outputs_and_feature_gradients_match(run):
    params, jhead, head, feats, l2i = run
    rng = np.random.RandomState(2)

    def jfn(fs):
        out = jhead.apply({"params": params}, fs, jnp.asarray(l2i), PAD_HW)
        return out["cls_logits"], out["bbox_codes"]

    jf = [jnp.asarray(f) for f in feats]
    cots = [rng.randn(*x.shape).astype(np.float32) for x in jax.eval_shape(jfn, jf)]

    def outputs_and_grads(fs, cs):
        out, vjp = jax.vjp(jfn, fs)
        return out, vjp(cs)[0]

    (jcls, jreg), jgrads = jax.jit(outputs_and_grads)(jf, tuple(jnp.asarray(c) for c in cots))
    ft = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    out = head(ft, torch.from_numpy(l2i), PAD_HW)
    assert out["cls_logits"].shape == (LAYERS, B, Q, 10) and out["bbox_codes"].shape == (LAYERS, B, Q, 10)
    for k, want in (("cls_logits", jcls), ("bbox_codes", jreg)):
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want), rtol=OUT_TOL, atol=OUT_TOL, err_msg=k)
    (out["cls_logits"] * torch.from_numpy(cots[0]) + 0).sum().add(
        (out["bbox_codes"] * torch.from_numpy(cots[1])).sum()).backward()
    for lvl, (f, g) in enumerate(zip(ft, jgrads)):
        g = np.asarray(g)
        assert np.abs(g).max() > 0, f"level {lvl}: no gradient reaches the features"
        err = np.abs(f.grad.numpy() - g).max()
        assert err <= GRAD_RTOL * np.abs(g).max(), f"level {lvl}: {err:.3e}"


def test_parameter_gradients_carry_back(run):
    """``named_parameters_from_jax`` lays petr_tpu's gradient tree on the
    port's names, and the port's gradients agree with it."""
    params, jhead, head, feats, l2i = run
    jf = [jnp.asarray(f) for f in feats]
    jgrads = jax.jit(jax.grad(lambda p: jhead.apply({"params": p}, jf, jnp.asarray(l2i), PAD_HW)["bbox_codes"].sum()))(params)
    want = named_parameters_from_jax(jax.device_get(jgrads), head)
    head.zero_grad()
    head([torch.from_numpy(f) for f in feats], torch.from_numpy(l2i), PAD_HW)["bbox_codes"].sum().backward()
    top = max(np.abs(w.numpy()).max() for w in want.values())
    assert set(want) == {n for n, _ in head.named_parameters()}
    for n, p in head.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()  # the cls branches'
        err = np.abs(got - want[n].numpy()).max()
        assert err <= GRAD_RTOL * max(np.abs(want[n].numpy()).max(), 1e-2 * top), f"{n}: {err:.3e}"


def test_converter_fills_every_key(run):
    params, _, head, _, _ = run
    sd = state_dict_from_jax(params, head)
    assert set(sd) == set(head.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(params))
    # q/k/v (6 leaves) pack into in_proj's 2 tensors, one self-attention per layer
    assert len(sd) == n_leaves - 4 * LAYERS


def test_init_matches_petr_tpu():
    head = Detr3DHead(embed_dim=256)
    layer = head.layer0
    assert torch.count_nonzero(layer.cross_attn.attention_weights.weight) == 0
    assert torch.count_nonzero(layer.cross_attn.attention_weights.bias) == 0
    assert torch.count_nonzero(layer.cross_attn.output_proj.bias) == 0
    for w in (layer.cross_attn.output_proj.weight, layer.cross_attn.pos_fc1.weight,
              layer.self_attn.attn.out_proj.weight, layer.ffn.layers[1].weight):
        w = w.detach().numpy()
        bound = np.sqrt(6.0 / sum(w.shape))  # Xavier-uniform
        assert np.abs(w).max() <= bound * (1 + 1e-6)
        np.testing.assert_allclose(w.std(), bound / np.sqrt(3), rtol=0.05)
    assert torch.count_nonzero(layer.self_attn.attn.out_proj.bias) == 0
    ffn_bias = layer.ffn.layers[0][0].bias.detach().numpy()  # torch's default bias: U(+-1/sqrt(fan_in))
    assert 0 < np.abs(ffn_bias).max() <= 1 / np.sqrt(256)
    q = head.query_embedding.detach().numpy()
    assert q.shape == (900, 512)
    np.testing.assert_allclose([q.mean(), q.std()], [0.0, 1.0], atol=0.01)
    jp = jax.jit(lambda k: JHead(num_layers=1).init(k, [jnp.zeros((1, 6, 4, 4, 256))] * 4,
                                                     jnp.asarray(np.tile(np.eye(4, dtype=np.float32), (1, 6, 1, 1))),
                                                     (32, 32)))(jax.random.PRNGKey(0))["params"]
    np.testing.assert_array_equal(np.asarray(jp["layer0"]["cross_attn"]["attention_weights"]["kernel"]), 0.0)
    np.testing.assert_allclose(np.asarray(jp["query_embedding"]).std(), 1.0, atol=0.01)
    for name in ("reference_points",):
        w = getattr(head, name).weight.detach().numpy()
        jb = np.sqrt(6.0 / (256 + 3))
        assert np.abs(w).max() <= jb and np.abs(np.asarray(jp[name]["kernel"])).max() <= jb
        assert torch.count_nonzero(getattr(head, name).bias) == 0


def test_train_mode_draws_its_dropout_from_the_generator():
    torch.manual_seed(0)
    head = Detr3DHead(in_channels=(C, C), num_cams=N, **KW).train()
    feats, l2i = _inputs()
    args = ([torch.from_numpy(f) for f in feats], torch.from_numpy(l2i), PAD_HW)
    a = head(*args, generator=torch.Generator().manual_seed(3))
    b = head(*args, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], b[k]) for k in a)
    with torch.no_grad():
        assert not torch.equal(a["bbox_codes"], head.eval()(*args)["bbox_codes"])
    with pytest.raises(ValueError, match="Generator"):
        head.train()(*args)
