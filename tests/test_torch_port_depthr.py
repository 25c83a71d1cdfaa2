"""The port's Depthr family against petr_tpu on the CPU: box corners, depth
binning, GT depth maps, the GT-depth encoder, the decoder layer, the head,
the detector, its eval step and the converter.

The detector: ``synth_small_depthr`` cut to a head of width 32 with 2
layers, 12 queries and 8 depth bins (as `tests/test_depthr.py:85-110`
sizes the head), 6 views of 64x160, fp32. One set of weights serves both:
petr_tpu's init, its norms and biases perturbed from a seed, goes to the
port through ``state_dict_from_jax``, which raises on any leaf it cannot
place (skipped == 0) and on any port parameter left unfilled (unfilled ==
0). petr_tpu's Depthr path reaches no Pallas kernel (its attention is the
plain branch), so JAX runs it as is. Tolerances are stated at each check.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petr_tpu.configs import get_config as jax_config
from petr_tpu.models import PETRDetector as JDetector
from petr_tpu.models.depth_encoder import DepthGTEncoder as JEncoder
from petr_tpu.models.depth_encoder import bin_depth_indices as j_bin
from petr_tpu.models.depth_encoder import gt_depth_maps as j_maps
from petr_tpu.models.depth_encoder import lid_bin_values as j_lid
from petr_tpu.models.depthr_head import DepthrDecoderLayer as JLayer
from petr_tpu.models.depthr_head import DepthrHead as JHead
from petr_tpu.ops.boxes import box_corners as j_corners
from petr_tpu.train.train_step import make_eval_step as jax_make_eval_step
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.models import PETRDetector
from petr_tpu_torch.models.depth_encoder import DepthGTEncoder, bin_depth_indices, gt_depth_maps, lid_bin_values
from petr_tpu_torch.models.depthr_head import DepthrDecoderLayer, DepthrHead
from petr_tpu_torch.ops.boxes import box_corners
from petr_tpu_torch.serve import make_serving_fn
from petr_tpu_torch.train import BATCH_KEYS, batch_keys, make_eval_step
from petr_tpu_torch.utils import state_dict_from_jax

PRESETS = ("synth_small_depthr", "depthr_r50_c5_512x1408_gtdepth")
N, H, W, G = 6, 64, 160, 10


def tiny(cfg):
    """``synth_small_depthr`` with the tiny head and 64x160 images."""
    head = dataclasses.replace(cfg.model.head, embed_dim=32, num_layers=2, num_query=12, num_heads=4,
                               ffn_dim=64, depth_num=4, depth_bins=8)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, head=head),
                               data=dataclasses.replace(cfg.data, image_size=(H, W), max_gt=G))


def cameras(B, n, h, w, yaw0=0.0):
    """lidar2img (B, n, 4, 4) of n outward-facing pinhole cameras for h x w
    images (focal length w / 2, principal point at the centre), the rig
    turned by ``yaw0`` more for each sample."""
    mats = np.zeros((B, n, 4, 4))
    for b in range(B):
        for i in range(n):
            yaw = 2 * np.pi * i / n + yaw0 * b
            R = np.array([[-np.sin(yaw), np.cos(yaw), 0], [0, 0, -1], [np.cos(yaw), np.sin(yaw), 0]])
            E = np.eye(4)
            E[:3, :3] = R
            E[:3, 3] = -R @ np.array([np.cos(yaw), np.sin(yaw), 1.5])
            K = np.eye(4)
            K[0, 0] = K[1, 1] = w / 2
            K[0, 2], K[1, 2] = w / 2, h / 2
            mats[b, i] = K @ E
    return mats.astype(np.float32)


def ring_boxes(rng, B, g, r=(5.0, 30.0), ahead=None):
    """(B, g, 9) boxes around the car at a distance in ``r``, any yaw; with
    ``ahead`` (B, k) bearings, the first k boxes lie within 0.2 rad of them."""
    dist, th = rng.uniform(*r, (B, g)), rng.uniform(-np.pi, np.pi, (B, g))
    if ahead is not None:
        th[:, :ahead.shape[1]] = ahead + rng.uniform(-0.2, 0.2, ahead.shape)
    return np.concatenate([
        (dist * np.cos(th))[..., None], (dist * np.sin(th))[..., None], rng.uniform(-1, 1, (B, g, 1)),
        rng.uniform(0.5, 4.0, (B, g, 3)), rng.uniform(-np.pi, np.pi, (B, g, 1)), rng.uniform(-1, 1, (B, g, 2)),
    ], -1).astype(np.float32)


def trig_agrees(yaw):
    """Where JAX's and torch's float32 cos and sin give the same bits."""
    t = torch.from_numpy(yaw)
    return ((np.asarray(jnp.cos(yaw)) == torch.cos(t).numpy())
            & (np.asarray(jnp.sin(yaw)) == torch.sin(t).numpy()))


def random_params(shapes, seed):
    """A petr_tpu param tree of ``shapes`` (from ``jax.eval_shape``) drawn
    from a seed, so that no check sees a 0 or a 1 where a value could be
    anything: kernels N(0, 1 / fan_in), norm scales 1 + N(0, 0.2), biases
    and BN means N(0, 0.1), BN variances U(0.5, 2), reference points U(0,
    1), the depth embedding N(0, 1)."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']") or name.endswith("_weight']"):
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name.endswith("['scale']"):
            return (1 + 0.2 * rng.standard_normal(s.shape)).astype(np.float32)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if name.endswith("['reference_points']"):
            return rng.uniform(0, 1, s.shape).astype(np.float32)
        if name.endswith("['depth_pos_embed']"):
            return rng.standard_normal(s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def init_params(module, seed, *args, **kwargs):
    """``random_params`` for a petr_tpu module called on ``args``."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))["params"]
    return random_params(shapes, seed)


# ------------------------------------------------------------ box corners
def test_box_corners_match():
    """Exact where the two packages' cos and sin agree (the rest of the
    arithmetic is the same products and sums); elsewhere within 2 ulp of
    the box's largest coordinate, the libms' one-ulp difference in cos or
    sin times a half-extent."""
    rng = np.random.RandomState(0)
    boxes = ring_boxes(rng, 4, 256)
    want = np.asarray(j_corners(jnp.asarray(boxes)))
    got = box_corners(torch.from_numpy(boxes)).numpy()
    assert got.shape == want.shape == (4, 256, 8, 3)
    same = trig_agrees(boxes[..., 6])
    assert same.mean() > 0.8, same.mean()
    np.testing.assert_array_equal(got[same], want[same])
    scale = np.abs(boxes[..., :6]).max(-1)[~same][:, None, None]
    assert (np.abs(got[~same] - want[~same]) <= 2 * np.spacing(scale.astype(np.float32))).all()
    # corner order: the (x, y, z) sign lattice at yaw 0
    axis = torch.tensor([[1.0, 2.0, 3.0, 2.0, 4.0, 6.0, 0.0, 0.0, 0.0]])
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    np.testing.assert_array_equal(box_corners(axis)[0].numpy(), [1, 2, 3] + signs * [1, 2, 3])


# ------------------------------------------------------------ depth binning
@pytest.mark.parametrize("mode", ["LID", "UD", "SID"])
def test_bin_depth_indices_exact(mode):
    """Held exactly, the overflow bin included: depths below depth_min,
    above depth_max, 0, negative, NaN and +-inf."""
    rng = np.random.RandomState(1)
    special = [0.0, -5.0, 1e-3, 60.0, 61.0, 100.0, np.nan, np.inf, -np.inf]
    d = np.concatenate([rng.uniform(-5, 70, 20000), special]).astype(np.float32)
    want = np.asarray(j_bin(jnp.asarray(d), mode, 1e-3, 60.0, 80))
    got = bin_depth_indices(torch.from_numpy(d), mode, 1e-3, 60.0, 80)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[-9:][[0, 1, 5, 6, 7, 8]] == 80).all()
    assert 0 < (want == 80).mean() < 0.3


def test_lid_bin_values_exact():
    for bins, lo, hi in ((80, 1e-3, 60.0), (40, 1e-3, 40.0), (8, 1e-3, 60.0)):
        np.testing.assert_array_equal(lid_bin_values(bins, lo, hi).numpy(), np.asarray(j_lid(bins, lo, hi)))


# ------------------------------------------------------------ GT depth maps
def test_gt_depth_maps_exact():
    """Held exactly on inputs whose arithmetic is exact in fp32: cameras
    looking along +-x and +-y with power-of-two intrinsics, boxes at yaw 0
    on a 1/4-metre grid. Then every projection is the same sum in any
    order, and the maps must agree bit for bit (XLA and torch sum the
    4-term projections in other orders, which moves a depth by an ulp on
    general inputs; `test_gt_depth_maps_general` holds those)."""
    B, n, h, w = 2, 4, 64, 128
    l2i = np.zeros((B, n, 4, 4), np.float32)
    K = np.array([[64.0, 0, 64, 0], [0, 64, 32, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    for b in range(B):
        for i in range(n):
            c, s = [(1, 0), (0, 1), (-1, 0), (0, -1)][i]
            R = np.array([[-s, c, 0], [0, 0, -1], [c, s, 0]], float)
            E = np.eye(4)
            E[:3, :3] = R
            E[:3, 3] = -R @ np.array([c * 0.5, s * 0.5, 1.5 + 0.25 * b])
            l2i[b, i] = K @ E
    rng = np.random.RandomState(2)
    g = 24
    boxes = np.zeros((B, g, 9), np.float32)
    boxes[..., :2] = np.round(rng.uniform(-24, 24, (B, g, 2)) * 4) / 4
    boxes[..., 2] = np.round(rng.uniform(-1, 1, (B, g)) * 4) / 4
    boxes[..., 3:6] = np.round(rng.uniform(0.5, 4, (B, g, 3)) * 4) / 4
    valid = rng.rand(B, g) < 0.85
    want = np.asarray(jax.jit(j_maps, static_argnums=(3, 4))(boxes, valid, l2i, (h, w), 8))
    got = gt_depth_maps(torch.from_numpy(boxes), torch.from_numpy(valid), torch.from_numpy(l2i), (h, w), 8)
    assert got.dtype == torch.float32 and got.shape == (B, n, h // 8, w // 8)
    assert ((want > 0).mean(axis=(2, 3)) > 0).all(), "a view with no box in it tests nothing"
    np.testing.assert_array_equal(got.numpy(), want)


def test_gt_depth_maps_general():
    """Realistic cameras and boxes at any yaw. Coverage is decided by the
    floors of the projected corners, so a last-bit difference flips a
    whole row or column where an edge lies on a grid line: the boxes are
    drawn so that no projected bbox edge, and no corner that decides
    visibility, lies within 1e-3 (pixels of the map, of the image, or
    metres of depth) of where it would switch, and the test asserts that.
    Then coverage must agree exactly, and each depth within 2 ulp (the
    projections' summation order differs between XLA and torch)."""
    B, h, w = 2, 64, 176
    l2i = cameras(B, N, h, w, yaw0=0.3)
    rng = np.random.RandomState(3)
    boxes = ring_boxes(rng, B, 4 * G)
    corners = np.asarray(j_corners(jnp.asarray(boxes)), np.float64)
    hom = np.concatenate([corners, np.ones(corners.shape[:-1] + (1,))], -1)
    uvd = np.einsum("bnij,bgkj->bngki", l2i[:, :, :3].astype(np.float64), hom)
    u, v, depth = uvd[..., 0] / uvd[..., 2], uvd[..., 1] / uvd[..., 2], uvd[..., 2]
    eps = 1e-3
    visible = (u > 0) & (u < w) & (v > 0) & (v < h) & (depth > 1.0)
    kept = visible.any(-1) & (depth > 0.1).all(-1)  # (B, N, G)
    switches = sum(np.abs(x - at) < eps for x, at in ((u, 0), (u, w), (v, 0), (v, h), (depth, 1.0), (depth, 0.1)))
    ex, ey = np.clip(u / 8, 0, w / 8), np.clip(v / 8, 0, h / 8)
    edges = [(ex.min(-1), w / 8), (ex.max(-1), w / 8), (ey.min(-1), h / 8), (ey.max(-1), h / 8)]
    on_line = sum((np.abs(e - np.round(e)) < eps) & (e != 0) & (e != end) for e, end in edges)
    near = (switches > 0).any(-1) | (kept & (on_line > 0))  # (B, N, G)
    valid = ~near.any(1)
    assert valid.sum() >= B * G, "too few boxes clear of the grid lines"
    want = np.asarray(jax.jit(j_maps, static_argnums=(3, 4))(boxes, valid, l2i, (h, w), 8))
    got = gt_depth_maps(torch.from_numpy(boxes), torch.from_numpy(valid), torch.from_numpy(l2i), (h, w), 8).numpy()
    covered = want > 0
    assert (covered.mean(axis=(2, 3)) > 0).all(), covered.mean(axis=(2, 3))
    np.testing.assert_array_equal(got > 0, covered)
    np.testing.assert_allclose(got, want, rtol=2 * 2.0 ** -23, atol=0)


def test_gt_depth_maps_take_the_nearest_box():
    """Two boxes ahead of one camera: the pixels both cover take the nearer."""
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 100.0
    K[0, 2], K[1, 2] = 64.0, 32.0
    E = np.eye(4)
    E[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]  # looks along +x
    l2i = torch.tensor((K @ E)[None, None], dtype=torch.float32)
    boxes = torch.tensor([[[10, 0, 0, 2, 2, 2, 0, 0, 0], [20, 0, 0, 8, 8, 8, 0, 0, 0]]], dtype=torch.float32)
    dm = gt_depth_maps(boxes, torch.ones(1, 2, dtype=torch.bool), l2i, (64, 128), 8)
    assert dm.shape == (1, 1, 8, 16)
    assert dm[0, 0, 4, 8].item() == 10.0 and (dm == 20.0).any()


# ------------------------------------------------------------ the encoder
def test_depth_gt_encoder_matches():
    """fp32, within 1e-5 (sums in other orders); the weighted depth exactly,
    against petr_tpu's module op by op (under ``jit`` XLA folds the bin
    values as constants, in other roundings)."""
    rng = np.random.RandomState(4)
    bins, C = 80, 64
    onehot = np.eye(bins + 1, dtype=np.float32)[rng.randint(0, bins + 1, (1, 2, 16, 24))]
    jenc = JEncoder(num_bins=bins, embed_dim=C, down_scale=4)
    params = init_params(jenc, 5, jnp.asarray(onehot))
    want_tokens, want_weighted = jenc.apply({"params": params}, jnp.asarray(onehot))
    enc = DepthGTEncoder(num_bins=bins, embed_dim=C, down_scale=4)
    sd = state_dict_from_jax({"head": {"depth_gt_encoder": params}})
    enc.load_state_dict({k[len("pts_bbox_head.depth_gt_encoder."):]: v for k, v in sd.items()})
    with torch.no_grad():
        tokens, weighted = enc(torch.from_numpy(onehot))
    assert tokens.shape == (1, 2, 4, 6, C)
    np.testing.assert_array_equal(weighted.numpy(), np.asarray(want_weighted))
    np.testing.assert_allclose(tokens.numpy(), np.asarray(want_tokens), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ decoder layer
@pytest.mark.parametrize("attend_memory", [False, True])
def test_decoder_layer_matches(attend_memory):
    """fp32, within 3e-5 (as `tests/test_torch_parity_depthr.py` holds
    petr_tpu's layer to torch); the two settings must differ."""
    C, heads, ffn, B, Q, L = 32, 4, 64, 2, 9, 20
    rng = np.random.RandomState(6)
    query, qp = (rng.randn(B, Q, C).astype(np.float32) for _ in range(2))
    memory, depth, kp = (rng.randn(B, L, C).astype(np.float32) for _ in range(3))
    mask = np.zeros((B, L), bool)
    mask[0, 15:] = True
    mask[1, :3] = True
    args = (query, memory, qp, kp, depth, mask)
    jlayer = JLayer(embed_dim=C, num_heads=heads, ffn_dim=ffn, dropout_rate=0.0, attend_memory=attend_memory)
    params = init_params(jlayer, 7, *map(jnp.asarray, args))
    want = np.asarray(jax.jit(jlayer.apply)({"params": params}, *map(jnp.asarray, args)))
    layer = DepthrDecoderLayer(C, heads, ffn, attend_memory=attend_memory).eval()
    sd = state_dict_from_jax({"head": {"layer0": params}})
    prefix = "pts_bbox_head.transformer.decoder.layers.0."
    layer.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    t = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        got = layer(t[0], t[1], t[2], t[3], t[5], None, t[4]).numpy()
        other = DepthrDecoderLayer(C, heads, ffn, attend_memory=not attend_memory).eval()
        other.load_state_dict(layer.state_dict())
        flipped = other(t[0], t[1], t[2], t[3], t[5], None, t[4]).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)
    assert np.abs(flipped - want).max() > 1e-2


# ------------------------------------------------------------ head, detector
def oracle_batch(B, seed, h=H, w=W):
    """A batch of B samples of 6 h x w views with the GT-depth oracle's
    inputs; one box ahead of each camera, sample 0 with 7 valid boxes of G,
    sample 1 with a padded view."""
    rng = np.random.RandomState(seed)
    l2i = cameras(B, N, h, w, yaw0=0.4)
    valid = np.zeros((B, G), bool)
    valid[0, :7] = True
    valid[1:, :] = True
    bearings = 2 * np.pi * np.arange(N) / N + 0.4 * np.arange(B)[:, None]  # one box ahead of each camera
    boxes = ring_boxes(rng, B, G, ahead=bearings)
    boxes[~valid] = 0.0
    batch = {
        "images": rng.randn(B, N, h, w, 3).astype(np.float32),
        "img2lidar": np.linalg.inv(l2i).astype(np.float32),
        "img_hw": np.tile(np.array([h, w], np.float32), (B, N, 1)),
        "gt_boxes": boxes,
        "gt_labels": np.where(valid, rng.randint(0, 10, (B, G)), 0).astype(np.int32),
        "gt_valid": valid,
        "lidar2img": l2i,
    }
    if B > 1:
        batch["img_hw"][1, 3] = [h - 16, w - 32]  # a padded view: its tokens are masked
    return batch


def jax_kwargs(batch):
    return dict(gt_boxes=jnp.asarray(batch["gt_boxes"]), gt_valid=jnp.asarray(batch["gt_valid"]),
                lidar2img=jnp.asarray(batch["lidar2img"]))


@pytest.fixture(scope="module")
def det():
    jcfg, cfg = tiny(jax_config("synth_small_depthr")), tiny(get_config("synth_small_depthr"))
    batch = oracle_batch(2, 8)
    jmodel = JDetector(jcfg.model, deterministic=True)
    args = [jnp.asarray(batch[k]) for k in ("images", "img2lidar", "img_hw")]
    params = init_params(jmodel, 9, *args, **jax_kwargs(batch))
    want = jax.device_get(jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, **jax_kwargs(batch)))(params, *args))
    model = PETRDetector(cfg.model).eval()
    model.load_state_dict(state_dict_from_jax(params, model))  # raises on any leaf skipped or unfilled
    with torch.no_grad():
        got = model(*[torch.from_numpy(batch[k]) for k in ("images", "img2lidar", "img_hw")],
                    **{k: torch.from_numpy(batch[k]) for k in ("gt_boxes", "gt_valid", "lidar2img")})
    return types.SimpleNamespace(jcfg=jcfg, cfg=cfg, batch=batch, params=params, want=want, got=got, model=model)


def test_head_matches(det):
    """The head alone over the same features (the detector's backbone
    output): fp32, within 1e-4 of each output's largest |value|."""
    hc = det.cfg.model.head
    feats = np.random.RandomState(10).randn(2, N, H // 16, W // 16, 24).astype(np.float32)
    jhead = JHead(num_classes=hc.num_classes, in_channels=24, embed_dim=hc.embed_dim, num_query=hc.num_query,
                  num_layers=hc.num_layers, num_heads=hc.num_heads, ffn_dim=hc.ffn_dim, depth_num=hc.depth_num,
                  depth_bins=hc.depth_bins, depth_map_max=hc.depth_map_max,
                  depth_map_down_scale=hc.depth_map_down_scale, remat=False, dropout_rate=0.0)
    b = det.batch
    jargs = (jnp.asarray(feats), jnp.asarray(b["img2lidar"]), jnp.asarray(b["img_hw"]), (H, W))
    params = init_params(jhead, 11, *jargs, **jax_kwargs(b))
    want = jax.jit(lambda p, *a: jhead.apply({"params": p}, *a, (H, W), **jax_kwargs(b)))(params, *jargs[:3])
    head = DepthrHead(num_classes=hc.num_classes, in_channels=24, embed_dim=hc.embed_dim,
                      num_query=hc.num_query, num_layers=hc.num_layers, num_heads=hc.num_heads,
                      ffn_dim=hc.ffn_dim, depth_num=hc.depth_num, depth_bins=hc.depth_bins,
                      depth_map_max=hc.depth_map_max, depth_map_down_scale=hc.depth_map_down_scale).eval()
    sd = state_dict_from_jax({"head": params})
    head.load_state_dict({k[len("pts_bbox_head."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = head(torch.from_numpy(feats), *[torch.from_numpy(b[k]) for k in ("img2lidar", "img_hw")], (H, W),
                   **{k: torch.from_numpy(b[k]) for k in ("gt_boxes", "gt_valid", "lidar2img")})
    for key in ("cls_logits", "bbox_codes"):
        w = np.asarray(want[key])
        assert got[key].shape == w.shape == (hc.num_layers, 2, hc.num_query, w.shape[-1])
        np.testing.assert_allclose(got[key].numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=key)


def test_detector_matches(det):
    """The whole forward: fp32, within 1e-4 of each output's largest
    |value|; the depth maps of the batch cover pixels in every view."""
    maps = gt_depth_maps(*[torch.from_numpy(det.batch[k]) for k in ("gt_boxes", "gt_valid", "lidar2img")],
                         (H, W), det.cfg.model.head.depth_map_down_scale)
    assert ((maps > 0).float().mean(dim=(2, 3)) > 0).all()
    for key in ("cls_logits", "bbox_codes"):
        w = np.asarray(det.want[key])
        assert det.got[key].shape == w.shape
        np.testing.assert_allclose(det.got[key].numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=key)


def test_eval_step_matches(det):
    """The port's eval step against petr_tpu's on the same weights and
    batch: scores within 2e-5 (the fp32 logits of the two packages differ
    by up to ~5e-5 with these random weights, and a score by at most a
    quarter of that); labels, valid and boxes (2e-3 absolute) where a
    score is clear of its neighbours by 4e-5, so that no two can trade
    places."""
    want = jax.jit(jax_make_eval_step(det.jcfg))(det.params, {k: jnp.asarray(v) for k, v in det.batch.items()})
    got = make_eval_step(det.cfg)(det.model, det.batch)
    k = min(det.cfg.max_det, det.cfg.model.head.num_query * det.cfg.model.head.num_classes)
    assert got["boxes"].device.type == "cpu" and got["boxes"].shape == (2, k, 9)
    for i in range(2):
        s = np.asarray(want["scores"][i])
        np.testing.assert_allclose(got["scores"][i].numpy(), s, atol=2e-5, rtol=0)
        keep = np.ones_like(s, bool)
        keep[1:] &= (s[:-1] - s[1:]) > 4e-5
        keep[:-1] &= (s[:-1] - s[1:]) > 4e-5
        assert keep.sum() > 60, keep.sum()
        for k in ("labels", "valid"):
            np.testing.assert_array_equal(got[k][i].numpy()[keep], np.asarray(want[k][i])[keep])
        np.testing.assert_allclose(got["boxes"][i].numpy()[keep], np.asarray(want["boxes"][i])[keep], atol=2e-3)


def test_outputs_do_not_depend_on_the_images(det):
    """The rebinding: the decoder never reads the image features, so other
    images with the same cameras and boxes give the same outputs, bit for
    bit; other boxes do not."""
    b = dict(det.batch, images=np.random.RandomState(12).randn(*det.batch["images"].shape).astype(np.float32))
    other = dict(det.batch, gt_boxes=det.batch["gt_boxes"] * np.float32(0.9))
    with torch.no_grad():
        outs = [det.model(*[torch.from_numpy(x[k]) for k in ("images", "img2lidar", "img_hw")],
                          **{k: torch.from_numpy(x[k]) for k in ("gt_boxes", "gt_valid", "lidar2img")})
                for x in (b, other)]
    for key in ("cls_logits", "bbox_codes"):
        assert torch.equal(outs[0][key], det.got[key]), key
        assert not torch.equal(outs[1][key], det.got[key]), key


def test_depthr_needs_its_oracle_inputs(det):
    args = [torch.from_numpy(det.batch[k]) for k in ("images", "img2lidar", "img_hw")]
    with pytest.raises(ValueError, match="gt_boxes, gt_valid and lidar2img"):
        det.model(*args)
    with pytest.raises(NotImplementedError, match="no serving path"):
        make_serving_fn(det.cfg, det.model, device="cpu")
    assert batch_keys(det.cfg) == BATCH_KEYS + ("lidar2img",)
    with pytest.raises(KeyError, match="lidar2img"):
        make_eval_step(det.cfg)(det.model, {k: v for k, v in det.batch.items() if k != "lidar2img"})


@pytest.mark.parametrize("name", PRESETS)
def test_converter_fills_every_depthr_parameter(name):
    """``state_dict_from_jax`` places every leaf of petr_tpu's param tree
    for the preset (it raises on one it cannot: skipped == 0) and fills
    every parameter and buffer of the port's detector (unfilled == 0),
    shapes equal."""
    jcfg, cfg = jax_config(name), get_config(name)
    h, w = jcfg.data.image_size
    model = JDetector(jcfg.model)
    n = jcfg.data.num_views
    eye = jnp.tile(jnp.eye(4), (1, n, 1, 1))
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, n, h, w, 3)), eye, jnp.full((1, n, 2), 1.0),
                           gt_boxes=jnp.zeros((1, 4, 9)), gt_valid=jnp.ones((1, 4), bool), lidar2img=eye))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    port = PETRDetector(cfg.model)
    sd = state_dict_from_jax(tree, port)
    assert set(sd) == set(port.state_dict())
    L = cfg.model.head.num_layers
    assert sum(".attentions.2.attn.in_proj_weight" in k for k in sd) == L
    assert sum("depth_gt_encoder.depth_head." in k for k in sd) == 8  # 2 stages x (conv, GroupNorm) x 2
