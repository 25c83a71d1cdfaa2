"""petr_tpu_torch.ops (geometry, box codec, NMS-free decode) against petr_tpu.

The same seeded numpy inputs go through both packages in fp32; the port
must agree to atol 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from petr_tpu.ops import boxes as jboxes
from petr_tpu.ops import geometry as jgeo
from petr_tpu.ops.nms_free import nms_free_decode as j_decode
from petr_tpu_torch.ops import boxes as tboxes
from petr_tpu_torch.ops import geometry as tgeo
from petr_tpu_torch.ops.nms_free import nms_free_decode as t_decode
from tests.test_heads import make_cams

ATOL = 1e-5
POSITION_RANGE = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)


def _close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


def test_inverse_sigmoid():
    x = np.random.RandomState(0).uniform(-0.2, 1.2, (64,)).astype(np.float32)
    x[:4] = [0.0, 1.0, 1e-7, 1 - 1e-7]
    _close(tgeo.inverse_sigmoid(torch.from_numpy(x)), jgeo.inverse_sigmoid(jnp.asarray(x)))


@pytest.mark.parametrize("num_feats", [128, 16])
def test_pos2posemb3d_interleaved_yxz(num_feats):
    pos = np.random.RandomState(1).uniform(0, 1, (2, 7, 3)).astype(np.float32)
    got = tgeo.pos2posemb3d(torch.from_numpy(pos), num_feats)
    assert got.shape == (2, 7, 3 * num_feats)
    _close(got, jgeo.pos2posemb3d(jnp.asarray(pos), num_feats))


@pytest.mark.parametrize("mode", ["LID", "UD"])
def test_depth_bins(mode):
    _close(tgeo.depth_bins(8, 1.0, 61.2, mode), jgeo.depth_bins(8, 1.0, 61.2, mode))


def test_frustum_coords_at_index_times_stride():
    d = tgeo.depth_bins(5, 1.0, 61.2)
    got = tgeo.frustum_coords(3, 4, 48.0, 80.0, d)
    _close(got, jgeo.frustum_coords(3, 4, 48.0, 80.0, jnp.asarray(d.numpy())), atol=1e-4)
    # pixel (1, 2) sits at (2 * 80/4, 1 * 48/3), not at its center
    np.testing.assert_allclose(got[1, 2, 0, :2].numpy() / d[0].item(), [40.0, 16.0], rtol=1e-6)


def test_backproject_frustum():
    cams = make_cams(2, 3, seed=2)
    d = tgeo.depth_bins(4, 1.0, 61.2)
    coords = tgeo.frustum_coords(2, 5, 32.0, 80.0, d)
    got = tgeo.backproject_frustum(coords, torch.from_numpy(cams))
    want = jgeo.backproject_frustum(jnp.asarray(coords.numpy()), jnp.asarray(cams))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_position_coords_3d_and_oob_mask():
    cams = make_cams(1, 6, seed=3)
    got, got_mask = tgeo.position_coords_3d(4, 10, 64.0, 160.0, torch.from_numpy(cams), POSITION_RANGE, depth_num=8)
    want, want_mask = jgeo.position_coords_3d(4, 10, 64.0, 160.0, jnp.asarray(cams), POSITION_RANGE, depth_num=8)
    assert got.shape == (1, 6, 4, 10, 24)
    _close(got, want)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("normalize", [True, False])
def test_sine_posemb_2d_multiview_block_order(normalize):
    masks = np.zeros((2, 3, 4, 6), bool)
    masks[0, 1, 3:, :] = True
    masks[1, 2, :, 4:] = True
    got = tgeo.sine_posemb_2d_multiview(torch.from_numpy(masks), num_feats=16, normalize=normalize)
    want = jgeo.sine_posemb_2d_multiview(jnp.asarray(masks), num_feats=16, normalize=normalize)
    assert got.shape == (2, 3, 4, 6, 48)
    _close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dim", [9, 7])
def test_box_codec_roundtrip(dim):
    rng = np.random.RandomState(4)
    boxes = np.concatenate(
        [rng.uniform(-40, 40, (5, 3)), rng.uniform(0.5, 4, (5, 3)),
         rng.uniform(-3, 3, (5, 1)), rng.uniform(-2, 2, (5, 2))], -1,
    ).astype(np.float32)[:, :dim]
    codes = tboxes.encode_bbox(torch.from_numpy(boxes))
    _close(codes, jboxes.encode_bbox(jnp.asarray(boxes)))
    assert codes.shape[-1] == dim + 1
    np.testing.assert_allclose(codes[:, 4].numpy(), boxes[:, 2], atol=0)  # cz at index 4
    _close(tboxes.decode_bbox(codes), jboxes.decode_bbox(jnp.asarray(codes.numpy())), atol=1e-4)


@pytest.mark.parametrize("max_num,threshold", [(300, None), (20, 0.3)])
def test_nms_free_decode_batched(max_num, threshold):
    rng = np.random.RandomState(5)
    B, Q, C = 2, 40, 10
    logits = rng.randn(B, Q, C).astype(np.float32)
    codes = rng.randn(B, Q, 10).astype(np.float32)
    codes[..., :2] *= 60.0  # some centers fall outside post_center_range
    got = t_decode(torch.from_numpy(logits), torch.from_numpy(codes), max_num=max_num,
                   num_classes=C, post_center_range=POSITION_RANGE, score_threshold=threshold)
    k = min(max_num, Q * C)
    assert got["boxes"].shape == (B, k, 9) and got["labels"].dtype == torch.int32
    for b in range(B):
        want = j_decode(jnp.asarray(logits[b]), jnp.asarray(codes[b]), max_num=max_num,
                        num_classes=C, post_center_range=POSITION_RANGE, score_threshold=threshold)
        _close(got["scores"][b], want["scores"])
        np.testing.assert_array_equal(got["labels"][b].numpy(), np.asarray(want["labels"]))
        np.testing.assert_array_equal(got["valid"][b].numpy(), np.asarray(want["valid"]))
        _close(got["boxes"][b], want["boxes"], atol=1e-4)
