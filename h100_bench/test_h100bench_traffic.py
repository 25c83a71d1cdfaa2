"""The traffic generator: deterministic per seed, the same work for every seed."""

import numpy as np
import pytest

from h100_bench import traffic
from h100_bench.inputs import draw_gt, draw_samples, synthetic_cams

POISSON = {"arrival": "poisson", "rate_per_s": 40.0}
ONOFF = {"arrival": "onoff", "rate_per_s": 40.0, "on_s": 0.5, "off_s": 1.5}
BIG = 2**31 + 12345  # the driver's seeds go past 32 signed bits


@pytest.mark.parametrize("mix", [POISSON, ONOFF], ids=["poisson", "onoff"])
def test_arrivals_repeat_per_seed_and_keep_their_gaps_across_seeds(mix):
    a = traffic.arrival_times(mix, 30.0, BIG)
    assert np.array_equal(a, traffic.arrival_times(mix, 30.0, BIG))
    b = traffic.arrival_times(mix, 30.0, BIG + 1)
    assert not np.array_equal(a, b)
    assert len(a) == len(b) and abs(len(a) - 40.0 * 30.0) <= 40
    assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] < 30.0
    if mix is POISSON:  # the same set of gaps in another order
        ga, gb = np.sort(np.diff(a)), np.sort(np.diff(b))
        assert np.allclose(np.sort(np.concatenate([ga, [0]]))[-50:], np.sort(np.concatenate([gb, [0]]))[-50:],
                           rtol=0.05)


def test_request_samples_cover_the_pool_evenly():
    order = traffic.request_samples(130, 64, BIG)
    assert order == traffic.request_samples(130, 64, BIG)
    assert sorted(order[:64]) == list(range(64)) and sorted(order[64:128]) == list(range(64))
    assert traffic.check_sample(100, 16, BIG) == traffic.check_sample(100, 16, BIG)


def test_samples_and_gt_repeat_per_seed():
    a = draw_samples(BIG, 3, 6, (16, 40), "cpu")
    b = draw_samples(BIG, 3, 6, (16, 40), "cpu")
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["images"], draw_samples(BIG + 1, 3, 6, (16, 40), "cpu")["images"])
    g = draw_gt(BIG, 5, 128, (10, 60), (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0), 10)
    assert np.array_equal(g["gt_boxes"], draw_gt(BIG, 5, 128, (10, 60), (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
                                                  10)["gt_boxes"])
    counts = g["gt_valid"].sum(1)
    assert counts.min() >= 10 and counts.max() <= 60


def test_synthetic_cams_are_the_ports_at_800x320():
    from petr_tpu_torch.cli.quantize import synthetic_cams as port_cams

    assert np.allclose(synthetic_cams(2, 6, 320, 800), port_cams(2, 6), atol=1e-6)
