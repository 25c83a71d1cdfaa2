"""The port's nuScenes metrics and submission export against petr_tpu's.

`petr_tpu_torch/metrics/` is a numpy copy of `petr_tpu/metrics/`, so on the
same detections every number must be equal to the last bit:
``evaluate_detections`` on the cases of `tests/test_metrics.py` (perfect
detections, an absent class, a wrong class, range filtering by ego
distance, a barrier's yaw) and on random sets drawn from seeds;
``boxes_from_arrays`` and ``ground_truth_from_infos``; ``build_submission``
over the fake devkit's records.
"""

import dataclasses
import json

import numpy as np
import pytest

from petr_tpu.data.info import build_infos
from petr_tpu.data.synthetic import generate_synthetic_scenes
from petr_tpu.metrics import nuscenes as jax_nuscenes
from petr_tpu.metrics import submission as jax_submission
from petr_tpu_torch.configs.config import NUSCENES_CLASSES
from petr_tpu_torch.metrics import nuscenes, submission
from tests.test_info_builder import fake_db  # noqa: F401  (pytest fixture)


def both(boxes):
    """The same boxes (dicts of DetectionBox fields) as petr_tpu's and the port's DetectionBoxes."""
    return ({tok: [jax_nuscenes.DetectionBox(**b) for b in bs] for tok, bs in boxes.items()},
            {tok: [nuscenes.DetectionBox(**b) for b in bs] for tok, bs in boxes.items()})


def box(tok, x, y, name="car", score=-1.0, yaw=0.0, vel=(0, 0), size=(2, 4, 1.5), attr="vehicle.parked",
        num_pts=10, ego_dist=-1.0):
    return dict(sample_token=tok, center=np.array([x, y, 0.0]), size=np.array(size, float), yaw=yaw,
                velocity=np.array(vel, float), name=name, score=score, attr=attr, num_pts=num_pts,
                ego_dist=ego_dist)


def same_metrics(gts, preds, classes):
    (jg, pg), (jp, pp) = both(gts), both(preds)
    want = jax_nuscenes.evaluate_detections(jg, jp, classes=classes)
    got = nuscenes.evaluate_detections(pg, pp, classes=classes)
    assert list(got) == list(want) and got == want, (got, want)
    return got


def _perfect():
    rng = np.random.RandomState(0)
    gts, preds = {}, {}
    for s in range(4):
        tok = f"s{s}"
        gts[tok] = [box(tok, *rng.uniform(-30, 30, 2), yaw=0.3, vel=(1, 0)) for _ in range(5)]
        preds[tok] = [box(tok, g["center"][0], g["center"][1], score=0.9, yaw=0.3, vel=(1, 0)) for g in gts[tok]]
    return gts, preds, ("car",)


def _absent_class():
    return {"s0": [box("s0", 1, 1)]}, {"s0": [box("s0", 1, 1, score=0.9)]}, ("car", "truck")


def _wrong_class():
    return {"s0": [box("s0", 1, 1)]}, {"s0": [box("s0", 1, 1, name="truck", score=0.9)]}, ("car", "truck")


def _range_by_ego_dist():
    # inside the 50 m car range from the lidar origin, outside it by ego distance, and the reverse
    gts = {"s0": [box("s0", 45, 10, ego_dist=52.0), box("s0", 10, 5), box("s0", 55, 0, ego_dist=49.0)]}
    preds = {"s0": [box("s0", 45, 10.2, score=0.8, ego_dist=52.0), box("s0", 10.5, 5, score=0.7),
                    box("s0", 55, 0.4, score=0.6, ego_dist=49.0), box("s0", 20, 20, score=0.9)]}
    return gts, preds, ("car",)


def _barrier_yaw():
    gts = {"s0": [box("s0", 3, 3, name="barrier", yaw=0.1, attr=""), box("s0", -5, 2, name="barrier", yaw=1.0,
                                                                          attr="")]}
    preds = {"s0": [box("s0", 3, 3, name="barrier", yaw=0.1 + np.pi, score=0.9, attr=""),
                    box("s0", -5, 2.3, name="barrier", yaw=1.4, score=0.8, attr="")]}
    return gts, preds, ("barrier",)


def _random(seed):
    rng = np.random.RandomState(seed)
    attrs = ("vehicle.parked", "vehicle.moving", "pedestrian.moving", "", "cycle.with_rider")
    gts, preds = {}, {}
    for s in range(6):
        tok = f"s{s}"
        gts[tok], preds[tok] = [], []
        for _ in range(rng.randint(0, 9)):
            name = NUSCENES_CLASSES[rng.randint(len(NUSCENES_CLASSES))]
            g = box(tok, *rng.uniform(-55, 55, 2), name=name, yaw=rng.uniform(-np.pi, np.pi),
                    vel=rng.normal(size=2), size=rng.uniform(0.5, 5, 3), attr=attrs[rng.randint(5)],
                    num_pts=int(rng.choice([0, 3, 20])), ego_dist=float(rng.choice([-1.0, rng.uniform(0, 60)])))
            gts[tok].append(g)
            for _ in range(rng.randint(0, 3)):  # near and far hits, some of the wrong class
                c = g["center"][:2] + rng.normal(0, rng.choice([0.2, 1.0, 3.0]), 2)
                preds[tok].append(box(tok, *c, name=name if rng.rand() < 0.8 else "truck",
                                      score=float(rng.rand()), yaw=g["yaw"] + rng.normal(0, 0.3),
                                      vel=g["velocity"] + rng.normal(0, 0.5, 2), size=g["size"] * rng.uniform(0.8, 1.2),
                                      attr=attrs[rng.randint(5)]))
        for _ in range(rng.randint(0, 4)):  # false positives
            preds[tok].append(box(tok, *rng.uniform(-50, 50, 2), name=NUSCENES_CLASSES[rng.randint(10)],
                                  score=float(rng.rand())))
    return gts, preds, NUSCENES_CLASSES


CASES = {"perfect": _perfect, "absent_class": _absent_class, "wrong_class": _wrong_class,
         "range_by_ego_dist": _range_by_ego_dist, "barrier_yaw": _barrier_yaw,
         **{f"random_{s}": (lambda s=s: _random(s)) for s in range(4)}}


@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_detections_matches(case):
    gts, preds, classes = CASES[case]()
    got = same_metrics(gts, preds, classes)
    if case == "perfect":
        assert got["mAP"] == pytest.approx(1.0) and got["NDS"] == pytest.approx(1.0)
    if case == "absent_class":
        assert got["mAP"] == pytest.approx(0.5)
    if case.startswith("random"):
        assert 0.0 < got["mAP"] < 1.0, got


def same_boxes(want, got):
    assert list(want) == list(got)
    for tok in want:
        assert len(want[tok]) == len(got[tok])
        for a, b in zip(want[tok], got[tok]):
            da, db = dataclasses.asdict(a), dataclasses.asdict(b)
            assert list(da) == list(db)
            for k in da:
                np.testing.assert_array_equal(da[k], db[k], err_msg=f"{tok}.{k}")


def _preds_from_arrays(module, infos, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for info in infos:
        K = 12
        boxes = np.concatenate([rng.uniform(-40, 40, (K, 3)), rng.uniform(0.5, 4, (K, 3)),
                                rng.uniform(-3, 3, (K, 1)), rng.normal(0, 1, (K, 2))], 1).astype(np.float32)
        scores, labels = rng.rand(K).astype(np.float32), rng.randint(0, 10, K)
        out[info["token"]] = module.boxes_from_arrays(info["token"], boxes, scores, labels, rng.rand(K) < 0.8,
                                                      info=info)
    return out


def test_boxes_and_ground_truth_match(tmp_path, fake_db):  # noqa: F811
    infos = generate_synthetic_scenes(str(tmp_path), n_scenes=2, frames_per_scene=2, image_hw=(16, 40),
                                      n_objects=5, val_scenes=1, seed=2)["val"]
    infos += build_infos("", nusc=fake_db, train_scenes=["scene-0001"], val_scenes=[])["train"]
    infos.append(dict(infos[0], token="no_pose"))
    for key in ("lidar2ego_translation", "lidar2ego_rotation", "ego2global_translation", "ego2global_rotation"):
        del infos[-1][key]  # ego_dist unknown: -1
    same_boxes(_preds_from_arrays(jax_nuscenes, infos, 0), _preds_from_arrays(nuscenes, infos, 0))
    same_boxes(jax_nuscenes.ground_truth_from_infos(infos), nuscenes.ground_truth_from_infos(infos))
    gts = nuscenes.ground_truth_from_infos(infos, classes=NUSCENES_CLASSES)
    assert gts["no_pose"][0].ego_dist == -1.0 and gts[infos[0]["token"]][0].ego_dist >= 0


def test_build_submission_matches(fake_db):  # noqa: F811
    infos = build_infos("", nusc=fake_db, train_scenes=["scene-0001"], val_scenes=[])["train"]
    want = jax_submission.build_submission(_preds_from_arrays(jax_nuscenes, infos, 1), infos)
    got = submission.build_submission(_preds_from_arrays(nuscenes, infos, 1), infos)
    assert json.dumps(got) == json.dumps(want)
    assert len(got["results"]) == 1 and got["results"][infos[0]["token"]]
    legacy = [{k: v for k, v in infos[0].items() if not k.startswith("ego2global")}]
    with pytest.raises(ValueError, match="ego2global"):
        submission.build_submission(_preds_from_arrays(nuscenes, legacy, 1), legacy)
