"""The plain reference against the port's plain path at tiny_debug size, and
the FLOP count on the meta device."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from h100_bench import flops
from h100_bench.harness import REPO, port_config
from h100_bench.inputs import draw_samples, draw_weights
from h100_bench.reference.model import Detector, normalize_bn_statistics
from h100_bench.tiny_root import tiny_config


def built(config, seed):
    from petr_tpu_torch.configs import eval_model_config
    from petr_tpu_torch.models.detector import PETRDetector

    cfg = port_config(config)
    port = PETRDetector(dataclasses.replace(eval_model_config(cfg.model), compute_dtype="float32"))
    w = dict(config["weights"], num_classes=config["model"]["head"]["num_classes"])
    state = draw_weights(seed, port.state_dict(), w, "cpu")
    ref = Detector(config["model"])
    ref.load_state_dict(state)
    return cfg, port, ref, state


@pytest.mark.parametrize("seed", [3, 2**40 + 9])
def test_reference_forward_is_the_ports_plain_path(seed):
    config = tiny_config()
    cfg, port, ref, state = built(config, seed)
    pool = draw_samples(seed, 2, cfg.data.num_views, tuple(cfg.data.image_size), "cpu")
    args = [torch.as_tensor(pool[k]) for k in ("images", "img2lidar", "img_hw")]
    normalize_bn_statistics(ref.img_backbone, args[0][0].permute(0, 3, 1, 2))
    port.load_state_dict(ref.state_dict())
    port.eval()
    ref.eval()
    with torch.no_grad():
        a, b = port(*args), ref(*args)
    for k in ("cls_logits", "bbox_codes"):
        assert a[k].shape == b[k].shape
        assert torch.allclose(a[k], b[k], rtol=1e-5, atol=1e-5), (k, (a[k] - b[k]).abs().max())


def test_reference_state_names_are_the_ports():
    for name in ("vov800", "r50dcn"):
        from petr_tpu_torch.models.detector import PETRDetector

        config = json.loads((REPO / "h100_bench" / "configs" / f"{name}.json").read_text())
        cfg = port_config(config)
        with torch.device("meta"):
            port, ref = PETRDetector(cfg.model), Detector(config["model"])
        assert list(port.state_dict()) == list(ref.state_dict())
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
            k: tuple(v.shape) for k, v in ref.state_dict().items()}


def test_deformable_conv_is_the_ports_plain_version():
    from petr_tpu_torch.ops.dcn import modulated_deform_conv_reference

    from h100_bench.reference.model import deform_conv

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 9, 13, generator=g)
    om = torch.cat([torch.rand(2, 18, 9, 13, generator=g) * 8 - 4, torch.randn(2, 9, 9, 13, generator=g)], 1)
    w = torch.randn(5, 8, 3, 3, generator=g)
    assert torch.allclose(deform_conv(x, om, w), modulated_deform_conv_reference(x, om, w), atol=1e-4, rtol=1e-4)


def test_model_flops_count_the_forward_at_the_cells_shapes():
    r50 = json.loads((REPO / "h100_bench" / "configs" / "r50dcn.json").read_text())
    f = flops.forward_flops(r50["model"], 1, 6, (512, 1408))
    dcn = sum(n * 2 * np.prod(s[:1]) * s[2] * s[3] * s[4] * 9 * s[1]
              for n, s in flops.dcn_shapes(r50["model"], 6, (512, 1408)))
    assert 170e9 < dcn < 190e9  # the 9 DCN convs of one 6-view sample
    assert dcn < f < 2e12
    assert flops.forward_flops(r50["model"], 2, 6, (512, 1408)) == pytest.approx(2 * f, rel=1e-3)
