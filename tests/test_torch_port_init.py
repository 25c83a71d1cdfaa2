"""The port's initial training weights (``train.create_train_state``,
``init_weights(..., petr_tpu_scales=True)``) at the scales of petr_tpu's
``create_train_state``, on the CPU.

A run from random weights starts where petr_tpu's does only if the
backbone is drawn at the same scale: under frozen BN at its identity
statistics nothing renormalises it. Drawn at He's variance on every conv,
the r50dcn backbone's features came out far larger than petr_tpu's and a bf16
synth_small_r50dcn run's gradient norm overflowed by step 900, where
petr_tpu's trained to its floor with no skipped step. Checked for
tiny_debug (VoVNet; the He draw fails it by 41% on every conv): every
parameter's standard deviation within 15% of petr_tpu's (sampling noise
of a uniform against a truncated normal draw of at least 64 values is a
few percent; the He-scaled convs were 41% off), the same parameters at
exactly 0 or 1, and the backbone's and neck's features on the same images
within 25% of petr_tpu's in standard deviation.
"""

import jax
import numpy as np
import pytest
import torch

from petr_tpu.configs import get_config as jax_config
from petr_tpu.models import PETRDetector as JDetector
from petr_tpu_torch.configs import get_config
from petr_tpu_torch.models import PETRDetector
from petr_tpu_torch.train import create_train_state
from petr_tpu_torch.utils import state_dict_from_jax
from tests.test_heads import make_cams

PLAIN = ("model.use_flash_attention=False", "model.compute_dtype=float32")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs, as it was after: its
    CPU train steps, in a run of several test processes at once, otherwise
    contend for every core with the others."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


@pytest.mark.parametrize("name,hw", [("tiny_debug", (32, 80))])
def test_random_weights_at_petr_tpu_scales(name, hw):
    jcfg, cfg = jax_config(name, PLAIN), get_config(name, PLAIN)
    N, (H, W) = cfg.data.num_views, hw
    rng = np.random.RandomState(0)
    images = rng.randn(1, N, H, W, 3).astype(np.float32)
    cams = make_cams(1, N, seed=1)
    img_hw = np.tile(np.array([H, W], np.float32), (1, N, 1))
    params = jax.jit(JDetector(jcfg.model, deterministic=True).init)(jax.random.PRNGKey(0), images, cams, img_hw)
    ref = PETRDetector(cfg.model).eval()
    ref.load_state_dict(state_dict_from_jax(jax.device_get(params["params"]), ref))
    model = create_train_state(cfg, 0, 10, "cpu").model.eval()
    want, got = ref.state_dict(), model.state_dict()
    for key, w in want.items():
        g = got[key]
        if bool((w == w.flatten()[0]).all()):  # a constant: zeros, ones, the focal prior
            assert torch.equal(g, w), key
        elif w.numel() >= 64:
            ratio = (g.std() / w.std()).item()
            assert 0.85 <= ratio <= 1.15, f"{key}: std {g.std().item():.4g}, petr_tpu's {w.std().item():.4g}"
    x = torch.from_numpy(images).reshape(N, H, W, 3).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        for stage, (a, b) in enumerate(zip(model.img_backbone(x) + model.img_neck(model.img_backbone(x)),
                                           ref.img_backbone(x) + ref.img_neck(ref.img_backbone(x)))):
            ratio = (a.std() / b.std()).item()
            assert 0.75 <= ratio <= 1.25, f"feature {stage}: std {a.std().item():.4g}, petr_tpu's {b.std().item():.4g}"
