"""BN running-statistics estimation from forward passes ("precise BN").

Counterpart of `petr_tpu/train/bn_warmup.py`. The reference recipes train
from an ImageNet-pretrained backbone whose stored BN statistics match its
weights, and freeze them (mmcv norm_eval=True). A run from random weights
under the same frozen BN has identity statistics (mean 0, var 1), so no
effective normalisation: petr_tpu measured its backbone drifting to
1e15-scale activations, which bf16's backward cannot carry. Estimating the
statistics from a few forward passes, each BN on its batch's moments while
its input is shaped by the already-normalised layers above it, gives the
"pretrained statistics" regime the recipes assume. ``--bn-refresh`` of
``petr_tpu_torch.tools.synth_train_eval`` re-estimates them at every eval
boundary.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterable, Iterator

import torch

from petr_tpu_torch.models.detector import PETRDetector
from petr_tpu_torch.models.layers import FrozenBatchNorm
from petr_tpu_torch.train.train_step import BNStats, _forward_collecting, _to_device, batch_keys


@contextlib.contextmanager
def batch_moments_mode(model: PETRDetector) -> Iterator[PETRDetector]:
    """``model`` as petr_tpu builds it for the estimate (``bn_mode="batch"``,
    ``deterministic=True``): in eval mode (no dropout, no GridMask, no
    remat) but with every BN on its batch's moments; then as it was."""
    norms = [m for m in model.modules() if isinstance(m, FrozenBatchNorm)]
    kept = model.training, [m.use_batch_stats for m in norms]
    model.eval()
    for m in norms:
        m.use_batch_stats = True
        m.train()
    try:
        yield model
    finally:
        for m, flag in zip(norms, kept[1]):
            m.use_batch_stats = flag
        model.train(kept[0])


@torch.no_grad()
def estimate_bn_stats(cfg, model: PETRDetector, batches: Iterable[Dict[str, Any]]) -> PETRDetector:
    """Estimate the BN running statistics of ``model`` from forward passes
    over ``batches`` and write them into its buffers; returns ``model``.

    The moments are combined exactly over the (equal-size) batches, with
    no EMA (petr_tpu `bn_warmup.py:52-119`):
        mean = avg(mean_i);  var = avg(var_i + mean_i^2) - mean^2
    with var_i the Bessel-corrected variance each BN hands out. A Depthr
    forward also takes the GT boxes and cameras. Zero batches leave the
    model as it was."""
    keys = batch_keys(cfg)
    device = next(model.parameters()).device
    sum_mean: BNStats = {}
    sum_sq: BNStats = {}
    n = 0
    with batch_moments_mode(model):
        for batch in batches:
            _, stats = _forward_collecting(model, _to_device(batch, keys, device))
            if not stats:
                return model
            for key, mean in stats.items():
                if not key.endswith(".running_mean"):
                    continue
                sq = stats[key[: -len("mean")] + "var"] + mean ** 2
                if key in sum_mean:
                    sum_mean[key] = sum_mean[key] + mean
                    sum_sq[key] = sum_sq[key] + sq
                else:
                    sum_mean[key], sum_sq[key] = mean, sq
            n += 1
    if n == 0:
        return model
    buffers = dict(model.named_buffers())
    for key, sm in sum_mean.items():
        mean = sm / n
        buffers[key].copy_(mean)
        buffers[key[: -len("mean")] + "var"].copy_(torch.clamp(sum_sq[key] / n - mean ** 2, min=0.0))
    return model
