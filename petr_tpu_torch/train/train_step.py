"""The train step over the PETR detector (PyTorch).

Counterpart of `petr_tpu/train/train_step.py`: forward in the compute dtype
with fp32 loss islands, Hungarian matching, AdamW with a global-norm clip,
and a skip of every step whose gradients hold an inf or a NaN. PyTorch runs
eagerly, so the state is updated in place: ``TrainState`` holds the model
(an ``nn.Module`` in train mode), its ``torch.optim.AdamW`` and the step
count, and a step returns the same state object.

The step takes an explicit ``torch.Generator`` (on the CPU). All of a
forward's randomness (GridMask, the decoder's dropout seeds) is drawn from
it before the forward (``draw_train_noise``), so that the remat regions
recompute with the same masks.

A ``bn_mode="batch"`` backbone normalises with each batch's moments; the
forward hands them out (``collect_batch_moments``, petr_tpu's
"batch_stats" collection), and the step folds them into the BN running
statistics once, after the update, skipped steps included
(``_ema_bn_stats``).

Batch dict contract (tensors or numpy arrays, statically shaped):
    images     (B, N, H, W, 3) float32, normalised
    img2lidar  (B, N, 4, 4)    float32
    img_hw     (B, N, 2)       float32 valid (h, w) before padding
    gt_boxes   (B, G, 9)       float32, gravity-center z
    gt_labels  (B, G)          int
    gt_valid   (B, G)          bool
    timestamp  (B, N)          float32, 2-frame configs (PETRv2) only
    lidar2img  (B, N, 4, 4)    float32, the Depthr head's GT-depth oracle only

``make_eval_step`` is petr_tpu's eval step: the eval forward, then the
NMS-free decode of the last decoder layer, on the model's device.

Over several ranks (``make_train_step(cfg, mesh)``, `petr_tpu/train/
train_step.py:254-279`) each rank steps on its rows of the global batch
(``parallel.shard_batch``) under the mesh, and the step is petr_tpu's
global-batch step: the forward takes this rank's rows of the global
batch's dropout masks and the global batch's BN moments, the loss
normalises by the data group's mean positive count, the host matcher runs
on the local samples, and the gradients and the loss are averaged over
the data group before the norm, the non-finite count and the skip, so that
every rank takes the same decision. A token-sharded decoder (model axis
above 1) hands each rank the replicated gradient itself.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from petr_tpu_torch.configs.config import ExperimentConfig
from petr_tpu_torch.models.detector import PETRDetector, draw_train_noise, init_weights
from petr_tpu_torch.models.layers import collect_batch_moments
from petr_tpu_torch.parallel.mesh import Mesh, data_mean, use_mesh
from petr_tpu_torch.serve.export import decode_last_layer, resolve_device
from petr_tpu_torch.train.losses import petr_set_loss
from petr_tpu_torch.train.optim import build_optimizer, clip_by_global_norm, global_norm, make_lr_schedule

BATCH_KEYS = ("images", "img2lidar", "img_hw", "gt_boxes", "gt_labels", "gt_valid")


def batch_keys(cfg: ExperimentConfig) -> Tuple[str, ...]:
    """The batch keys a step of ``cfg`` reads: ``BATCH_KEYS``, ``timestamp``
    when it has 2 frames, and ``lidar2img`` for the Depthr head."""
    return (BATCH_KEYS + (("timestamp",) if cfg.data.num_frames > 1 else ())
            + (("lidar2img",) if cfg.model.head.kind == "depthr" else ()))


def _forward(model: PETRDetector, b: Dict[str, torch.Tensor], noise=None) -> Dict[str, torch.Tensor]:
    """The detector on a batch on its device: the Depthr head's oracle
    inputs when the batch holds ``lidar2img`` (`petr_tpu/train/
    train_step.py:55-58, 93-97, 341-348`)."""
    oracle = {}
    if "lidar2img" in b:
        oracle = dict(gt_boxes=b["gt_boxes"], gt_valid=b["gt_valid"], lidar2img=b["lidar2img"])
    return model(b["images"], b["img2lidar"], b["img_hw"], noise=noise, timestamp=b.get("timestamp"), **oracle)


Grads = Dict[str, torch.Tensor]
# BN batch moments by buffer name: "<module>.running_mean" -> the batch mean,
# "<module>.running_var" -> the Bessel-corrected batch variance
BNStats = Dict[str, torch.Tensor]


def _forward_collecting(model: PETRDetector, b: Dict[str, torch.Tensor], noise=None):
    """``_forward`` -> (outputs, the batch moments of every batch-mode BN that
    ran, keyed like the model's buffers; {} for frozen BN)."""
    with collect_batch_moments() as sink:
        outputs = _forward(model, b, noise)
    if not sink:
        return outputs, {}
    names = {m: n for n, m in model.named_modules()}
    stats: BNStats = {}
    for module, (mean, var) in sink.items():
        stats[f"{names[module]}.running_mean"] = mean
        stats[f"{names[module]}.running_var"] = var
    return outputs, stats


@dataclasses.dataclass
class TrainState:
    step: int  # steps taken, skipped ones included: the LR schedule's count
    model: PETRDetector
    optimizer: torch.optim.AdamW
    lr_schedule: Callable[[int], float]

    def trainable(self) -> Dict[str, torch.nn.Parameter]:
        return {n: p for n, p in self.model.named_parameters() if p.requires_grad}

    def apply_gradients(self, grads: Grads) -> None:
        """One AdamW update with ``grads`` (already clipped) at lr(step)."""
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_mult"]
        for name, p in self.trainable().items():
            p.grad = grads[name]
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)


def create_train_state(
    cfg: ExperimentConfig, seed: int, total_steps: int, device: Union[str, torch.device] = "cuda"
) -> TrainState:
    """The detector of ``cfg`` with random weights drawn from ``seed`` at the
    scales petr_tpu's ``create_train_state`` draws them
    (``init_weights(..., petr_tpu_scales=True)``), on ``device`` (the card
    unless the caller asks for the CPU), in train mode, with its optimizer
    and LR schedule.

    Sets ``torch.backends.cudnn.deterministic = True`` for the process, so
    that a step is reproducible bit for bit: with cuDNN's default choice
    the weight gradient of the r50dcn offset convs (3x3, 27 outputs) came
    out of an algorithm that sums in another order on every run
    (`petr_tpu_torch/repro_bisect.py`)."""
    torch.backends.cudnn.deterministic = True
    device = resolve_device(device)
    model = init_weights(PETRDetector(cfg.model), seed, petr_tpu_scales=True).to(device).train()
    optimizer = build_optimizer(
        cfg.train.optim, model, freeze_backbone_bn_affine=not cfg.model.backbone.train_bn_affine
    )
    return TrainState(0, model, optimizer, make_lr_schedule(cfg.train.optim, total_steps))


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator for step ``step`` of a run seeded ``seed``, drawn
    from the pair alone: petr_tpu's ``fold_in(rng, state.step)``
    (`train_step.py:259`), so that a resumed or replayed run draws at each
    step what the uninterrupted run drew."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]))


def _to_device(batch, keys: Tuple[str, ...], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k]).to(device) for k in keys}


def make_grad_fn(cfg: ExperimentConfig, mesh: Optional[Mesh] = None):
    """``grad_fn(model, batch, generator, indices=None)`` ->
    (total, losses, grads by parameter name, the (L, B, G) assignment,
    the BN batch moments).

    ``indices`` injects a precomputed assignment into the set loss. The
    moments are those of a ``bn_mode="batch"`` backbone ({} under frozen
    BN), taken in the forward and not again in a remat recompute. With a
    ``mesh`` the forward and backward run under it on this rank's rows:
    the total, losses and gradients are this rank's, not yet averaged.
    """
    ocfg = cfg.train.optim
    keys = batch_keys(cfg)

    def grad_fn(model: PETRDetector, batch, generator: torch.Generator,
                indices: Optional[np.ndarray] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Grads, np.ndarray, BNStats]:
        device = next(model.parameters()).device
        b = _to_device(batch, keys, device)
        noise = draw_train_noise(cfg.model, b["images"].shape[2], generator)
        with use_mesh(mesh):
            outputs, bn_stats = _forward_collecting(model, b, noise)
            total, losses, indices = petr_set_loss(
                outputs, b["gt_boxes"], b["gt_labels"], b["gt_valid"],
                num_classes=cfg.model.head.num_classes, cls_weight=ocfg.cls_weight,
                bbox_weight=ocfg.bbox_weight, code_weights=ocfg.code_weights,
                sync_cls_avg_factor=ocfg.sync_cls_avg_factor, indices=indices,
            )
            params = {n: p for n, p in model.named_parameters() if p.requires_grad}
            raw = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), raw)}
        return total.detach(), {k: v.detach() for k, v in losses.items()}, grads, indices, bn_stats

    return grad_fn


def accumulate_grads(grad_fn, model: PETRDetector, batch, generator: torch.Generator, accum: int,
                     keys: Tuple[str, ...] = BATCH_KEYS):
    """Gradient accumulation over ``accum`` sequential micro-batches, mmcv
    GradientCumulativeOptimizerHook semantics as petr_tpu's: each micro-batch
    is normalised by its own avg_factor, the gradients are averaged, one
    update per step. Micro-batch i takes samples [i::accum] of ``keys``
    (``batch_keys(cfg)``) and draws its randomness from ``generator`` in turn.

    Returns (mean total, per-loss means, averaged grads, the whole batch's
    BN moments combined from the micro-batches' by ``_combine_bn_moments``).
    """
    bsz = len(batch["images"])
    if bsz % accum != 0:
        raise ValueError(f"batch size {bsz} not divisible by grad_accum={accum}")
    totals, losses, grads, stats = [], [], None, []
    for i in range(accum):
        t, l, g, _, s = grad_fn(model, {k: batch[k][i::accum] for k in keys}, generator)
        totals.append(t)
        losses.append(l)
        stats.append(s)
        grads = g if grads is None else {n: grads[n] + g[n] for n in grads}
    mean_losses = {k: torch.stack([l[k] for l in losses]).mean() for k in losses[0]}
    return (torch.stack(totals).mean(), mean_losses, {n: g / accum for n, g in grads.items()},
            _combine_bn_moments(stats))


def _combine_bn_moments(stats: Sequence[BNStats]) -> BNStats:
    """The BN moments of equal micro-batches combined into the whole batch's,
    by the parallel-variance identity (petr_tpu `train_step.py:175-189`):
        mean = avg(mean_i);  var = avg(var_i + mean_i^2) - mean^2
    exact for the biased variance; the entries carry the Bessel-corrected
    one, which makes it exact to O(1/n), n the micro-batch's B*H*W."""
    out: BNStats = {}
    for key in stats[0]:
        if not key.endswith(".running_mean"):
            continue
        var_key = key[: -len("mean")] + "var"
        means = torch.stack([s[key] for s in stats])
        m = means.mean(0)
        out[key] = m
        out[var_key] = torch.clamp(
            (torch.stack([s[var_key] for s in stats]) + means ** 2).mean(0) - m ** 2, min=0.0)
    return out


@torch.no_grad()
def _ema_bn_stats(model: torch.nn.Module, stats: BNStats, momentum: float = 0.1) -> None:
    """Fold this step's batch moments into the BN running statistics, in
    place: running = (1 - momentum) * running + momentum * batch (torch/mmcv
    BN semantics; petr_tpu `train_step.py:231-250`)."""
    if not stats:
        return
    buffers = dict(model.named_buffers())
    for key, v in stats.items():
        buffers[key].copy_((1.0 - momentum) * buffers[key] + momentum * v)


@torch.no_grad()
def data_mean_grads(grads: Grads, mesh: Optional[Mesh]) -> Grads:
    """The gradients averaged over the data group, in one all-reduce of
    their concatenation."""
    if mesh is None or mesh.data == 1:
        return grads
    names = list(grads)
    flat = data_mean(torch.cat([grads[n].reshape(-1) for n in names]), mesh)
    out, at = {}, 0
    for n in names:
        g = grads[n]
        out[n] = flat[at:at + g.numel()].view_as(g)
        at += g.numel()
    return out


def make_train_step(cfg: ExperimentConfig, mesh: Optional[Mesh] = None):
    """``train_step(state, batch, generator)`` -> (state, metrics), updating
    ``state`` in place.

    metrics: ``loss``, the per-layer losses and ``num_pos`` (0-d tensors),
    ``grad_norm`` over the trainable parameters, and ``grad_nonfinite`` and
    ``skipped`` (ints). A step whose gradients hold an inf or a NaN is
    skipped (mmcv Fp16OptimizerHook parity): the parameters, the Adam
    moments and their step counts stay as they were, but ``state.step``,
    the LR schedule's count, still advances. Under ``bn_mode="batch"`` the
    batch's BN moments are folded into the running statistics after the
    update, on every step, skipped ones included (torch updates them in
    the forward, before and apart from ``optimizer.step``).

    With a ``mesh``, ``batch`` is this rank's rows of the global batch and
    every rank calls the step with the same generator: the gradients, the
    loss and the per-layer losses are averaged over the data group
    (``num_pos`` summed) before anything reads them.
    """
    grad_fn = make_grad_fn(cfg, mesh)
    accum = cfg.train.grad_accum

    def train_step(state: TrainState, batch, generator: torch.Generator):
        if accum <= 1:
            total, losses, grads, _, bn_stats = grad_fn(state.model, batch, generator)
        else:
            total, losses, grads, bn_stats = accumulate_grads(
                grad_fn, state.model, batch, generator, accum, batch_keys(cfg))
        if mesh is not None and mesh.data > 1:
            grads = data_mean_grads(grads, mesh)
            total = data_mean(total, mesh)
            losses = {k: data_mean(v, mesh) * (mesh.data if k == "num_pos" else 1) for k, v in losses.items()}
        names = list(grads)
        gnorm = global_norm([grads[n] for n in names])
        nonfinite = int(sum((~torch.isfinite(g)).sum() for g in grads.values()))
        skipped = nonfinite > 0
        if not skipped:
            clipped = clip_by_global_norm([grads[n] for n in names], cfg.train.optim.grad_clip_norm, gnorm)
            state.apply_gradients(dict(zip(names, clipped)))
        _ema_bn_stats(state.model, bn_stats, cfg.model.backbone.bn_momentum)
        state.step += 1
        metrics = {"loss": total, **losses, "grad_norm": gnorm,
                   "grad_nonfinite": nonfinite, "skipped": int(skipped)}
        return state, metrics

    return train_step


def make_eval_step(cfg: ExperimentConfig):
    """``eval_step(model, batch)`` -> dict of boxes (B, max_det, 9), scores,
    labels and valid (B, max_det), tensors on the model's device: the
    forward of ``model`` in eval mode, then the NMS-free decode of its last
    decoder layer (petr_tpu's ``make_eval_step``, `train_step.py:325-366`).
    It reads ``batch_keys(cfg)`` but the GT labels; a Depthr model reads
    the GT boxes and cameras at test time too (an oracle)."""
    keys = tuple(k for k in batch_keys(cfg) if k != "gt_labels")
    if cfg.model.head.kind != "depthr":
        keys = tuple(k for k in keys if not k.startswith("gt_"))

    def eval_step(model: PETRDetector, batch) -> Dict[str, torch.Tensor]:
        if model.training:
            raise ValueError("eval_step takes a model in eval mode (model.eval())")
        device = next(model.parameters()).device
        with torch.inference_mode():
            return decode_last_layer(cfg, _forward(model, _to_device(batch, keys, device)))

    return eval_step
