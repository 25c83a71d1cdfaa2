"""Declarative experiment configs (plain dataclasses — no registry/string
dispatch labyrinth; the reference's mmcv config dicts are documented in
SURVEY.md §2.8 and reproduced here as typed presets).

The PyTorch port keeps its own copy of `petr_tpu/configs/config.py`, field
for field and preset for preset, so that it imports nothing of the JAX
package, so that one preset name means one model in both. The port's train
step reads the training fields (dropout, remat, grid mask, optimizer) as
petr_tpu does.

Hyperparameters cited from `projects/configs/petr/*.py` (sty61010/PETR).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

NUSCENES_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)

PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
POSITION_RANGE = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    kind: str = "vovnet"  # 'vovnet' | 'resnet'
    spec: str = "V-99-eSE"  # vovnet spec or resnet depth via 'r50'
    out_indices: Tuple[int, ...] = (2, 3)
    dcn_stages: Tuple[int, ...] = ()
    with_fpn: bool = True
    fpn_out_channels: int = 256
    fpn_num_outs: int = 2
    # BN affine (scale/bias) trainability. The reference r50 configs freeze it
    # (norm_cfg requires_grad=False, petr_r50dcn_gridmask_p4.py:37); VoVNet
    # configs use plain nn.BatchNorm2d (affine trains; only stats are frozen
    # via norm_eval, vovnetcp.py:406-413).
    train_bn_affine: bool = True
    # BN statistics mode. "frozen" (default) = reference parity for
    # pretrained checkpoints (mmcv norm_eval=True: stored running stats).
    # "batch" = per-batch moments in training with an EMA of them tracked
    # into the stored mean/var params (mmcv norm_eval=False semantics;
    # torch momentum 0.1, updated even on overflow-skipped steps); EVAL
    # paths automatically switch to the frozen EMA stats
    # (`eval_model_config`), so eval stays per-sample independent and the
    # streaming feature cache exact. Context for from-scratch training:
    # frozen identity stats (mean 0, var 1 at init) leave a ~30-conv
    # backbone with no effective normalization — round 4 measured 1e15
    # neck activations by step ~900 of a synth run, saturating attention
    # softmax downstream and putting the f32 backward on overflow cliffs;
    # "batch" normalizes correctly but needs its own LR/warmup recipe
    # (gnorm spikes at the synth presets' short warmup), so the pinned
    # synth validation runs f32+frozen, the regime its baselines were
    # measured in.
    bn_mode: str = "frozen"
    # EMA momentum for the running stats tracked under bn_mode="batch":
    # running = (1 - momentum) * running + momentum * batch. 0.1 is torch
    # nn.BatchNorm2d's default, which every reference config inherits
    # (mmcv norm_cfg dicts never override it).
    bn_momentum: float = 0.1
    # Post-training quantization of the backbone convs (serving only):
    # "none" | "calib" (record activation ranges) | "int8" (quantized convs,
    # int32 accumulation). VoVNet only; the port does not have it yet.
    quant: str = "none"


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    kind: str = "petr"  # 'petr' | 'petrv2' | 'depthr'
    num_classes: int = 10
    num_query: int = 900
    embed_dim: int = 256
    num_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    code_size: int = 10
    depth_num: int = 64
    depth_start: float = 1.0
    depth_mode: str = "LID"
    with_multiview: bool = True
    position_range: Tuple[float, ...] = POSITION_RANGE
    pc_range: Tuple[float, ...] = PC_RANGE
    dropout_rate: float = 0.1
    shared_branches: bool = True
    # v2 extensions
    with_fpe: bool = False
    with_time: bool = False
    with_multi_reg: bool = False
    position_level: int = 0
    # depthr extensions: GT depth-map stride is depth_map_down_scale *
    # depth_encoder_down_scale and must equal the head feature stride
    # (reference C5: 8 * 4 = 32; a p4/stride-16 config uses 4 * 4); LID bin
    # parameters from `depthr_r50dcn_c5_512_1408_gtdepth.py` (80 bins,
    # 1e-3..60 m)
    depth_map_down_scale: int = 8
    depth_encoder_down_scale: int = 4
    depth_bins: int = 80
    depth_map_min: float = 1e-3
    depth_map_max: float = 60.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    backbone: BackboneConfig = BackboneConfig()
    head: HeadConfig = HeadConfig()
    use_grid_mask: bool = True
    # True (default, reference parity): ONE integer-parameter mask per
    # forward call broadcast over (B, N) — bit-exact in distribution with
    # `models/utils/grid_mask.py:84-123`. False: per-sample float-period
    # masks (strictly stronger aug of the same family).
    grid_mask_exact: bool = True
    # which FPN level feeds the head (reference position_level, petr_head.py:183)
    head_feat_level: int = 0
    compute_dtype: str = "bfloat16"
    # flash (online-softmax) decoder cross-attention kernel
    use_flash_attention: bool = True
    # activation rematerialization (reference with_cp; disable when HBM allows
    # — saves the recompute FLOPs in backward)
    remat: bool = True
    # where remat applies when remat=True: "all" (reference with_cp parity:
    # backbone blocks AND decoder layers), "backbone", or "decoder". Selective
    # remat trades HBM for recompute only where it pays at a given batch/res.
    remat_scope: str = "all"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    image_size: Tuple[int, int] = (320, 800)  # (H, W) final padded size
    num_views: int = 6
    num_frames: int = 1  # 2 for PETRv2
    max_gt: int = 128
    # image normalization (BGR order as the reference's caffe-style models)
    mean: Tuple[float, float, float] = (103.530, 116.280, 123.675)
    std: Tuple[float, float, float] = (57.375, 57.120, 58.395)
    to_rgb: bool = False
    # IDA augmentation (ResizeCropFlipImage, transform_3d.py:362-465)
    resize_lim: Tuple[float, float] = (0.47, 0.625)
    final_dim: Tuple[int, int] = (320, 800)
    bot_pct_lim: Tuple[float, float] = (0.0, 0.0)
    rot_lim: Tuple[float, float] = (0.0, 0.0)
    rand_flip: bool = True
    # BEV-space aug (GlobalRotScaleTransImage, transform_3d.py:468-548)
    bev_rot_range: Tuple[float, float] = (-0.3925, 0.3925)
    bev_scale_range: Tuple[float, float] = (0.95, 1.05)
    # source image size before IDA (nuScenes cameras are 900x1600); the
    # synthetic dataset and other rigs override it
    src_hw: Tuple[int, int] = (900, 1600)
    # GT filtering for training targets (mmdet3d NuScenesDataset
    # get_ann_info): True -> drop annotations whose `valid_flag` is False
    # (zero lidar+radar points); False -> upstream fallback num_lidar_pts>0.
    # Every shipped reference config trains with use_valid_flag=True
    # (petr_vovnet_gridmask_p4_800x320.py:210).
    use_valid_flag: bool = True


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 2e-4
    backbone_lr_mult: float = 0.1
    weight_decay: float = 0.01
    grad_clip_norm: float = 35.0
    epochs: int = 24
    warmup_iters: int = 500
    warmup_ratio: float = 1.0 / 3.0
    min_lr_ratio: float = 1e-3
    batch_size_per_device: int = 1
    # loss weights (petr_vovnet_gridmask_p4_800x320.py:95-107,117-120)
    cls_weight: float = 2.0
    bbox_weight: float = 0.25
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    code_weights: Tuple[float, ...] = (1.0,) * 8 + (0.2, 0.2)
    sync_cls_avg_factor: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optim: OptimConfig = OptimConfig()
    seed: int = 0
    log_every: int = 50
    ckpt_every_epochs: int = 1
    max_keep_ckpts: int = 3
    # Gradient accumulation: split each step's batch into `grad_accum`
    # sequential micro-batches and average the grads before the
    # single optimizer update — lets a memory-constrained slice run the
    # reference's global-batch-8 recipe (e.g. vov-p4 1600x640 on one chip).
    # mmcv GradientCumulativeOptimizerHook semantics: per-micro-batch loss
    # normalization, then gradient averaging.
    grad_accum: int = 1


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "petr_vov_p4_800x320"
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
    # NMS-free decoding (NMSFreeCoder, configs :90-97)
    max_det: int = 300
    post_center_range: Tuple[float, ...] = POSITION_RANGE
    score_threshold: Optional[float] = None


def eval_model_config(model: ModelConfig) -> ModelConfig:
    """Model config for EVAL/INFERENCE paths.

    bn_mode="batch" backbones (from-scratch training) switch to frozen stats
    — the EMA running averages the train step tracked in the bn mean/var
    params — so eval is per-sample independent (batch-size invariant, and
    the streaming feature cache stays exactly equal to the full forward).
    This is mmcv's norm_eval semantics: batch moments in train mode, running
    stats in eval mode. No-op for frozen-BN (pretrained-checkpoint) configs.
    """
    if model.backbone.bn_mode == "batch":
        return dataclasses.replace(
            model,
            backbone=dataclasses.replace(model.backbone, bn_mode="frozen"),
        )
    return model


def _r50(out_indices, dcn=(2, 3)):
    return BackboneConfig(
        kind="resnet", spec="r50", out_indices=out_indices, dcn_stages=dcn,
        with_fpn=len(out_indices) > 1,
        fpn_num_outs=len(out_indices),
        train_bn_affine=False,
    )


_CONFIGS: Dict[str, ExperimentConfig] = {}


def _register(cfg: ExperimentConfig) -> ExperimentConfig:
    _CONFIGS[cfg.name] = cfg
    return cfg


# --- PETR presets (SURVEY.md §2.8) -----------------------------------------

_register(ExperimentConfig(
    name="petr_vov_p4_800x320",
    model=ModelConfig(backbone=BackboneConfig()),
    data=DataConfig(),
))

_register(ExperimentConfig(
    name="petr_vov_p4_1600x640",
    model=ModelConfig(backbone=BackboneConfig()),
    data=DataConfig(
        image_size=(640, 1600), resize_lim=(0.94, 1.25), final_dim=(640, 1600)
    ),
))

_register(ExperimentConfig(
    name="petr_r50_c5_1408x512",
    model=ModelConfig(backbone=_r50((3,))),
    data=DataConfig(
        image_size=(512, 1408),
        mean=(103.530, 116.280, 123.675), std=(1.0, 1.0, 1.0),
        resize_lim=(0.8, 1.0), final_dim=(512, 1408),
    ),
))

_register(ExperimentConfig(
    name="petr_r50_p4_1408x512",
    model=ModelConfig(backbone=_r50((2, 3))),
    data=DataConfig(
        image_size=(512, 1408),
        mean=(103.530, 116.280, 123.675), std=(1.0, 1.0, 1.0),
        resize_lim=(0.8, 1.0), final_dim=(512, 1408),
    ),
))

_register(ExperimentConfig(
    name="petrv2_vov_p4_800x320",
    model=ModelConfig(
        backbone=BackboneConfig(),
        head=HeadConfig(
            kind="petrv2",
            with_fpe=True, with_time=True, with_multi_reg=True,
            shared_branches=False,
        ),
    ),
    data=DataConfig(num_frames=2),
    # v2 uses code_weights all-1.0 (petrv2_vovnet_gridmask_p4_800x320.py:49-53)
    train=TrainConfig(optim=OptimConfig(code_weights=(1.0,) * 10)),
))


# tiny smoke-test preset (CPU-runnable end-to-end; not a reference config)
_register(ExperimentConfig(
    name="tiny_debug",
    model=ModelConfig(
        backbone=BackboneConfig(kind="vovnet", spec="V-39-eSE", out_indices=(2, 3)),
        head=HeadConfig(num_query=32, embed_dim=64, num_layers=2, num_heads=4,
                        ffn_dim=128, depth_num=8),
        use_grid_mask=False,
        compute_dtype="float32",
    ),
    data=DataConfig(image_size=(32, 80), final_dim=(32, 80), max_gt=16),
    train=TrainConfig(optim=OptimConfig(warmup_iters=2)),
))

# shrunk VoV preset for the multi-scene synthetic generalization validation
# (tools/synth_train_eval.py): the smallest configuration measured to learn
# held-out scenes (stride-16 features at 128x320, embed 128, 3 layers)
_register(ExperimentConfig(
    name="synth_small",
    model=ModelConfig(
        backbone=BackboneConfig(kind="vovnet", spec="V-39-eSE", out_indices=(2, 3)),
        head=HeadConfig(num_query=64, embed_dim=128, num_layers=3, num_heads=4,
                        ffn_dim=256, depth_num=16),
        use_grid_mask=False,
        compute_dtype="float32",
    ),
    data=DataConfig(image_size=(128, 320), final_dim=(128, 320),
                    resize_lim=(1.0, 1.0), src_hw=(128, 320), max_gt=32),
    train=TrainConfig(optim=OptimConfig(
        lr=2e-4, warmup_iters=50, min_lr_ratio=0.2, backbone_lr_mult=1.0)),
))

# r50dcn variant of synth_small: end-to-end on-chip training validation of
# the Pallas DCNv2 custom VJP (unit-level gradient parity alone does not
# prove the kernel trains stably at real step counts). ResNet-50-DCN
# backbone exactly as the reference family (caffe BN frozen, DCN stages
# 3-4 -> Pallas kernel on 256/512-channel planes), shrunk head, bf16
# compute (the production dtype for this family).
_register(ExperimentConfig(
    name="synth_small_r50dcn",
    model=ModelConfig(
        # train_bn_affine=True deviates from the reference family ON PURPOSE:
        # the reference's frozen affine assumes ImageNet-pretrained stats;
        # training from scratch with frozen random stats AND frozen affine
        # would handicap learning for reasons unrelated to what this preset
        # validates (the DCN kernel's backward).
        backbone=dataclasses.replace(_r50((2, 3)), train_bn_affine=True),
        head=HeadConfig(num_query=64, embed_dim=128, num_layers=3, num_heads=4,
                        ffn_dim=256, depth_num=16),
        use_grid_mask=False,
    ),
    data=DataConfig(image_size=(128, 320), final_dim=(128, 320),
                    resize_lim=(1.0, 1.0), src_hw=(128, 320), max_gt=32),
    train=TrainConfig(optim=OptimConfig(
        lr=2e-4, warmup_iters=50, min_lr_ratio=0.2, backbone_lr_mult=1.0)),
))

# Depthr variant of synth_small: on-chip smoke-to-metric validation of the
# depth-guided decoder (GT-depth oracle — projected GT depth maps are exact,
# so this is the easiest head to learn; reference golden anchor
# `depthr_r50dcn_c5_512_1408_gtdepth.py:315-323`).
_register(ExperimentConfig(
    name="synth_small_depthr",
    model=ModelConfig(
        backbone=BackboneConfig(kind="vovnet", spec="V-39-eSE", out_indices=(2, 3)),
        head=HeadConfig(kind="depthr", num_query=64, embed_dim=128, num_layers=3,
                        num_heads=4, ffn_dim=256, depth_num=16,
                        # stride-16 features: 4 * 4 depth-map stride
                        depth_map_down_scale=4,
                        # synthetic scenes span ~6-34 m
                        depth_map_max=40.0, depth_bins=40),
        use_grid_mask=False,
        compute_dtype="float32",
    ),
    data=DataConfig(image_size=(128, 320), final_dim=(128, 320),
                    resize_lim=(1.0, 1.0), src_hw=(128, 320), max_gt=32),
    train=TrainConfig(optim=OptimConfig(
        lr=2e-4, warmup_iters=50, min_lr_ratio=0.2, backbone_lr_mult=1.0)),
))

# 2-frame PETRv2 variant of synth_small: the temporal-pathway validation
# preset (tools/synth_train_eval.py --config synth_small_v2 on a
# velocity_hue=False dataset — inter-frame motion is the only velocity
# signal, so beating the single-frame model's held-out mAVE proves the
# with_time normalization + sweep loader actually TRAIN, reference
# `petrv2_head.py:499-521`). Sizes match synth_small for a fair comparison.
# f32 compute, like the other synth presets: round 4 measured WHY the
# from-scratch synth recipes cannot run bf16 under the reference's frozen-BN
# regime — frozen identity stats let the backbone drift to 1e15-scale
# activations (every round-3 synth result was measured in this regime; f32
# absorbs the scale, bf16's backward overflows at ~step 900 — forensics in
# the round-4 changelog). bn_mode="batch" normalizes correctly but needs its
# own LR/warmup recipe (gnorm spikes at this preset's warmup_iters=50), so
# the pinned validation stays on the f32+frozen regime whose baselines are
# measured. Production petrv2 recipes start from pretrained stats, where
# bf16 is the validated default.
_register(ExperimentConfig(
    name="synth_small_v2",
    model=ModelConfig(
        backbone=BackboneConfig(kind="vovnet", spec="V-39-eSE", out_indices=(2, 3)),
        head=HeadConfig(kind="petrv2", num_query=64, embed_dim=128, num_layers=3,
                        num_heads=4, ffn_dim=256, depth_num=16,
                        with_fpe=True, with_time=True, with_multi_reg=True,
                        shared_branches=False),
        use_grid_mask=False,
        compute_dtype="float32",
    ),
    data=DataConfig(image_size=(128, 320), final_dim=(128, 320),
                    resize_lim=(1.0, 1.0), src_hw=(128, 320), max_gt=32,
                    num_frames=2),
    train=TrainConfig(optim=OptimConfig(
        lr=2e-4, warmup_iters=50, min_lr_ratio=0.2, backbone_lr_mult=1.0,
        code_weights=(1.0,) * 10)),
))

# tiny 2-frame (PETRv2-style) smoke preset for the streaming path
_register(ExperimentConfig(
    name="tiny_debug_v2",
    model=ModelConfig(
        backbone=BackboneConfig(kind="vovnet", spec="V-39-eSE", out_indices=(2, 3)),
        head=HeadConfig(kind="petrv2", num_query=32, embed_dim=64, num_layers=2,
                        num_heads=4, ffn_dim=128, depth_num=8,
                        with_fpe=True, with_time=True, shared_branches=False),
        use_grid_mask=False,
        compute_dtype="float32",
    ),
    data=DataConfig(image_size=(32, 80), final_dim=(32, 80), max_gt=16, num_frames=2),
    train=TrainConfig(optim=OptimConfig(warmup_iters=2, code_weights=(1.0,) * 10)),
))

_register(ExperimentConfig(
    name="depthr_r50_c5_512x1408_gtdepth",
    model=ModelConfig(
        backbone=_r50((3,)),
        head=HeadConfig(kind="depthr"),
    ),
    data=DataConfig(
        image_size=(512, 1408),
        mean=(103.530, 116.280, 123.675), std=(1.0, 1.0, 1.0),
        resize_lim=(0.8, 1.0), final_dim=(512, 1408),
    ),
))


def get_config(name: str, overrides: Optional[Sequence[str]] = None) -> ExperimentConfig:
    cfg = _CONFIGS[name]
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


# --- dotted overrides (capability of mmcv `--cfg-options`, reference
#     `tools/train.py:68-77`) -------------------------------------------------

def apply_overrides(cfg, assignments: Sequence[str]):
    """Apply `section.field=value` assignments to a (frozen) dataclass tree.

    Values are parsed as Python literals when possible (`1e-4`, `(640,1600)`,
    `True`, `None`), otherwise taken as bare strings (`vovnet`). Types are
    coerced toward the field's current value (tuple-ness, float-ness, bools).
    """
    for a in assignments:
        key, eq, raw = a.partition("=")
        if not eq:
            raise ValueError(f"override {a!r} is not of the form key=value")
        cfg = _set_dotted(cfg, key.strip().split("."), raw.strip())
    return cfg


def _set_dotted(obj, path, raw):
    import ast

    name = path[0]
    if not dataclasses.is_dataclass(obj):
        raise KeyError(f"{name!r}: parent is not a config section")
    if name not in {f.name for f in dataclasses.fields(obj)}:
        valid = ", ".join(sorted(f.name for f in dataclasses.fields(obj)))
        raise KeyError(f"unknown config field {name!r} (valid: {valid})")
    cur = getattr(obj, name)
    if len(path) == 1:
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw  # bare string
        if isinstance(cur, bool):
            val = val.lower() in ("1", "true", "yes") if isinstance(val, str) else bool(val)
        elif isinstance(cur, tuple) and isinstance(val, (list, tuple)):
            val = tuple(val)
        elif isinstance(cur, float) and isinstance(val, int):
            val = float(val)
        elif cur is not None and not isinstance(val, type(cur)) and not (
            isinstance(cur, (int, float)) and isinstance(val, (int, float))
        ):
            raise TypeError(
                f"override {name}={raw!r}: expected {type(cur).__name__}, "
                f"got {type(val).__name__}"
            )
        new = val
    else:
        new = _set_dotted(cur, path[1:], raw)
    return dataclasses.replace(obj, **{name: new})


def list_configs() -> Sequence[str]:
    return sorted(_CONFIGS)
