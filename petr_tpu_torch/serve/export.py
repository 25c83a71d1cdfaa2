"""Serving: the serving step (forward + NMS-free decode of the last decoder
layer) and its AOT artifacts.

Counterpart of `petr_tpu/serve/export.py`. ``make_serving_fn`` is the eager
step over a model on the device (numpy in, numpy out); its decode,
``decode_last_layer``, is also the eval step's
(`train/train_step.py::make_eval_step`). ``export_serving`` traces the same
step with ``torch.export`` (petr_tpu lowers it to StableHLO with
``jax.export``); ``save_artifact`` writes the program and its ``meta.json``
into one zip, which ``load_artifact`` (``petr_tpu_torch.runtime``) replays
without the model code: the kernels are ``torch.library`` ops of
``petr_tpu_torch.ops``, which the program calls by name. With
``embed_params`` the program holds the weights; otherwise it takes the
``state_dict``'s tensors, in order, before the inputs. The streaming pair
(``export_streaming``, ``save_streaming_artifact``,
``StreamingArtifactRunner``) is PETRv2's feature extractor and head, the
previous frame's features kept on the device between them. ``quant_scales``
(petr_tpu's "quant" tree) switches the model's backbone to int8 first
(``quant.apply_scales``); the scales go into the program. An int8 conv's
weight side (the BN folded in, quantised, tiled) is prepared once, not in
the program: with ``embed_params`` the program holds the prepared operands
as constants; otherwise it takes them after the weights, and
``meta["int8_operands"]`` says how the runtime prepares them once from the
weights it is given.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from petr_tpu_torch.configs.config import ExperimentConfig, eval_model_config
from petr_tpu_torch.models.detector import PETRDetector, init_weights
from petr_tpu_torch.models.layers import QuantConv2d
from petr_tpu_torch.ops.nms_free import nms_free_decode
from petr_tpu_torch.quant.ptq import apply_scales
from petr_tpu_torch.runtime import SERVING_FORMAT, STREAMING_FORMAT, StreamingArtifactRunner, load_artifact

__all__ = ["StreamingArtifactRunner", "build_detector", "decode_last_layer", "export_serving", "export_streaming",
           "load_artifact", "make_serving_fn", "make_streaming_fns", "resolve_device", "save_artifact",
           "save_streaming_artifact", "serving_input_spec", "streaming_input_spec"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device to run on; raises rather than fall back to the CPU when
    CUDA is asked for and there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def build_detector(
    cfg: ExperimentConfig, seed: int = 0, device: Union[str, torch.device] = "cuda"
) -> PETRDetector:
    """The serving (eval-config) detector of ``cfg`` with random weights drawn
    from ``seed``, on ``device``, in eval mode."""
    device = resolve_device(device)
    model = init_weights(PETRDetector(eval_model_config(cfg.model)), seed)
    return model.to(device).eval()


def decode_last_layer(cfg: ExperimentConfig, outputs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``nms_free_decode`` of the last decoder layer of the detector's
    outputs, with ``cfg``'s limits; the serving step and the eval step
    (`train/train_step.py::make_eval_step`) share it."""
    return nms_free_decode(
        outputs["cls_logits"][-1],
        outputs["bbox_codes"][-1],
        max_num=cfg.max_det,
        num_classes=cfg.model.head.num_classes,
        post_center_range=cfg.post_center_range,
        score_threshold=cfg.score_threshold,
    )


def serving_input_spec(cfg: ExperimentConfig, batch_size: int = 1) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """The serving call's positional inputs in order -> (shape, dtype):
    images, img2lidar, img_hw, and timestamp for a 2-frame config
    (`petr_tpu/serve/export.py:31-46`). Its keys are ``InferenceServer``'s
    ``input_keys``."""
    N = cfg.data.num_views * cfg.data.num_frames
    H, W = cfg.data.image_size
    spec = {
        "images": ((batch_size, N, H, W, 3), "float32"),
        "img2lidar": ((batch_size, N, 4, 4), "float32"),
        "img_hw": ((batch_size, N, 2), "float32"),
    }
    if cfg.data.num_frames > 1:
        spec["timestamp"] = ((batch_size, N), "float32")
    return spec


def _refuse_depthr(cfg: ExperimentConfig) -> None:
    if cfg.model.head.kind == "depthr":
        raise NotImplementedError(
            "the depthr head needs GT depth at test time (oracle); it has no serving path"
        )


def make_serving_fn(
    cfg: ExperimentConfig,
    model: PETRDetector,
    device: Union[str, torch.device] = "cuda",
    quant_scales: Optional[Mapping[str, Any]] = None,
) -> Callable[..., Dict[str, np.ndarray]]:
    """``fn(images, img2lidar, img_hw)``, or ``fn(images, img2lidar, img_hw,
    timestamp)`` for a 2-frame config (PETRv2), over batched numpy inputs
    in petr_tpu's layout (``serving_input_spec``) -> dict of numpy boxes
    (B, max_det, 9), scores, labels and valid (B, max_det). Moves ``model``
    to ``device``; ``quant_scales`` switches its backbone to int8 with them."""
    _refuse_depthr(cfg)
    device = resolve_device(device)
    model = model.to(device).eval()
    if quant_scales is not None:
        apply_scales(model, quant_scales)
    n_inputs = len(serving_input_spec(cfg))

    def fn(*inputs) -> Dict[str, np.ndarray]:
        if len(inputs) != n_inputs:
            raise TypeError(f"{cfg.name} serves {list(serving_input_spec(cfg))}, got {len(inputs)} inputs")
        with torch.inference_mode():
            args = [torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device) for a in inputs]
            out = model(*args[:3], timestamp=args[3] if n_inputs == 4 else None)
            return {k: v.cpu().numpy() for k, v in decode_last_layer(cfg, out).items()}

    return fn


# ------------------------------------------------------- AOT artifacts
class _Int8Conv(NamedTuple):
    conv: QuantConv2d
    spec: Dict[str, Any]  # meta["int8_operands"]'s entry: how the runtime prepares its operands
    operands: Tuple[torch.Tensor, ...]  # the tiles at each width of spec["bns"], sa, scale, add


def _int8_convs(fn: Callable, model: PETRDetector, example: Sequence[torch.Tensor]) -> List[_Int8Conv]:
    """The int8 convs that ``fn(model, *example)`` runs, in module order, with
    the operands each prepared (once) in one eager call."""
    convs = [(n, m) for n, m in model.named_modules() if isinstance(m, QuantConv2d) and m.quant == "int8"]
    if not convs:
        return []
    for _, conv in convs:
        conv.drop_int8_operands()
    with torch.no_grad():
        fn(model, *example)
    names = {id(m): n for n, m in model.named_modules()}
    out = []
    for name, conv in convs:
        got = conv.int8_prepared()
        if got is None:  # not on fn's path
            continue
        norm, (_, sa, scale, add), tiles = got
        bns = sorted(tiles)
        n = names[id(norm)]
        spec = {"weight": f"{name}.weight", "norm": [f"{n}.{k}" for k in ("weight", "bias", "running_mean",
                                                                          "running_var")],
                "eps": norm.eps, "amax": float(conv.act_amax), "bns": bns}
        out.append(_Int8Conv(conv, spec, tuple(tiles[bn] for bn in bns) + (sa, scale, add)))
    return out


class _Step(nn.Module):
    """What ``torch.export`` traces: ``forward(*params, *int8, *inputs)`` =
    ``fn(model, *inputs)``. Without ``names`` the model is a submodule and
    the program embeds its weights, and the int8 convs' prepared operands
    as buffers (``int8``). With ``names`` (the model's ``state_dict`` keys,
    in order) the weights come in as the first arguments, swapped into the
    model's modules for the call, then the int8 convs' operands, and the
    model is kept off this module, so that the program holds none of them.
    A tensor that the state_dict lists under two names (a shared branch: one
    module, two paths) is taken from the first."""

    def __init__(self, fn: Callable, model: PETRDetector, names: Optional[Sequence[str]], int8: List[_Int8Conv]):
        super().__init__()
        self.fn, self.names = fn, names
        self.int8 = [(c.conv, c.spec["bns"], len(c.operands)) for c in int8]
        if names is None:
            self.model = model
            for i, t in enumerate(t for c in int8 for t in c.operands):
                self.register_buffer(f"int8_{i}", t, persistent=False)
            return
        object.__setattr__(self, "_model", model)
        self.slots, seen = [], set()
        for i, name in enumerate(names):
            path, _, attr = name.rpartition(".")
            module = model.get_submodule(path)
            if (id(module), attr) not in seen:
                seen.add((id(module), attr))
                self.slots.append((module, attr, i))

    def forward(self, *args):
        n_int8 = sum(n for _, _, n in self.int8)
        if self.names is None:
            operands, inputs = [getattr(self, f"int8_{i}") for i in range(n_int8)], args
        else:
            n = len(self.names)
            operands, inputs = args[n:n + n_int8], args[n + n_int8:]
        saved = []
        try:
            at = 0
            for conv, bns, n in self.int8:
                ops = operands[at:at + n]
                conv._int8_given = (dict(zip(bns, ops[:len(bns)])), *ops[len(bns):])
                at += n
            if self.names is None:
                return self.fn(self.model, *inputs)
            for module, attr, i in self.slots:
                table = module._parameters if attr in module._parameters else module._buffers
                saved.append((table, attr, table[attr]))
                table[attr] = args[i]
            return self.fn(self._model, *inputs)
        finally:
            for table, attr, t in reversed(saved):
                table[attr] = t
            for conv, _, _ in self.int8:
                conv._int8_given = None


def _prepared(cfg: ExperimentConfig, model: PETRDetector, quant_scales) -> torch.device:
    """Refuse what has no artifact, switch to int8 if asked -> the model's device."""
    _refuse_depthr(cfg)
    if model.training:
        raise ValueError("export a model in eval mode (model.eval())")
    if quant_scales is not None:
        apply_scales(model, quant_scales)
    return next(model.parameters()).device


def _export(fn: Callable, model: PETRDetector, example: Sequence[torch.Tensor], embed_params: bool):
    """Trace ``fn(model, *example)`` into an ExportedProgram, with
    ``int8_operands`` set on it: what ``meta["int8_operands"]`` records for
    it (empty with ``embed_params``)."""
    int8 = _int8_convs(fn, model, example)
    state = model.state_dict()
    step = _Step(fn, model, None if embed_params else list(state), int8)
    params = () if embed_params else (*state.values(), *(t for c in int8 for t in c.operands))
    with torch.no_grad():
        ep = torch.export.export(step, (*params, *example), strict=False)
    ep.int8_operands = [] if embed_params else [c.spec for c in int8]
    return ep


def _example(spec: Mapping[str, Tuple[Tuple[int, ...], str]], device: torch.device,
             cfg: ExperimentConfig) -> Tuple[torch.Tensor, ...]:
    """Example inputs for tracing: zeros, identity cameras, each view's
    valid size the full image."""
    out = []
    for key, (shape, _) in spec.items():
        t = torch.zeros(shape, dtype=torch.float32, device=device)
        if key == "img_hw":
            t[...] = torch.tensor(cfg.data.image_size, dtype=torch.float32)
        elif key == "img2lidar":
            t[...] = torch.eye(4)
        out.append(t)
    return tuple(out)


def _serving_call(cfg: ExperimentConfig):
    with_ts = cfg.data.num_frames > 1

    def call(model, images, img2lidar, img_hw, *rest):
        out = model(images, img2lidar, img_hw, timestamp=rest[0] if with_ts else None)
        return decode_last_layer(cfg, out)

    return call


def export_serving(
    cfg: ExperimentConfig,
    model: PETRDetector,
    *,
    batch_size: int = 1,
    quant_scales: Optional[Mapping[str, Any]] = None,
    embed_params: bool = False,
):
    """Trace the serving step of ``model`` (eval mode, on its device) at a
    static ``batch_size`` -> a ``torch.export.ExportedProgram`` whose
    arguments are the ``state_dict``'s tensors in order (unless
    ``embed_params``), then ``serving_input_spec``'s inputs; it returns the
    decoded boxes, scores, labels and valid."""
    example = _example(serving_input_spec(cfg, batch_size), _prepared(cfg, model, quant_scales), cfg)
    return _export(_serving_call(cfg), model, example, embed_params)


def _meta(cfg: ExperimentConfig, model: PETRDetector, fmt: str, spec, batch_size: int, embed_params: bool,
          programs: Mapping[str, Any]) -> Dict[str, Any]:
    """``programs``: {file name in the zip: ExportedProgram}."""
    quant = {m.quant for name, m in model.named_modules() if hasattr(m, "set_quant")}
    ops = sorted({str(node.target) for ep in programs.values() for node in ep.graph.nodes
                  if node.op == "call_function" and str(node.target).startswith("petr_tpu_torch.")})
    return {
        "format": fmt,
        "config": cfg.name,
        "batch_size": batch_size,
        "embed_params": embed_params,
        "device": next(model.parameters()).device.type,
        "input_spec": {k: [list(shape), dtype] for k, (shape, dtype) in spec.items()},
        "quant": "int8" if "int8" in quant else cfg.model.backbone.quant,
        "ops": "petr_tpu_torch.ops",
        "op_names": ops,
        "param_names": [] if embed_params else list(model.state_dict()),
        # which of them are parameters: a tensor that requires grad makes
        # matmul fold its batch dimensions otherwise, a different sum order
        "param_requires_grad": [] if embed_params else [
            bool(t.requires_grad) for t in model.state_dict(keep_vars=True).values()],
        # per program, the int8 convs whose operands follow the weights
        # (``runtime.prepare_int8_operands``): weight and BN names, eps, the
        # calibrated max, the tile widths
        "int8_operands": {name: ep.int8_operands for name, ep in programs.items()
                          if getattr(ep, "int8_operands", None)},
        "torch": torch.__version__,
    }


def _program_bytes(ep) -> bytes:
    """The saved program, without the example inputs it was traced on (with
    external weights those hold a copy of every weight)."""
    ep._example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def save_artifact(path: str, exported, cfg: ExperimentConfig, model: PETRDetector, *, batch_size: int,
                  embed_params: bool) -> Dict[str, Any]:
    """Write ``export_serving``'s program and its ``meta.json`` (petr_tpu's
    keys, with ``device`` for ``platforms`` and the op library ``ops``) into
    the zip ``path`` -> the meta."""
    meta = _meta(cfg, model, SERVING_FORMAT, serving_input_spec(cfg, batch_size), batch_size, embed_params,
                 {"program.pt2": exported})
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr("program.pt2", _program_bytes(exported))
    return meta


# ----------------------------------------------------- streaming artifacts
def streaming_input_spec(cfg: ExperimentConfig, batch_size: int = 1) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Per-frame inputs of the streaming runtime: images of the CURRENT 6
    views only; matrices and timestamps for all 12 (current first)."""
    if cfg.data.num_frames < 2:
        raise ValueError("streaming export needs a 2-frame (petrv2) config")
    N6 = cfg.data.num_views
    N = N6 * cfg.data.num_frames
    H, W = cfg.data.image_size
    return {
        "images": ((batch_size, N6, H, W, 3), "float32"),
        "img2lidar": ((batch_size, N, 4, 4), "float32"),
        "img_hw": ((batch_size, N, 2), "float32"),
        "timestamp": ((batch_size, N), "float32"),
    }


def make_streaming_fns(cfg: ExperimentConfig):
    """(feature_fn, head_fn) over a model: ``feature_fn(model, images6)`` ->
    the head's features (B, 6, fh, fw, fc); ``head_fn(model, cur_feats,
    prev_feats, img2lidar, img_hw, timestamp)`` -> the decoded boxes, as the
    serving step's."""
    input_hw = tuple(cfg.data.image_size)

    def feature_fn(model, images):
        return model.extract_feats(images)

    def head_fn(model, cur, prev, img2lidar, img_hw, timestamp):
        out = model.forward_head(torch.cat([cur, prev], dim=1), img2lidar, img_hw, input_hw, timestamp=timestamp)
        return decode_last_layer(cfg, out)

    return feature_fn, head_fn


def export_streaming(
    cfg: ExperimentConfig,
    model: PETRDetector,
    *,
    batch_size: int = 1,
    quant_scales: Optional[Mapping[str, Any]] = None,
    embed_params: bool = False,
):
    """Trace the streaming pair (feature extractor, head + decode) -> two
    ExportedPrograms, each taking the ``state_dict``'s tensors first unless
    ``embed_params``."""
    spec = streaming_input_spec(cfg, batch_size)
    feature_fn, head_fn = make_streaming_fns(cfg)
    images, img2lidar, img_hw, timestamp = _example(spec, _prepared(cfg, model, quant_scales), cfg)
    with torch.no_grad():
        feats = feature_fn(model, images)
    ef = _export(feature_fn, model, (images,), embed_params)
    # two tensors: one passed twice would trace as one input
    eh = _export(head_fn, model, (feats, feats.clone(), img2lidar, img_hw, timestamp), embed_params)
    return ef, eh


def save_streaming_artifact(path: str, exported_pair, cfg: ExperimentConfig, model: PETRDetector, *,
                            batch_size: int, embed_params: bool) -> Dict[str, Any]:
    """Write the streaming pair and its ``meta.json`` into the zip ``path``
    (replayed by ``StreamingArtifactRunner``) -> the meta."""
    ef, eh = exported_pair
    meta = _meta(cfg, model, STREAMING_FORMAT, streaming_input_spec(cfg, batch_size), batch_size, embed_params,
                 {"feature.pt2": ef, "head.pt2": eh})
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr("feature.pt2", _program_bytes(ef))
        z.writestr("head.pt2", _program_bytes(eh))
    return meta
