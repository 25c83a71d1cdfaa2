"""petr_tpu param tree -> port ``state_dict``.

The inverse of `petr_tpu/utils/torch_convert.py::convert_state_dict` for the
modules the port has (VoVNet and the r50dcn ResNet, CPFPN, the PETR,
PETRv2 and Depthr heads; petr_tpu's converter has no Depthr names):
flax conv kernels HWIO -> OIHW, Dense kernels
(in, out) -> (out, in) (or (out, in, 1, 1) where the reference has a 1x1
conv), q/k/v Dense layers packed into ``in_proj_weight`` / ``in_proj_bias``,
flax LayerNorm/BatchNorm leaf names -> torch names. Shared cls/reg
branches (``cls_branch``) appear once per decoder layer, as in the reference
``state_dict``; unshared ones (``cls_branch_{l}``) map to layer l. A
``reg_branch`` with ``task{g}_*`` leaves is PETRv2's ``RegLayer``: its
trunk ``fc{i}`` goes to ``reg_branch.{3i}`` and its groups to
``task_heads.{g}.{0,2}``. The Depthr head's decoder layers sit directly
under ``head`` (``layer{l}``, ``post_norm``); they map to the port's
``transformer.decoder``, its three attentions to ``attentions.{0,1,2}``, its
four norms to ``norms.{0..3}``, and its ``depth_gt_encoder`` (``conv{i}``,
``gn{i}``, ``depth_pos_embed``) to the reference module's
``depth_head.{i}.{0,1}`` and ``depth_pos_embed.weight``.

Parameter trees come as nested dicts of numpy arrays (``jax.device_get``
of a petr_tpu ``params``); nothing here imports JAX. Any tree shaped like
the params maps the same way: a gradient tree, or the params after an
optimizer update (``named_parameters_from_jax``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from petr_tpu_torch.models.dgcnn import ConvTranspose2d
from petr_tpu_torch.models.layers import FFN, MultiheadAttention
from petr_tpu_torch.models.petr_head import ClsBranch, RegBranch

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_LN = {"scale": "weight", "bias": "bias"}
_CLS_INDEX = {"fc0": 0, "ln0": 1, "fc1": 3, "ln1": 4, "out": 6}
_REG_INDEX = {"fc0": 0, "fc1": 2, "out": 4}
_MLP_INDEX = {"fc0": 0, "fc1": 2}
_POSENC_INDEX = {"fc1": 0, "fc2": 2}
# decoder attentions: PETR's self/cross, Depthr's self/depth/view
_ATTN_INDEX = {"self_attn": 0, "cross_attn": 1, "cross_depth_attn": 1, "cross_view_attn": 2}
_ATTN = "|".join(_ATTN_INDEX)


def _conv(w):  # HWIO -> OIHW
    return np.transpose(w, (3, 2, 0, 1))


def _lin(w):  # (in, out) -> (out, in)
    return np.transpose(w, (1, 0))


def _pointwise(w):  # (in, out) -> (out, in, 1, 1)
    return np.transpose(w, (1, 0))[:, :, None, None]


def _same(w):
    return w


def _param(leaf: str, weight_fn) -> Tuple[str, Any]:
    return ("weight", weight_fn) if leaf == "kernel" else ("bias", _same)


def _backbone(p: str):
    m = re.fullmatch(r"stem(\d)\.(conv|bn)\.(\w+)", p)
    if m:
        i, kind, leaf = m.groups()
        if kind == "conv":
            return f"stem.stem_{i}/conv.weight", _conv
        return f"stem.stem_{i}/norm.{_BN[leaf]}", _same
    m = re.fullmatch(r"stage(\d)_block(\d+)\.(conv\d+|concat)\.(conv|bn)\.(\w+)", p)
    if m:
        s, b, sub, kind, leaf = m.groups()
        osa = f"OSA{s}_{int(b) + 1}"
        inner = f"layers.{sub[4:]}.{osa}_{sub[4:]}" if sub != "concat" else f"concat.{osa}_concat"
        if kind == "conv":
            return f"stage{s}.{osa}.{inner}/conv.weight", _conv
        return f"stage{s}.{osa}.{inner}/norm.{_BN[leaf]}", _same
    m = re.fullmatch(r"stage(\d)_block(\d+)\.ese\.fc\.(kernel|bias)", p)
    if m:
        s, b, leaf = m.groups()
        name, fn = _param(leaf, _conv)
        return f"stage{s}.OSA{s}_{int(b) + 1}.ese.fc.{name}", fn
    return _resnet(p)


def _resnet(p: str):
    """petr_tpu's ResNet leaves -> mmdet names (`torch_convert.py::_map_resnet`
    read backwards); the DCN weight ``conv2_weight`` is HWIO like a kernel."""
    if p == "stem_conv.kernel":
        return "conv1.weight", _conv
    m = re.fullmatch(r"stem_bn\.(\w+)", p)
    if m:
        return f"bn1.{_BN[m.group(1)]}", _same
    m = re.fullmatch(r"layer(\d)_block(\d+)\.(.+)", p)
    if not m:
        return None
    s, b, rest = m.groups()
    pre = f"layer{s}.{b}."
    if rest == "conv2_weight":
        return pre + "conv2.weight", _conv
    m = re.fullmatch(r"conv2_offset\.(kernel|bias)", rest)
    if m:
        name, fn = _param(m.group(1), _conv)
        return f"{pre}conv2.conv_offset.{name}", fn
    m = re.fullmatch(r"(conv\d|downsample_conv)\.kernel", rest)
    if m:
        return pre + ("downsample.0" if m.group(1) == "downsample_conv" else m.group(1)) + ".weight", _conv
    m = re.fullmatch(r"(bn\d|downsample_bn)\.(\w+)", rest)
    if m:
        return pre + ("downsample.1" if m.group(1) == "downsample_bn" else m.group(1)) + f".{_BN[m.group(2)]}", _same
    return None


def _neck(p: str):
    m = re.fullmatch(r"lateral(\d+)\.(kernel|bias)", p)
    if m:
        name, fn = _param(m.group(2), _conv)
        return f"lateral_convs.{m.group(1)}.conv.{name}", fn
    m = re.fullmatch(r"fpn_conv0\.(kernel|bias)", p)
    if m:
        name, fn = _param(m.group(1), _conv)
        return f"fpn_convs.0.conv.{name}", fn
    return None


def _head(p: str):
    """Head leaves except the branches and q/k/v, which need the whole tree."""
    if p == "reference_points":
        return "reference_points.weight", _same
    m = re.fullmatch(r"input_proj\.(kernel|bias)", p)
    if m:
        name, fn = _param(m.group(1), _pointwise)
        return f"input_proj.{name}", fn
    m = re.fullmatch(r"(position_encoder|adapt_pos3d|query_embedding)\.(fc\d)\.(kernel|bias)", p)
    if m:
        mod, fc, leaf = m.groups()
        index = (_POSENC_INDEX if mod == "position_encoder" else _MLP_INDEX)[fc]
        name, fn = _param(leaf, _lin if mod == "query_embedding" else _pointwise)
        return f"{mod}.{index}.{name}", fn
    m = re.fullmatch(r"depth_gt_encoder\.(conv|gn)(\d+)\.(kernel|scale|bias)", p)
    if m:
        kind, i, leaf = m.groups()
        if kind == "conv":
            name, fn = _param(leaf, _conv)
            return f"depth_gt_encoder.depth_head.{i}.0.{name}", fn
        return f"depth_gt_encoder.depth_head.{i}.1.{_LN[leaf]}", _same
    if p == "depth_gt_encoder.depth_pos_embed":
        return "depth_gt_encoder.depth_pos_embed.weight", _same
    m = re.fullmatch(r"fpe\.(conv_reduce|conv_expand)\.(kernel|bias)", p)
    if m:
        name, fn = _param(m.group(2), _conv)
        return f"fpe.{m.group(1)}.{name}", fn
    m = re.fullmatch(r"transformer\.decoder\.post_norm\.(scale|bias)", p)
    if m:
        return f"transformer.decoder.post_norm.{_LN[m.group(1)]}", _same
    m = re.fullmatch(r"transformer\.decoder\.layer(\d+)\.(.*)", p)
    if m:
        lvl, rest = m.groups()
        pre = f"transformer.decoder.layers.{lvl}."
        m2 = re.fullmatch(rf"({_ATTN})\.out_proj\.(kernel|bias)", rest)
        if m2:
            name, fn = _param(m2.group(2), _lin)
            return f"{pre}attentions.{_ATTN_INDEX[m2.group(1)]}.attn.out_proj.{name}", fn
        m2 = re.fullmatch(r"ffn\.(fc1|fc2)\.(kernel|bias)", rest)
        if m2:
            name, fn = _param(m2.group(2), _lin)
            sub = "layers.0.0" if m2.group(1) == "fc1" else "layers.1"
            return f"{pre}ffns.0.{sub}.{name}", fn
        m2 = re.fullmatch(r"norm([1234])\.(scale|bias)", rest)
        if m2:
            return f"{pre}norms.{int(m2.group(1)) - 1}.{_LN[m2.group(2)]}", _same
    return None


def _branch_index(kind: str, sub: str, multi_reg: bool) -> str:
    """The port's child path of a branch leaf's module ``sub``."""
    if kind == "cls":
        return str(_CLS_INDEX[sub])
    if not multi_reg:
        return str(_REG_INDEX[sub])
    m = re.fullmatch(r"fc(\d+)", sub)
    if m:  # the RegLayer trunk: Linear, ReLU, Dropout per fc
        return f"reg_branch.{3 * int(m.group(1))}"
    g, part = re.fullmatch(r"task(\d+)_(fc|out)", sub).groups()
    return f"task_heads.{g}.{0 if part == 'fc' else 2}"


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Dotted leaf paths; the Depthr head's ``head.layer{l}`` and
    ``head.post_norm`` go under ``head.transformer.decoder`` as PETR's."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            key = re.sub(r"^head\.(layer\d+|post_norm)\.", r"head.transformer.decoder.\1.", key)
            out[key] = np.asarray(v, dtype=np.float32)
    return out


def _leaves(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Dotted leaf paths of a param tree, as they are."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, dtype=np.float32)
    return out


def _child(module: nn.Module, name: str) -> Tuple[nn.Module, str]:
    """The port submodule of ``module`` that petr_tpu's submodule ``name``
    is, and its path: the same name, except inside the port's
    ``MultiheadAttention`` (``out_proj`` -> ``attn.out_proj``), ``FFN``
    (``fc1``/``fc2`` -> ``layers.0.0``/``layers.1``) and the cls/reg
    branches (``fc{i}``, ``ln{i}``, ``out`` -> the nn.Sequential's index)."""
    path = name
    if isinstance(module, MultiheadAttention) and name == "out_proj":
        path = "attn.out_proj"
    elif isinstance(module, FFN):
        path = {"fc1": "layers.0.0", "fc2": "layers.1"}.get(name, name)
    elif isinstance(module, (ClsBranch, RegBranch)):
        per_fc = 3 if isinstance(module, ClsBranch) else 2
        m = re.fullmatch(r"(fc|ln)(\d+)", name)
        if m:
            path = str(per_fc * int(m.group(2)) + (m.group(1) == "ln"))
        elif name == "out":
            path = str(len(module) - 1)
    try:
        return module.get_submodule(path), path
    except AttributeError:
        raise KeyError(f"{type(module).__name__} has no submodule for petr_tpu's {name!r}") from None


def _module_state_dict(params: Mapping[str, Any], model: nn.Module) -> Dict[str, np.ndarray]:
    """A param tree of one of petr_tpu's standalone modules (the DETR3D and
    Object-DGCNN families, ``MSDeformableAttention``,
    ``LearnedPositionalEncoding3D``, ``ClsBranch``) -> the ``state_dict`` of
    its port ``model``, whose submodules carry petr_tpu's names. Each leaf
    is placed by walking ``model`` along its path (``_child``): Dense
    kernels (in, out) -> (out, in); conv kernels HWIO -> OIHW; a
    ``ConvTranspose`` kernel (kh, kw, in, out) -> (in, out, kh, kw) flipped
    in space (flax's does not flip it, torch's does); LayerNorm ``scale`` ->
    ``weight``; a raw param keeps its name; q/k/v projections packed into
    ``attn.in_proj_weight`` / ``attn.in_proj_bias``."""
    sd: Dict[str, np.ndarray] = {}
    qkv: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in _leaves(params).items():
        *names, leaf = key.split(".")
        module, path = model, []
        for i, name in enumerate(names):
            if isinstance(module, MultiheadAttention) and name in ("q_proj", "k_proj", "v_proj") and i == len(names) - 1:
                qkv.setdefault(".".join(path), {})[f"{name[0]}.{leaf}"] = val
                break
            module, sub = _child(module, name)
            path.append(sub)
        else:
            if leaf == "kernel":
                if isinstance(module, ConvTranspose2d):
                    val = np.transpose(val[::-1, ::-1], (2, 3, 0, 1))
                else:
                    val = _conv(val) if val.ndim == 4 else _lin(val)
                leaf = "weight"
            elif leaf == "scale":
                leaf = "weight"
            sd[".".join(path + [leaf])] = val
    for pre, parts in qkv.items():
        missing = [f"{w}.{leaf}" for leaf in ("kernel", "bias") for w in "qkv" if f"{w}.{leaf}" not in parts]
        if missing:
            raise KeyError(f"{pre}: missing {missing}")
        pre = f"{pre}." if pre else ""
        sd[pre + "attn.in_proj_weight"] = np.concatenate([_lin(parts[f"{w}.kernel"]) for w in "qkv"], 0)
        sd[pre + "attn.in_proj_bias"] = np.concatenate([parts[f"{w}.bias"] for w in "qkv"], 0)
    return sd


def state_dict_from_jax(
    params: Mapping[str, Any],
    reference: Optional[Union[nn.Module, Mapping[str, torch.Tensor]]] = None,
) -> Dict[str, torch.Tensor]:
    """Turn a petr_tpu ``PETRDetector`` param tree (``backbone``/``neck``/
    ``head`` subtrees, any subset) into the port's ``state_dict``; or, with
    a port module as ``reference`` and a tree of anything else, the tree of
    the petr_tpu module it ports (``_module_state_dict``).

    Raises on a leaf no rule maps. With ``reference`` (a port module or its
    ``state_dict``), also raises on a key of the reference that nothing
    filled, on a key the reference lacks, and on a shape that differs.
    """
    if isinstance(reference, nn.Module) and not set(params) <= {"backbone", "neck", "head"}:
        return _checked(_module_state_dict(params, reference), reference)
    flat = _flatten(params)
    sd: Dict[str, np.ndarray] = {}
    qkv: Dict[Tuple[str, str], Dict[str, np.ndarray]] = {}
    branches: Dict[str, np.ndarray] = {}
    leftover = []
    layers = {int(m.group(1)) for k in flat
              if (m := re.match(r"head\.transformer\.decoder\.layer(\d+)\.", k))}
    multi_reg = any(re.match(r"head\.reg_branch(_\d+)?\.task\d+_", k) for k in flat)
    for key, val in flat.items():
        top, _, p = key.partition(".")
        if top == "head":
            m = re.fullmatch(rf"transformer\.decoder\.layer(\d+)\.({_ATTN})\.([qkv])_proj\.(kernel|bias)", p)
            if m:
                lvl, att, which, leaf = m.groups()
                qkv.setdefault((lvl, att), {})[f"{which}.{leaf}"] = val
                continue
            m = re.fullmatch(r"(cls|reg)_branch(?:_(\d+))?\.(\w+)\.(kernel|scale|bias)", p)
            if m:
                kind, lvl, sub, leaf = m.groups()
                index = _branch_index(kind, sub, multi_reg)
                name = "bias" if leaf == "bias" else "weight"
                val = _lin(val) if leaf == "kernel" else val
                if lvl is None:  # shared: the same module at every layer
                    branches[f"{kind}_branches.{{}}.{index}.{name}"] = val
                else:
                    sd[f"pts_bbox_head.{kind}_branches.{lvl}.{index}.{name}"] = val
                continue
        rule = {"backbone": _backbone, "neck": _neck, "head": _head}.get(top)
        mapped = rule(p) if rule else None
        if mapped is None:
            leftover.append(key)
            continue
        name, fn = mapped
        prefix = {"backbone": "img_backbone.", "neck": "img_neck.", "head": "pts_bbox_head."}[top]
        sd[prefix + name] = fn(val)
    if leftover:
        raise KeyError(f"petr_tpu leaves with no port counterpart: {leftover}")

    for (lvl, att), parts in qkv.items():
        missing = [f"{w}.{leaf}" for leaf in ("kernel", "bias") for w in "qkv"
                   if f"{w}.{leaf}" not in parts]
        if missing:
            raise KeyError(f"decoder layer {lvl} {att}: missing {missing}")
        pre = f"pts_bbox_head.transformer.decoder.layers.{lvl}.attentions.{_ATTN_INDEX[att]}.attn."
        sd[pre + "in_proj_weight"] = np.concatenate([_lin(parts[f"{w}.kernel"]) for w in "qkv"], 0)
        sd[pre + "in_proj_bias"] = np.concatenate([parts[f"{w}.bias"] for w in "qkv"], 0)
    for template, val in branches.items():
        for lvl in sorted(layers):
            sd["pts_bbox_head." + template.format(lvl)] = val

    return _checked(sd, reference)


def _checked(sd: Dict[str, np.ndarray], reference) -> Dict[str, torch.Tensor]:
    out = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
    if reference is not None:
        ref = reference.state_dict() if isinstance(reference, nn.Module) else reference
        missing = sorted(set(ref) - set(out))
        unexpected = sorted(set(out) - set(ref))
        if missing or unexpected:
            raise KeyError(f"state_dict mismatch: missing {missing}, unexpected {unexpected}")
        for k, v in out.items():
            if tuple(v.shape) != tuple(ref[k].shape):
                raise ValueError(f"shape mismatch at {k}: {tuple(v.shape)} vs {tuple(ref[k].shape)}")
    return out


def named_parameters_from_jax(
    tree: Mapping[str, Any], model: nn.Module
) -> Dict[str, torch.Tensor]:
    """A tree shaped like petr_tpu's params (the params, their gradients,
    the params after an update) under the names of ``model.named_parameters()``.

    Leaves the port keeps as buffers (the BN statistics, which petr_tpu
    keeps as params and differentiates) are dropped, and a shared branch
    appears once, as ``named_parameters`` lists it; an unshared one once per
    layer.
    """
    sd = state_dict_from_jax(tree, model)
    return {name: sd[name] for name, _ in model.named_parameters()}


# ------------------------------------------------------- int8 PTQ scales
# petr_tpu keeps each quantised conv's calibrated max |x| in its "quant"
# collection, ``{"backbone": {"stem1": {"act_amax": ()}, "stage2_block0":
# {"conv0": ..., "concat": ...}, ...}}``; the port keeps it on the conv
# (``models.layers.QuantConv2d.act_amax``). These carry one to the other.
_QUANT_STEM = re.compile(r"img_backbone\.stem\.stem_(\d)/conv")
_QUANT_OSA = re.compile(r"img_backbone\.stage(\d)\.OSA\d_(\d+)\.(?:layers\.(\d+)\.OSA\d_\d+_\d+|concat\.OSA\d_\d+_concat)/conv")


def quant_path_from_port(name: str) -> Tuple[str, ...]:
    """A quantised conv's module name in the port's detector -> its leaf's
    path in petr_tpu's "quant" tree."""
    m = _QUANT_STEM.fullmatch(name)
    if m:
        return ("backbone", f"stem{m.group(1)}", "act_amax")
    m = _QUANT_OSA.fullmatch(name)
    if m:
        s, b, i = m.groups()
        return ("backbone", f"stage{s}_block{int(b) - 1}", "concat" if i is None else f"conv{i}", "act_amax")
    raise KeyError(f"{name} is not a quantised conv of the VoVNet backbone")


def quant_scales_to_port(tree: Mapping[str, Any], names) -> Dict[str, np.ndarray]:
    """petr_tpu's "quant" tree -> {conv module name: amax} for the port's
    quantised convs ``names``; raises on a conv the tree lacks and on a
    leaf no conv takes."""
    flat = {tuple(k.split("/")): v for k, v in flatten_quant_tree(tree).items()}
    out, missing = {}, []
    for name in names:
        path = quant_path_from_port(name)
        if path in flat:
            out[name] = np.asarray(flat.pop(path), dtype=np.float32)
        else:
            missing.append("/".join(path))
    if missing or flat:
        raise KeyError(f"quant scales: missing {missing}, unexpected {sorted('/'.join(k) for k in flat)}")
    return out


def quant_scales_from_port(scales: Mapping[str, Any]) -> Dict[str, Any]:
    """{conv module name: amax} -> petr_tpu's nested "quant" tree of fp32
    numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, v in scales.items():
        *parents, leaf = quant_path_from_port(name)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v, dtype=np.float32)
    return tree


def flatten_quant_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A "quant" tree -> {"backbone/stem1/act_amax": array, ...}, the keys of
    petr_tpu's ``save_scales``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten_quant_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out
