"""Import reference (mmdet3d) torch checkpoints into the port's detectors.

Counterpart of `petr_tpu/utils/torch_convert.py`. The port's parameters
already carry the reference's names and layouts (OIHW convs, (out, in)
Linear weights, packed MHA ``in_proj``), so no transpose is needed: the
import is the reference's legacy-key remapping (`petr_head.py:336-364`:
``.self_attn.`` -> ``.attentions.0.`` and so on), applied first so that
old and new released checkpoints both load, then a strict match of names
and shapes.

Shared cls/reg branches (``shared_branches``) are one module repeated per
decoder layer in both the reference and the port; as petr_tpu does, level
0 is read and the other levels' keys are neither matched nor skipped. The
counts are petr_tpu's, leaf for leaf, so that both packages report the same
numbers for the same file: ``matched`` counts the target leaves filled (a
packed ``in_proj`` is petr_tpu's three q/k/v leaves), ``skipped`` the
reference keys that fill nothing (BatchNorm's ``num_batches_tracked``, other
models' keys, a shape that disagrees) and ``unfilled`` the target leaves no
key filled.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

LEGACY_MAP = {
    ".self_attn.": ".attentions.0.",
    ".multihead_attn.": ".attentions.1.",
    ".decoder.norm.": ".decoder.post_norm.",
}
# older mmdet DCN bottlenecks kept the offset conv as a sibling of conv2
# (`conv2_offset`); mmcv's ModulatedDeformConv2dPack, and the port, nest it
_DCN_SIBLING = re.compile(r"(img_backbone\.layer\d\.\d+\.)conv2_offset\.")
_BRANCH = re.compile(r"pts_bbox_head\.(?:cls|reg)_branches\.(\d+)\.")
_PACKED = re.compile(r".*\.attn\.in_proj_(?:weight|bias)")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a reference ``.pth`` (mmcv wraps them in
    ``{"state_dict": ..., "meta": ...}``); other entries are dropped. The
    file is unpickled in full, as mmcv writes it: read trusted files only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _apply_legacy(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        for old, new in LEGACY_MAP.items():
            if old in k:
                k = k.replace(old, new)
        out[_DCN_SIBLING.sub(r"\1conv2.conv_offset.", k)] = v
    return out


def _leaves(name: str) -> int:
    """petr_tpu's leaves behind a port entry: a packed in_proj is three."""
    return 3 if _PACKED.fullmatch(name) else 1


def _shared_copy(name: str, shared_branches: bool) -> bool:
    """A cls/reg branch key of a decoder layer above 0 under shared branches."""
    m = _BRANCH.match(name)
    return bool(shared_branches and m and m.group(1) != "0")


def convert_state_dict(
    sd: Mapping[str, torch.Tensor],
    target: Mapping[str, torch.Tensor],
    shared_branches: bool = True,
    verbose: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """Match a reference checkpoint to ``target`` (a port ``state_dict``).

    Returns (the entries filled, by port name: under shared branches level
    0's values for every level; stats {matched, skipped, unfilled})."""
    filled: Dict[str, torch.Tensor] = {}
    stats = {"matched": 0, "skipped": 0}
    for key, val in _apply_legacy(sd).items():
        if _shared_copy(key, shared_branches):
            continue  # the same module repeated; layer 0 is read
        want = target.get(key)
        if want is None or tuple(want.shape) != tuple(val.shape):
            stats["skipped"] += 1
            if verbose:
                print(f"skip: {key}" if want is None
                      else f"FAIL {key}: shape {tuple(val.shape)} vs {tuple(want.shape)}")
            continue
        filled[key] = val
        stats["matched"] += _leaves(key)
    if shared_branches:
        for name in target:
            first = re.sub(r"(_branches\.)\d+\.", r"\g<1>0.", name, count=1)
            if _shared_copy(name, True) and first in filled:
                filled[name] = filled[first]
    stats["unfilled"] = sum(_leaves(n) for n in target if n not in filled and not _shared_copy(n, shared_branches))
    return filled, stats


def load_reference_weights(model: nn.Module, sd: Mapping[str, torch.Tensor], shared_branches: bool = True,
                           verbose: bool = False, allow_partial: bool = False) -> Dict[str, int]:
    """Load a reference state dict into ``model`` strictly (every key of the
    model set, the ones the checkpoint lacks to their current values, only
    with ``allow_partial``) and return the stats of ``convert_state_dict``."""
    current = model.state_dict()
    filled, stats = convert_state_dict(sd, current, shared_branches, verbose)
    if stats["unfilled"] and not allow_partial:
        raise ValueError(f"{stats['unfilled']} target leaves not covered by the reference checkpoint "
                         "(allow_partial for backbone-only imports)")
    model.load_state_dict({**current, **filled}, strict=True)
    return stats
