"""Weight images of the bf16 tensor-core kernels, laid out once per weight version.

K4 (``ops.dcn``) and K5 (``ops.conv3x3``) read their weight as an image laid
out for wgmma (bf16, no-swizzle K-major tiles that one bulk copy brings into
shared memory). Laying it out is a copy kernel or two per call; a served
model's weights never change, so ``cached_image`` keeps each image beside
the weight it came from and makes it again only when that weight is another
tensor object, was updated in place (its version counter: ``copy_``,
``load_state_dict``, an optimizer step) or moved (device, data pointer). A
training step updates its weights once, so it lays each one out once: the
forward's, and the remat recompute's call hits. An entry goes when its
weight is freed. A write through ``.data`` bypasses version counters: call
``clear()`` after one. Inference tensors carry no version counter: their
images are made on every call.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Hashable, Tuple

import torch

_images: Dict[Tuple[int, Hashable], Tuple[weakref.ref, tuple, torch.Tensor]] = {}


def _mark(weight: torch.Tensor) -> tuple:
    return (weight._version, weight.data_ptr(), weight.device, weight.dtype, tuple(weight.shape),
            tuple(weight.stride()))


def cached_image(weight: torch.Tensor, kind: Hashable, make: Callable[[torch.Tensor], torch.Tensor]
                 ) -> torch.Tensor:
    """``make(weight)`` (under ``no_grad``), kept for the next call with the
    same ``weight`` and ``kind`` while the weight is unchanged."""
    if weight.is_inference():
        with torch.no_grad():
            return make(weight)
    key = (id(weight), kind)
    hit = _images.get(key)
    if hit is not None and hit[0]() is weight and hit[1] == _mark(weight):
        return hit[2]
    with torch.no_grad():
        image = make(weight)

    def forget(ref, key=key):
        entry = _images.get(key)
        if entry is not None and entry[0] is ref:
            del _images[key]

    _images[key] = (weakref.ref(weight, forget), _mark(weight), image)
    return image


def clear() -> None:
    """Forget every image: the next call of each kernel lays its weight out."""
    _images.clear()
