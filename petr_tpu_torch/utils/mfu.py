"""MFU (model FLOPs utilisation) reporting helpers.

Counterpart of `petr_tpu/utils/mfu.py`: turns "fast" into a falsifiable
number, the achieved TFLOP/s of a measured run and its share of the card's
peak matmul rate.

XLA's cost analysis, which petr_tpu reads (``compiled_flops``,
``lowered_flops``), has no PyTorch counterpart. ``count_flops`` counts the
dot, conv and attention work of one call from shapes instead, through
``torch.utils.flop_counter``, and reads the same work whichever route runs
it: each kernel's ``torch.library`` op (K1, K4, K5, K6) carries a registered
formula equal to its plain version's aten count, and K2, launched by ctypes
inside an autograd backward where no dispatcher sees it, adds its formula
to ``ops.cross_attention.BACKWARD_FLOPS``, which is read here. A counter
that runs the whole step counts every micro-batch of a gradient
accumulation, so no correction for it is needed (XLA counts a scan body
once: `petr_tpu/cli/benchmark.py:119-126`).
"""

from __future__ import annotations

import contextlib
import subprocess
from typing import Iterator, Optional

import torch

# Peak dense bf16 tensor-core TFLOP/s, matched on torch.cuda.get_device_name
# (lower case), the first key that occurs in it wins. NVIDIA's data sheets:
# H100 SXM 989, H100 PCIe 756 (the SXM part names itself "H100 80GB HBM3").
_PEAK_TFLOPS = (
    ("h100 pcie", 756.0),
    ("h100 sxm", 989.0),
    ("h100 80gb hbm3", 989.0),
)


def _device(device=None) -> Optional[torch.device]:
    if device is None:
        return torch.device("cuda", 0) if torch.cuda.is_available() else None
    device = torch.device(device)
    return device if device.type == "cuda" and torch.cuda.is_available() else None


def device_peak_tflops(device=None) -> Optional[float]:
    """Peak bf16 TFLOP/s of ``device`` (default: the first card), or None on
    the CPU or an unknown card."""
    dev = _device(device)
    if dev is None:
        return None
    kind = torch.cuda.get_device_name(dev).lower()
    for key, peak in _PEAK_TFLOPS:
        if key in kind:
            return peak
    return None


def device_name(device=None) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (the name alone
    where nvidia-smi cannot be run), or "cpu"."""
    dev = _device(device)
    if dev is None:
        return "cpu"
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()
        return lines[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


def count_flops(fn, *args, **kwargs) -> int:
    """FLOPs of one call of ``fn(*args, **kwargs)``: 2 per multiply-add of
    every matmul, conv and attention it runs, forward and backward (a
    remat recompute included), on the plain and the kernel route alike."""
    from torch.utils.flop_counter import FlopCounterMode

    from petr_tpu_torch.ops import cross_attention as ca

    before = ca.BACKWARD_FLOPS
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops()) + ca.BACKWARD_FLOPS - before


@contextlib.contextmanager
def plain_kernels() -> Iterator[None]:
    """Every kernel's call site in the models routed to its plain version
    (the same autograd Function on dense PyTorch), as it was on exit: the
    yardstick of ``count_flops``' route invariance."""
    from petr_tpu_torch.models import layers, resnet
    from petr_tpu_torch.ops import conv3x3, conv_int8, cross_attention, dcn

    def flash_plain(q, k, v, key_padding_mask=None, dropout_rate=0.0, dropout_seed=None, dropout_offsets=(0, 0)):
        return cross_attention.flash_cross_attention_plain(q, k, v, key_padding_mask, dropout_rate, dropout_seed,
                                                           dropout_offsets=dropout_offsets)

    swaps = [
        (layers, "flash_cross_attention", flash_plain),
        (layers, "conv3x3_bn_relu", conv3x3.conv3x3_bn_relu_plain),
        (layers, "conv_int8_bn_act_tiled", conv_int8.conv_int8_bn_act_tiled_plain),
        (resnet, "modulated_deform_conv", dcn.modulated_deform_conv_plain),
    ]
    kept = [getattr(mod, attr) for mod, attr, _ in swaps]
    try:
        for mod, attr, plain in swaps:
            setattr(mod, attr, plain)
        yield
    finally:
        for (mod, attr, _), fn in zip(swaps, kept):
            setattr(mod, attr, fn)


def mfu_fields(flops_per_item: Optional[float], items_per_s: float, device=None) -> dict:
    """JSON-ready {model_gflops, achieved_tflops, mfu_pct} (empty if unknown;
    no mfu_pct where the peak is unknown)."""
    if not flops_per_item:
        return {}
    achieved = flops_per_item * items_per_s / 1e12
    out = {
        "model_gflops": round(flops_per_item / 1e9, 1),
        "achieved_tflops": round(achieved, 2),
    }
    peak = device_peak_tflops(device)
    if peak:
        out["mfu_pct"] = round(100.0 * achieved / peak, 1)
    return out
