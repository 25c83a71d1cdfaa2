"""The yardstick's arithmetic: peaks, kernels' operations and bytes, model FLOPs.

Frozen copies: the peak table of ``petr_tpu_torch/utils/mfu.py`` (bf16
tensor-core peak by card name) and the constants and formulas of
``chip_smoke.py`` (``bound_ms``, ``roofline``, K1's and K2's bytes and
products per (query, key) pair, K4's products and bytes), as of the
benchmark's first version. The DCN backward's is the benchmark's own.
Model FLOPs are counted on the plain reference at the cell's shapes, on the
meta device: 2 per multiply-add of every conv, matmul and attention product
of one forward (``torch.utils.flop_counter``), whatever implements them in
the program.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

# (lower-case substring of the card's name, bf16 dense TFLOP/s), first match wins
PEAK_TFLOPS = (("h100 pcie", 756.0), ("h100 sxm", 989.0), ("h100 80gb hbm3", 989.0))
PEAK_HBM_BYTES = 3.35e12  # H100 SXM
SM_COUNT = 132
SM_CLOCK_HZ = 1.98e9  # H100 SXM's highest SM clock
SFU_EXP_PER_SM_CLOCK = 16


def peak_flops(card_name: str) -> Optional[float]:
    kind = card_name.lower()
    for key, tflops in PEAK_TFLOPS:
        if key in kind:
            return tflops * 1e12
    return None


def bound_s(flops: float, nbytes: float, peak: float, exps: float = 0.0) -> Tuple[float, str]:
    """The least time of a kernel: its products over the tensor-core peak,
    its exponentials over the SFUs, its bytes (each input read once, each
    output written once) over HBM, the largest; and which one binds."""
    parts = {"operations": flops / peak, "exponentials": exps / (SM_COUNT * SFU_EXP_PER_SM_CLOCK * SM_CLOCK_HZ),
             "bytes": nbytes / PEAK_HBM_BYTES}
    by = max(parts, key=parts.get)
    return parts[by], by


def attention_forward(B, H, Q, L, D, peak, e=2):
    """K1 (forward): 4 D products per pair, one exp per pair; q, k, v, the
    mask read, out and lse written."""
    pairs = B * H * Q * L
    return bound_s(4.0 * D * pairs, e * B * H * D * (2 * Q + 2 * L) + 4 * B * H * Q + B * L, peak, pairs)


def attention_backward(B, H, Q, L, D, peak, e=2):
    """K2 (dK/dV and dQ together): 10 D products per pair, one exp per pair."""
    pairs = B * H * Q * L
    return bound_s(10.0 * D * pairs, e * B * H * D * (3 * Q + 4 * L) + 8 * B * H * Q + B * L, peak, pairs)


def dcn_forward(B, Cin, H, W, Cout, peak, e=2):
    """K4: 2 B P Cout 9 Cin products; x, the fp32 offsets and masks, the
    fp32 weight read, the output written."""
    P = H * W
    return bound_s(2.0 * B * P * Cout * 9 * Cin, e * B * Cin * P + 4 * B * 27 * P + 4 * Cout * Cin * 9 + e * B * Cout * P,
                   peak)


def dcn_backward(B, Cin, H, W, Cout, peak, e=2):
    """The deformable conv's backward: the samples' and the weight's
    gradients, each a product as large as the forward's; x, the offsets
    and masks, the weight and the output's gradient read, their gradients
    written."""
    P = H * W
    nbytes = 2 * e * B * Cin * P + 2 * 4 * B * 27 * P + 2 * 4 * Cout * Cin * 9 + e * B * Cout * P
    return bound_s(4.0 * B * P * Cout * 9 * Cin, nbytes, peak)


def dcn_shapes(spec: Dict, images: int, hw: Tuple[int, int]):
    """(count, (B, Cin, H, W, Cout)) of the deformable convs of a ResNet
    configuration: caffe-style bottlenecks, the stride on conv1, so each DCN
    runs at its stage's output resolution."""
    bb = spec["backbone"]
    if bb["kind"] != "resnet":
        return []
    blocks = {"r50": (3, 4, 6, 3), "r101": (3, 4, 23, 3)}[bb["spec"]]
    H, W = hw
    out = []
    for stage in bb["dcn_stages"]:
        stride = 4 * 2 ** stage
        mid = 64 * 2 ** stage
        out.append((blocks[stage], (images, mid, -(-H // stride), -(-W // stride), mid)))
    return out


def forward_flops(spec: Dict, batch: int, views: int, hw: Tuple[int, int]) -> float:
    """Model FLOPs of one forward of ``batch`` samples, counted on the plain
    reference on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from h100_bench.reference.model import Detector

    with torch.device("meta"):
        model = Detector(spec).eval()
        H, W = hw
        args = (torch.empty(batch, views, H, W, 3), torch.empty(batch, views, 4, 4),
                torch.full((batch, views, 2), 1.0))
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            model(*args)
    return float(counter.get_total_flops())
