"""Host time of the flash cross-attention calls on the card, piece by piece,
and of the flagship's B=1 forward, which is bound by the host.

    python -m petr_tpu_torch.tools.attention_host_cost [--iters 200] [--rounds 7] [--forwards 40]

Prints one JSON object: microseconds of host time per call for each piece,
the median of ``rounds`` rounds (the pieces alternate within a round), and
milliseconds per forward. A piece's host time is the wall time of ``iters``
calls issued back to back, over ``iters``: at the flagship's attention shape
(B=1, 8 heads, 900 queries, 6,000 keys, head dim 32, bf16) a K1 call takes
about 0.05 ms of device time, less than the host takes to issue it, so the
card keeps up and the loop's time is the host's. ``device_us`` gives the
CUDA events around the same loop: where it exceeds the host's time the
card bounded that piece. The pieces:

- ``forward``: ``flash_cross_attention`` under inference mode, the call the
  decoder makes (the autograd Function, the ``torch.library`` op, the
  wrapper, the C launch); ``forward_dropout`` at dropout 0.1;
- ``forward_backward``: the Function's forward and backward at dropout 0.1
  (K1, then delta and K2's two kernels), as a train step runs it;
- ``wrapper``: ``_forward_cuda`` alone; ``wrapper_one_split`` with the keys
  unsplit (no workspace, no merge kernel);
- ``c_launch``: the C entry point alone on prepared arguments (the tensor
  maps and the launches); ``c_launch_one_split`` unsplit;
- ``workspace``: the ``torch.empty`` of the split forward's workspace;
- ``backward_wrapper``: ``_backward_cuda`` alone (both K2 kernels).

A piece that the imported tree's wrapper does not have is left out, so that
the same file measures any tree of the port given on ``PYTHONPATH``.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import math
import statistics
import subprocess
import time
from typing import Callable, Dict

import torch

B, H, Q, L, D = 1, 8, 900, 6000, 32
FLAGSHIP = "petr_vov_p4_800x320"


def _host_us(fn: Callable[[], object], iters: int) -> Dict[str, float]:
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return {"host_us": host * 1e6 / iters, "device_us": start.elapsed_time(end) * 1e3 / iters}


def attention_pieces(ca) -> Dict[str, Callable[[], object]]:
    g = torch.Generator(device="cuda").manual_seed(0)

    def view(n):  # (B, H, n, D) views of (B, n, H, D) buffers, as the projections give them
        return torch.randn(B, n, H, D, device="cuda", generator=g).bfloat16().transpose(1, 2)

    q, k, v, gout = view(Q), view(L), view(L), view(Q)
    mask = torch.zeros(B, L, dtype=torch.bool, device="cuda")
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out, lse = ca._forward_cuda(q, k, v, mask, 0.0, None)
    delta = ca._delta(gout, out, None)

    def forward():
        with torch.inference_mode():
            return ca.flash_cross_attention(q, k, v, mask)

    def forward_dropout():
        with torch.inference_mode():
            return ca.flash_cross_attention(q, k, v, mask, 0.1, 7)

    def forward_backward():
        o, _ = ca.flash_cross_attention(qg, kg, vg, mask, 0.1, 7)
        return torch.autograd.grad(o, (qg, kg, vg), gout)

    pieces = {
        "forward": forward,
        "forward_dropout": forward_dropout,
        "forward_backward": forward_backward,
        "wrapper": lambda: ca._forward_cuda(q, k, v, mask, 0.0, None),
        "backward_wrapper": lambda: ca._backward_cuda(q, k, v, mask, gout, lse, delta, 0.0, None),
    }
    split = "splits" in inspect.signature(ca._forward_cuda).parameters
    lib = ca._forward_library()
    o = torch.empty((B, Q, H, D), dtype=q.dtype, device="cuda").transpose(1, 2)
    ls = torch.empty((B, H, Q), dtype=torch.float32, device="cuda")
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    stream = torch.cuda.current_stream().cuda_stream
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), o.data_ptr(), ls.data_ptr(),
            B, H, Q, L, D, 1, strides, 1.0 / math.sqrt(D), *ca._dropout_args(0.0, None))
    if split:
        n = ca.forward_splits(B * H, Q, L, torch.cuda.get_device_properties(0).multi_processor_count)
        size = n * B * H * Q * (D + 4)
        ws = torch.empty(size, dtype=torch.float32, device="cuda")
        pieces["wrapper_one_split"] = lambda: ca._forward_cuda(q, k, v, mask, 0.0, None, splits=1)
        pieces["c_launch"] = lambda: lib.petr_flash_cross_attention_fwd(*head, n, ws.data_ptr(), stream)
        pieces["c_launch_one_split"] = lambda: lib.petr_flash_cross_attention_fwd(*head, 1, None, stream)
        pieces["workspace"] = lambda: torch.empty(size, dtype=torch.float32, device="cuda")
    else:  # the mma.sync kernels' interface: the query warps of attention_plan
        warps = ca.attention_plan(B * H, Q, torch.cuda.get_device_properties(0).multi_processor_count)
        pieces["c_launch"] = lambda: lib.petr_flash_cross_attention_fwd(*head, warps, stream)
    for fn in pieces.values():  # builds the libraries, warms the allocator
        fn()
    return pieces


def flagship_forward_ms(n: int) -> Dict[str, float]:
    """Host wall time of the flagship's B=1 forward (6 views of 320x800,
    random weights), synchronised after each, and the same on CUDA events."""
    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.serve import build_detector

    cfg = get_config(FLAGSHIP)
    model = build_detector(cfg, seed=0, device="cuda")
    N = cfg.data.num_views
    Hh, Ww = cfg.data.image_size
    g = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn(1, N, Hh, Ww, 3, device="cuda", generator=g)
    img2lidar = torch.eye(4, device="cuda").expand(1, N, 4, 4).contiguous()
    img_hw = torch.tensor([[Hh, Ww]] * N, dtype=torch.float32, device="cuda")[None]
    host, events = [], []
    with torch.inference_mode():
        for i in range(5 + n):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            model(images, img2lidar, img_hw)
            end.record()
            end.synchronize()
            if i >= 5:
                host.append((time.perf_counter() - t0) * 1e3)
                events.append(start.elapsed_time(end))
    return {"host_ms": statistics.median(host), "events_ms": statistics.median(events),
            "host_ms_quartiles": statistics.quantiles(host, n=4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--forwards", type=int, default=40)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attention_host_cost runs on the card")
    from petr_tpu_torch.ops import cross_attention as ca

    pieces = attention_pieces(ca)
    runs: Dict[str, list] = {name: [] for name in pieces}
    for _ in range(args.rounds):
        for name, fn in pieces.items():
            runs[name].append(_host_us(fn, args.iters))
    result = {
        "label": args.label,
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True).stdout.strip().splitlines()[0],
        "torch": torch.__version__,
        "shape": {"B": B, "H": H, "Q": Q, "L": L, "D": D},
        "pieces_us": {name: {"host_us": statistics.median(r["host_us"] for r in rs),
                             "device_us": statistics.median(r["device_us"] for r in rs)}
                      for name, rs in runs.items()},
    }
    if args.forwards:
        result["flagship_forward"] = flagship_forward_ms(args.forwards)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
