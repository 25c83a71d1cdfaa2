#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (petr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout; imports no JAX and
nothing of petr_tpu. Phases, each fatal on failure:

1. device: the card's name and power limit, torch/CUDA versions; TF32 off
   so that fp32 comparisons are fp32.
2. build: every kernel of the main path from `petr_tpu_torch/csrc/`, one
   nvcc per source, all started together.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the flagship gives it, then timed with CUDA events beside the
   plain version, the one PyTorch library call that computes the same
   function, and the least time the card could take (``bound_ms``).
4. serving: the flagship ``petr_vov_p4_800x320`` at full width with random
   weights drawn from a seed, in bf16, answering requests through
   ``InferenceServer`` (batch 2, one batch partial and padded). Launch
   counts are set to 0 just before and read just after; outputs are checked
   for shape and finiteness, against direct serving calls, and against the
   same model with each kernel's call routed to its plain version. Then the
   B=1 latency, and one ``torch.profiler`` pass for the device time per
   forward, the device-busy share and each kernel's share.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a card it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor
# cores and HBM3. exp2 runs on the SFUs at 16 results per SM per clock
# (CUDA C Programming Guide, arithmetic throughput table, compute 9.0).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
SFU_EXP_PER_SM_CLOCK = 16

FLAGSHIP = "petr_vov_p4_800x320"
SEED = 0
# K1 against its plain version inside the full bf16 model. The two differ
# only in the rounding of the attention output to bf16, yet that flips
# outputs by one bf16 step (3.1e-2 at a logit of 4-8): the measured max abs
# error is 3.1e-2 on cls_logits and 6.6e-2 on bbox_codes (max |value| 51),
# the mean 1.6e-3 on both. The mean limit is the sharper check.
MODEL_ATOL, MODEL_RTOL, MODEL_MEAN = 5e-2, 1e-2, 5e-3


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup: int = 5, iters: int = 25) -> float:
    """Median over ``iters`` single calls, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound_ms(B, H, Q, L_valid, D, elem_bytes, L, sm_count, sm_clock_hz):
    """Least time for one attention call: the larger of its products over the
    bf16 tensor-core peak, its exponentials over the SFU rate, and its bytes
    (q, k, v, mask read once; out, lse written once) over HBM bandwidth.
    Work is counted over the unmasked keys of these inputs."""
    pairs = H * Q * sum(L_valid)  # (query, unmasked key) pairs over the batch
    t_flops = 4.0 * D * pairs / PEAK_BF16_FLOPS
    t_exp = pairs / (sm_count * SFU_EXP_PER_SM_CLOCK * sm_clock_hz)
    nbytes = elem_bytes * B * H * D * (2 * Q + 2 * L) + 4 * B * H * Q + B * L
    t_bytes = nbytes / PEAK_HBM_BYTES
    bound = max(t_flops, t_exp, t_bytes)
    return bound * 1e3, ("bytes" if bound == t_bytes else "operations"), {
        "tensor_core_ms": t_flops * 1e3, "exp_ms": t_exp * 1e3, "bytes_ms": t_bytes * 1e3,
    }


def check_flash_attention(torch, ca, sm_clock_hz):
    """K1 against its plain version at the flagship decoder shape, then timed."""
    import torch.nn.functional as F

    B, H, Q, L, D = 1, 8, 900, 6000, 32
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(batch, dtype):
        # q/k/v as the (B, H, ., D) transposes of (B, ., H, D) projections,
        # exactly as MultiheadAttention hands them over
        q = torch.randn(batch, Q, H, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)
        k = torch.randn(batch, L, H, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)
        v = torch.randn(batch, L, H, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)
        mask = torch.zeros(batch, L, dtype=torch.bool, device="cuda")
        mask[:, L - 700:] = True  # a padded tail
        mask[:, 1000:1200] = True  # and padding inside
        return q, k, v, mask

    def compare(name, q, k, v, mask, out_atol, out_rtol, masked_rows=()):
        out, lse = ca.flash_cross_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref_out, ref_lse = ca.flash_cross_attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        assert out.dtype == q.dtype and out.shape == q.shape and lse.shape == (q.shape[0], H, Q)
        o, r = out.float(), ref_out.float()
        err = (o - r).abs()
        bad = err > out_atol + out_rtol * r.abs()
        live = torch.ones(q.shape[0], dtype=torch.bool, device="cuda")
        live[list(masked_rows)] = False
        lse_err = (lse[live] - ref_lse[live]).abs().max().item()
        log(f"  {name}: out max abs err {err.max().item():.3e} "
            f"(atol {out_atol}, rtol {out_rtol}), lse max abs err {lse_err:.3e} (tol 1e-3)")
        assert not bad.any(), f"{name}: {int(bad.sum())} outputs out of tolerance"
        assert lse_err <= 1e-3, f"{name}: lse error {lse_err}"
        for b in masked_rows:
            assert (out[b] == 0).all(), f"{name}: fully masked row {b} has nonzero output"
            assert (lse[b] == 1e30).all(), f"{name}: fully masked row {b} lse is not +1e30"
        return err.max().item()

    log("phase 3: flash_cross_attention (K1) against its plain version")
    q32, k32, v32, m32 = inputs(B, torch.float32)
    compare("fp32", q32, k32, v32, m32, 1e-4, 0.0)
    # bf16: outputs are ~N(0, 0.023) here, one bf16 step of a value x is
    # up to x/128; the tolerance is a tenth of a typical output
    q16, k16, v16, m16 = inputs(B, torch.bfloat16)
    max_err = compare("bf16", q16, k16, v16, m16, 2e-3, 1e-2)
    qm, km, vm, mm = inputs(2, torch.bfloat16)
    mm[1] = True  # batch row 1 is all padding
    compare("bf16, batch row 1 fully masked", qm, km, vm, mm, 2e-3, 1e-2, masked_rows=(1,))
    qmf, kmf, vmf, mmf = inputs(2, torch.float32)
    mmf[1] = True
    compare("fp32, batch row 1 fully masked", qmf, kmf, vmf, mmf, 1e-4, 0.0, masked_rows=(1,))

    kernel_ms = cuda_time_ms(lambda: ca.flash_cross_attention(q16, k16, v16, m16))
    plain_ms = cuda_time_ms(lambda: ca.flash_cross_attention_reference(q16, k16, v16, m16))
    keep = ~m16[:, None, None, :]  # SDPA's boolean mask: True = attend
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q16, k16, v16, attn_mask=keep)
    )
    kernel_ms32 = cuda_time_ms(lambda: ca.flash_cross_attention(q32, k32, v32, m32))
    L_valid = [int((~m16[b]).sum()) for b in range(B)]
    bound_ms, bound_by, parts = attention_bound_ms(
        B, H, Q, L_valid, D, 2, L, torch.cuda.get_device_properties(0).multi_processor_count,
        sm_clock_hz,
    )
    log(f"  timing bf16 B={B} H={H} Q={Q} L={L} ({L_valid[0]} unmasked) D={D}: "
        f"kernel_ms {kernel_ms:.4f}, plain_ms {plain_ms:.4f}, library_ms (SDPA) {library_ms:.4f}, "
        f"bound_ms {bound_ms:.4f} ({bound_by}; {json.dumps({k: round(v, 5) for k, v in parts.items()})})")
    log(f"  timing fp32: kernel_ms {kernel_ms32:.4f}")
    return {
        "name": "flash_cross_attention_fwd",
        "route": "cuda",
        "source": "petr_tpu_torch/csrc/flash_cross_attention.cu",
        "replaces": "petr_tpu/ops/pallas/cross_attention.py:62::_kernel",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def make_cams(B, N):
    """img2lidar of N outward-facing pinhole cameras around the ego car."""
    import numpy as np

    mats = np.zeros((B, N, 4, 4))
    for b in range(B):
        for i in range(N):
            yaw = 2 * np.pi * i / N
            R = np.array([[-np.sin(yaw), np.cos(yaw), 0], [0, 0, -1], [np.cos(yaw), np.sin(yaw), 0]])
            E = np.eye(4)
            E[:3, :3] = R
            E[:3, 3] = -R @ np.array([np.cos(yaw), np.sin(yaw), 1.5])
            K = np.eye(4)
            K[0, 0] = K[1, 1] = 800.0
            K[0, 2], K[1, 2] = 400.0, 160.0
            mats[b, i] = K @ E
    return np.linalg.inv(mats).astype(np.float32)


def check_serving(torch, ca, card):
    import numpy as np

    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.models import layers
    from petr_tpu_torch.serve import InferenceServer, build_detector, make_serving_fn

    cfg = get_config(FLAGSHIP)
    log(f"phase 4: {FLAGSHIP} serving at full width, random weights (seed {SEED}), "
        f"{cfg.model.compute_dtype}")
    N = cfg.data.num_views
    H, W = cfg.data.image_size
    t0 = time.perf_counter()
    model = build_detector(cfg, seed=SEED, device="cuda")
    nparams = sum(p.numel() for p in model.parameters())
    log(f"  model built in {time.perf_counter() - t0:.1f} s: {nparams} parameters, "
        f"{cfg.model.head.num_layers} decoder layers, {cfg.model.backbone.spec}")
    fn = make_serving_fn(cfg, model, device="cuda")

    rng = np.random.RandomState(SEED)
    requests = []
    for r in range(3):
        img_hw = np.tile(np.array([H, W], np.float32), (N, 1))
        if r == 1:  # two views padded: their tokens are masked in the decoder
            img_hw[2] = [H - 32, W - 96]
            img_hw[4] = [H, W - 160]
        requests.append({
            "images": rng.randn(N, H, W, 3).astype(np.float32),
            "img2lidar": make_cams(1, N)[0],
            "img_hw": img_hw,
        })

    forwards = 0

    def counted(*args):
        nonlocal forwards
        forwards += 1
        return fn(*args)

    fn(*[np.stack([requests[0][k]] * 2) for k in ("images", "img2lidar", "img_hw")])  # warm up
    torch.cuda.synchronize()

    ca.LAUNCHES = 0
    t0 = time.perf_counter()
    with InferenceServer(counted, batch_size=2, max_delay_ms=50.0) as server:
        futures = [server.submit(req) for req in requests]
        results = [f.result(timeout=600) for f in futures]
    serve_s = time.perf_counter() - t0
    launches = ca.LAUNCHES
    num_layers = cfg.model.head.num_layers
    log(f"  {len(requests)} requests in {forwards} batches in {serve_s:.3f} s; "
        f"K1 launches {launches} (expected {num_layers} x {forwards} forwards)")
    assert launches == num_layers * forwards, (launches, forwards)
    assert forwards == 2, f"3 requests at batch 2 should take 2 batches, took {forwards}"

    for i, (req, res) in enumerate(zip(requests, results)):
        assert res["boxes"].shape == (cfg.max_det, 9) and res["scores"].shape == (cfg.max_det,), (
            {k: v.shape for k, v in res.items()})
        assert res["labels"].shape == (cfg.max_det,) and res["valid"].shape == (cfg.max_det,)
        for k in ("boxes", "scores"):
            assert np.isfinite(res[k]).all(), f"request {i}: non-finite {k}"
        # the same sample served directly, in a batch of the same size. The
        # batch-mate may flip the bf16 rounding of a few head outputs (one
        # bf16 step of a logit near -4 moves its score by ~3e-4; of a
        # center offset, the center by up to ~0.2 m), hence the tolerances.
        direct = fn(*[np.stack([req[k]] * 2) for k in ("images", "img2lidar", "img_hw")])
        np.testing.assert_allclose(res["scores"], direct["scores"][0], rtol=0, atol=2e-3)
        # ranks whose score is within 2e-3 of a neighbour may trade places
        s = direct["scores"][0]
        gap = np.ones_like(s, bool)
        gap[1:] &= (s[:-1] - s[1:]) > 2e-3
        gap[:-1] &= (s[:-1] - s[1:]) > 2e-3
        np.testing.assert_array_equal(res["labels"][gap], direct["labels"][0][gap])
        np.testing.assert_allclose(res["boxes"][gap], direct["boxes"][0][gap], rtol=0, atol=0.5)
    log(f"  every request: finite boxes {results[0]['boxes'].shape}, scores "
        f"{results[0]['scores'].shape}, equal to a direct serving call on the sample")

    # the same model and weights with K1's call routed to its plain version
    args = [torch.as_tensor(np.stack([requests[1][k]])).cuda() for k in ("images", "img2lidar", "img_hw")]
    with torch.inference_mode():
        out_k1 = model(*args)
        layers.flash_cross_attention = ca.flash_cross_attention_reference
        try:
            out_plain = model(*args)
        finally:
            layers.flash_cross_attention = ca.flash_cross_attention
    for key in ("cls_logits", "bbox_codes"):
        a, b = out_k1[key].float(), out_plain[key].float()
        assert a.shape == (num_layers, 1, cfg.model.head.num_query, b.shape[-1])
        assert torch.isfinite(a).all(), key
        err = (a - b).abs()
        tol = MODEL_ATOL + MODEL_RTOL * b.abs()
        log(f"  {key} with K1 vs its plain version (padded views): max abs err "
            f"{err.max().item():.4e}, mean {err.mean().item():.4e}, max |value| "
            f"{b.abs().max().item():.4e} (atol {MODEL_ATOL}, rtol {MODEL_RTOL}, mean {MODEL_MEAN})")
        assert (err <= tol).all(), f"{key}: K1 and its plain version disagree"
        assert err.mean().item() <= MODEL_MEAN, f"{key}: K1 and its plain version disagree on average"

    # B=1 latency of the serving step (forward + decode + host copy)
    one = [np.stack([requests[0][k]]) for k in ("images", "img2lidar", "img_hw")]
    for _ in range(3):
        fn(*one)
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        res1 = fn(*one)
        lat.append(time.perf_counter() - t0)
    med = statistics.median(lat)
    np.testing.assert_allclose(np.sort(res1["scores"][0]), np.sort(results[0]["scores"]), atol=1e-2)
    one_t = [torch.as_tensor(a).cuda() for a in one]
    with torch.inference_mode():
        fwd_ms = cuda_time_ms(lambda: model(*one_t), warmup=2, iters=10)
    log(f"  serving step at B=1 ({N} views {H}x{W}): median {med * 1e3:.2f} ms over "
        f"{len(lat)} runs (host clock), {1.0 / med:.2f} samples/s; forward alone "
        f"{fwd_ms:.2f} ms (CUDA events, median of 10) [{card}]")
    profile_forward(torch, lambda: model(*one_t), card)
    return launches


def profile_forward(torch, forward, card, iters=5):
    """Device time per forward by kernel, from one torch.profiler pass."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        ((e.self_device_time_total / 1e3 / iters, e.count // iters, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    dev_ms = sum(r[0] for r in rows)
    assert dev_ms > 0, "the profiler saw no device time"
    k1_ms = sum(r[0] for r in rows if "flash_fwd_kernel" in r[2])
    log(f"  profile of {iters} B=1 forwards: device time {dev_ms:.3f} ms per forward in "
        f"{sum(r[1] for r in rows)} launches of {len(rows)} kernel names; device busy "
        f"{100 * dev_ms * iters / wall_ms:.1f}% of the traced window ({wall_ms / iters:.3f} ms "
        f"per forward under the profiler); K1 {k1_ms:.3f} ms per forward "
        f"({100 * k1_ms / dev_ms:.1f}% of device time) [{card}]")
    log("    ms/fwd  calls/fwd  kernel")
    for ms, calls, name in rows[:12]:
        log(f"    {ms:7.3f}  {calls:9d}  {name[:100]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    try:
        from petr_tpu_torch.ops import build
        from petr_tpu_torch.ops import cross_attention as ca
    except ImportError as e:
        print(f"chip_smoke: the petr_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 1

    log("phase 1: device")
    card = nvidia_smi("name,power.limit")
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}")
    sm_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    log(f"  max SM clock {sm_clock_hz / 1e6:.0f} MHz")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 2: build")
    t0 = time.perf_counter()
    lib = build.build("flash_cross_attention")
    log(f"  built {lib.name} in {time.perf_counter() - t0:.1f} s")
    report = lib.with_name(lib.name + ".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas:", line.strip())

    record = check_flash_attention(torch, ca, sm_clock_hz)
    record["launches"] = check_serving(torch, ca, card)

    log(card)
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
