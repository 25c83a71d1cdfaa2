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
   function, and the least time the card could take (``bound_ms``): K1
   without and with dropout, K2 (its dK/dV and dQ kernels) at dropout 0 and
   0.1 in fp32 and bf16, and K3's lse cotangent through the autograd
   Function. A fully masked batch row must give exact zeros.
4. serving: the flagship ``petr_vov_p4_800x320`` at full width with random
   weights drawn from a seed, in bf16, answering requests through
   ``InferenceServer`` (batch 2, one batch partial and padded). Launch
   counts are set to 0 just before and read just after; outputs are checked
   for shape and finiteness, against direct serving calls, and against the
   same model with each kernel's call routed to its plain version. Then the
   B=1 latency, and one ``torch.profiler`` pass for the device time per
   forward, the device-busy share and each kernel's share.
5. training: the flagship's train step at full width in bf16 (random
   weights from a seed, dropout 0.1, GridMask on, remat as configured,
   batch 1) on synthetic batches drawn from a seed: 2 warm-up steps, then
   timed steps with K1 launched 12 times (6 forward, 6 in the decoder's
   recompute) and each K2 kernel 6 times per step; finite loss and
   gradients, no skipped step, backbone and head parameters moved and BN
   statistics not. Then one fp32 step's loss, assignment and every gradient
   against the same step with the attention routed to its plain versions,
   and against the same step without remat. The step time, peak memory, one
   ``torch.profiler`` pass and the matcher's host time are printed.

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
DROPOUT = 0.1
DROP_SEED = -123456  # a negative int32 seed: its bits as uint32
# K2 against its plain version, each gradient elementwise within
# atol * max|ref| + rtol * |ref|. fp32: both sum in fp32, in other orders.
# bf16: both round their fp32 sums to bf16 once (one step is 2^-8 relative).
BWD_TOL = {"fp32": (1e-5, 1e-4), "bf16": (4e-3, 1.6e-2)}
# the fp32 train step with the kernels against the same step on the plain
# versions, and with remat against without: loss relative error, and each
# parameter's gradient max abs error over that gradient's max |value|, or
# over FLOOR x the largest gradient entry of the model when that is more:
# the last biases of the PE MLPs shift every key of a query alike, which
# the softmax ignores, so their exact gradient is 0 and what both runs give
# is cancellation noise
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_GRAD_FLOOR = 1e-4, 1e-3, 1e-3


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


def bound_ms(pairs, flops_per_pair, nbytes, sm_count, sm_clock_hz):
    """Least time for an attention kernel: the larger of its products over the
    bf16 tensor-core peak, its exponentials (one per pair) over the SFU rate,
    and its bytes (each input read once, each output written once) over HBM
    bandwidth. ``pairs`` counts the (query, unmasked key) pairs of the inputs."""
    t_flops = flops_per_pair * pairs / PEAK_BF16_FLOPS
    t_exp = pairs / (sm_count * SFU_EXP_PER_SM_CLOCK * sm_clock_hz)
    t_bytes = nbytes / PEAK_HBM_BYTES
    bound = max(t_flops, t_exp, t_bytes)
    return bound * 1e3, ("bytes" if bound == t_bytes else "operations"), {
        "tensor_core_ms": t_flops * 1e3, "exp_ms": t_exp * 1e3, "bytes_ms": t_bytes * 1e3,
    }


def attention_inputs(torch, gen, batch, dtype, H=8, Q=900, L=6000, D=32):
    """q/k/v at the flagship decoder shape, as the (B, H, ., D) transposes of
    (B, ., H, D) projections, exactly as MultiheadAttention hands them over,
    and a key mask with a padded tail and padding inside."""
    q = torch.randn(batch, Q, H, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    k = torch.randn(batch, L, H, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    v = torch.randn(batch, L, H, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)
    mask = torch.zeros(batch, L, dtype=torch.bool, device="cuda")
    mask[:, L - 700:] = True
    mask[:, 1000:1200] = True
    return q, k, v, mask


def check_flash_attention(torch, ca, sm_clock_hz, card):
    """K1, without and with dropout, against its plain version at the
    flagship decoder shape, then timed."""
    import torch.nn.functional as F

    B, H, Q, L, D = 1, 8, 900, 6000, 32
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(batch, dtype):
        return attention_inputs(torch, gen, batch, dtype, H, Q, L, D)

    def compare(name, q, k, v, mask, out_atol, out_rtol, masked_rows=(), rate=0.0):
        seed = DROP_SEED if rate > 0 else None
        out, lse = ca.flash_cross_attention(q, k, v, mask, rate, seed)
        torch.cuda.synchronize()
        ref_out, ref_lse = ca.flash_cross_attention_reference(q, k, v, mask, rate, seed)
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

    log(f"phase 3: K1 with dropout {DROPOUT} (seed {DROP_SEED}) against its plain version")
    kept = ca.dropout_keep_mask(DROP_SEED, 2, H, Q, L, DROPOUT, "cuda").float().mean().item()
    log(f"  kept fraction of the hashed mask over 2 x {H} x {Q} x {L}: {kept:.5f} (1 - rate = {1 - DROPOUT})")
    assert abs(kept - (1 - DROPOUT)) <= 0.01, kept
    compare("fp32, dropout", q32, k32, v32, m32, 1e-4, 0.0, rate=DROPOUT)
    drop_err = compare("bf16, dropout", q16, k16, v16, m16, 2e-3, 1e-2, rate=DROPOUT)
    compare("bf16, dropout, batch row 1 fully masked", qm, km, vm, mm, 2e-3, 1e-2, (1,), DROPOUT)
    compare("fp32, dropout, batch row 1 fully masked", qmf, kmf, vmf, mmf, 1e-4, 0.0, (1,), DROPOUT)

    kernel_ms = cuda_time_ms(lambda: ca.flash_cross_attention(q16, k16, v16, m16))
    plain_ms = cuda_time_ms(lambda: ca.flash_cross_attention_reference(q16, k16, v16, m16))
    keep = ~m16[:, None, None, :]  # SDPA's boolean mask: True = attend
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q16, k16, v16, attn_mask=keep)
    )
    drop_ms = cuda_time_ms(lambda: ca.flash_cross_attention(q16, k16, v16, m16, DROPOUT, DROP_SEED))
    drop_plain_ms = cuda_time_ms(
        lambda: ca.flash_cross_attention_reference(q16, k16, v16, m16, DROPOUT, DROP_SEED))
    kernel_ms32 = cuda_time_ms(lambda: ca.flash_cross_attention(q32, k32, v32, m32))
    L_valid = int((~m16).sum())
    pairs = H * Q * L_valid
    nbytes = 2 * B * H * D * (2 * Q + 2 * L) + 4 * B * H * Q + B * L  # q, k, v, mask; out, lse
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bms, bound_by, parts = bound_ms(pairs, 4.0 * D, nbytes, sms, sm_clock_hz)
    log(f"  timing bf16 B={B} H={H} Q={Q} L={L} ({L_valid} unmasked) D={D}: "
        f"kernel_ms {kernel_ms:.4f}, plain_ms {plain_ms:.4f}, library_ms (SDPA) {library_ms:.4f}, "
        f"bound_ms {bms:.4f} ({bound_by}; {json.dumps({k: round(v, 5) for k, v in parts.items()})}) [{card}]")
    log(f"  timing bf16 with dropout {DROPOUT}: kernel_ms {drop_ms:.4f}, plain_ms {drop_plain_ms:.4f} [{card}]")
    log(f"  timing fp32: kernel_ms {kernel_ms32:.4f} [{card}]")
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
        "bound_ms": bms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "dropout_kernel_ms": drop_ms,
        "dropout_plain_ms": drop_plain_ms,
        "dropout_max_abs_err": drop_err,
    }


def check_flash_backward(torch, ca, sm_clock_hz, card):
    """K2 (its dK/dV and dQ kernels) against the plain backward at the
    flagship decoder shape, K3's lse cotangent through the autograd
    Function, then each kernel timed."""
    import torch.nn.functional as F

    B, H, Q, L, D = 1, 8, 900, 6000, 32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def cotangent(batch, dtype):
        return torch.randn(batch, Q, H, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)

    def check_grads(name, tag, got, want, masked_row):
        worst = {}
        for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
            g, w = g.float(), w.float()
            atol, rtol = BWD_TOL[tag]
            scale = w.abs().max().item()
            err = (g - w).abs()
            bad = err > atol * scale + rtol * w.abs()
            log(f"  {name} {g_name}: max abs err {err.max().item():.3e} (max |ref| {scale:.3e}; "
                f"atol {atol} x max|ref|, rtol {rtol})")
            assert not bad.any(), f"{name} {g_name}: {int(bad.sum())} gradients out of tolerance"
            if masked_row:
                assert (g[-1] == 0).all(), f"{name} {g_name}: the fully masked batch row is not zero"
            worst[g_name] = err.max().item()
        return worst

    log(f"phase 3: K2 (flash_cross_attention backward) against its plain version")
    errs = {}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for rate in (0.0, DROPOUT):
            for batch in (1, 2):
                q, k, v, m = attention_inputs(torch, gen, batch, dtype, H, Q, L, D)
                if batch == 2:
                    m[1] = True  # batch row 1 is all padding
                gout = cotangent(batch, dtype)
                out, lse = ca.flash_cross_attention_reference(q, k, v, m, rate, DROP_SEED)
                delta = ca._delta(gout, out, None)
                got = ca._backward_cuda(q, k, v, m, gout, lse, delta, rate, DROP_SEED)
                torch.cuda.synchronize()
                want = ca.flash_cross_attention_backward_reference(q, k, v, m, out, lse, gout, None, rate, DROP_SEED)
                name = f"{tag}, rate {rate}" + (", batch row 1 fully masked" if batch == 2 else "")
                errs[(tag, rate, batch)] = check_grads(name, tag, got, want, batch == 2)

    log("phase 3: K3 (lse differentiable) through the autograd Function against its plain route")
    q, k, v, m = attention_inputs(torch, gen, 2, torch.float32, H, Q, L, D)
    m[1] = True
    gout = cotangent(2, torch.float32)
    glse = torch.randn(2, H, Q, generator=gen, device="cuda")
    results = []
    for fn in (ca.flash_cross_attention_with_lse,
               lambda *a: ca.flash_cross_attention_plain(*a, lse_grad=True)):
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        out, lse = fn(qs, ks, vs, m, DROPOUT, DROP_SEED)
        loss = (out * gout).sum() + (torch.where(lse < 1e29, lse, 0.0) * glse).sum()
        results.append(torch.autograd.grad(loss, (qs, ks, vs)))
    check_grads("K3 fp32, rate 0.1, lse cotangent", "fp32", results[0], results[1], True)

    # timing at the train path's bf16 inputs, with and without dropout
    q, k, v, m = attention_inputs(torch, gen, B, torch.bfloat16, H, Q, L, D)
    gout = cotangent(B, torch.bfloat16)
    out, lse = ca.flash_cross_attention(q, k, v, m, DROPOUT, DROP_SEED)
    delta = ca._delta(gout, out, None)
    args = (q, k, v, m, gout, lse, delta)
    times = {}
    for rate in (DROPOUT, 0.0):
        for which in ("dkdv", "dq"):
            times[(which, rate)] = cuda_time_ms(
                lambda: ca._backward_cuda(*args, rate, DROP_SEED, kernels=(which,)))
    plain_ms = cuda_time_ms(lambda: ca.flash_cross_attention_backward_reference(
        q, k, v, m, out, lse, gout, None, DROPOUT, DROP_SEED))
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=~m[:, None, None, :])
    library_ms = cuda_time_ms(lambda: torch.autograd.grad(sdpa, (qs, ks, vs), gout, retain_graph=True))
    pairs = H * Q * int((~m).sum())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    e, f = 2, 8 * B * H * Q + B * L  # bf16 elements; lse, delta and mask bytes
    bounds = {
        "dkdv": bound_ms(pairs, 8.0 * D, e * B * H * D * (2 * Q + 4 * L) + f, sms, sm_clock_hz),
        "dq": bound_ms(pairs, 6.0 * D, e * B * H * D * (3 * Q + 2 * L) + f, sms, sm_clock_hz),
        "both": bound_ms(pairs, 10.0 * D, e * B * H * D * (3 * Q + 4 * L) + f, sms, sm_clock_hz),
    }
    for which in ("dkdv", "dq", "both"):
        b_ms, b_by, parts = bounds[which]
        log(f"  bound_ms {which} {b_ms:.4f} ({b_by}; {json.dumps({k: round(v, 5) for k, v in parts.items()})})")
    log(f"  timing bf16 B={B} H={H} Q={Q} L={L} ({pairs // (H * Q)} unmasked) D={D}, dropout {DROPOUT}: "
        f"dK/dV kernel_ms {times[('dkdv', DROPOUT)]:.4f}, dQ kernel_ms {times[('dq', DROPOUT)]:.4f}, "
        f"plain backward {plain_ms:.4f}; at rate 0: dK/dV {times[('dkdv', 0.0)]:.4f}, "
        f"dQ {times[('dq', 0.0)]:.4f}, library_ms (SDPA backward, boolean mask) {library_ms:.4f} [{card}]")
    records = []
    for which, name in (("dkdv", "flash_cross_attention_bwd_dkdv"), ("dq", "flash_cross_attention_bwd_dq")):
        b_ms, b_by, _ = bounds[which]
        records.append({
            "name": name,
            "route": "cuda",
            "source": "petr_tpu_torch/csrc/flash_cross_attention_bwd.cu",
            "replaces": "petr_tpu/ops/pallas/cross_attention.py:198::_bwd_kernel",
            "launches": None,  # filled from the train path's run
            "max_abs_err": max(errs[("bf16", DROPOUT, 1)][g] for g in (("dk", "dv") if which == "dkdv" else ("dq",))),
            "ms": times[(which, DROPOUT)],
            "kernel_ms": times[(which, DROPOUT)],
            "rate0_kernel_ms": times[(which, 0.0)],
            "plain_ms": plain_ms,  # the whole plain backward (dq, dk and dv)
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": library_ms,  # SDPA's whole backward at rate 0
        })
    return records


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
    profile(torch, lambda: model(*one_t), card)
    return launches


KERNEL_NAMES = {"K1": "flash_fwd_kernel", "K2 dK/dV": "flash_bwd_dkdv_kernel", "K2 dQ": "flash_bwd_dq_kernel"}


def profile(torch, fn, card, iters=5, unit="forward", inference=True):
    """Device time per call of ``fn`` by kernel, from one torch.profiler pass."""
    import contextlib

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    mode = torch.inference_mode() if inference else contextlib.nullcontext()
    with mode, torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        ((e.self_device_time_total / 1e3 / iters, e.count // iters, e.key)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
         # a record_function range on the device (AdamW's) is not a kernel
         and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")),
        reverse=True,
    )
    dev_ms = sum(r[0] for r in rows)
    assert dev_ms > 0, "the profiler saw no device time"
    shares = []
    for label, kname in KERNEL_NAMES.items():
        k_ms = sum(r[0] for r in rows if kname in r[2])
        if k_ms > 0:
            shares.append(f"{label} {k_ms:.3f} ms per {unit} ({100 * k_ms / dev_ms:.1f}% of device time)")
    log(f"  profile of {iters} B=1 {unit}s: device time {dev_ms:.3f} ms per {unit} in "
        f"{sum(r[1] for r in rows)} launches of {len(rows)} kernel names; device busy "
        f"{100 * dev_ms * iters / wall_ms:.1f}% of the traced window ({wall_ms / iters:.3f} ms "
        f"per {unit} under the profiler); {'; '.join(shares)} [{card}]")
    log(f"    ms/{unit}  calls/{unit}  kernel")
    for ms, calls, name in rows[:12]:
        log(f"    {ms:7.3f}  {calls:9d}  {name[:100]}")
    return dev_ms


def make_train_batch(cfg, seed, valid_gt=40):
    """One synthetic batch of one sample, drawn from ``seed`` with numpy: 6
    normalised views, ``make_cams`` cameras, ``max_gt`` GT rows of which
    ``valid_gt`` are real: centres inside pc_range, positive sizes, any yaw,
    small velocities, labels in [0, num_classes)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    N, (H, W), G = cfg.data.num_views, cfg.data.image_size, cfg.data.max_gt
    pc = cfg.model.head.pc_range
    valid = np.zeros(G, bool)
    valid[rng.permutation(G)[:valid_gt]] = True
    boxes = np.concatenate([
        rng.uniform(pc[0], pc[3], (G, 1)), rng.uniform(pc[1], pc[4], (G, 1)),
        rng.uniform(pc[2], pc[5], (G, 1)), rng.uniform(0.5, 5.0, (G, 3)),
        rng.uniform(-np.pi, np.pi, (G, 1)), rng.uniform(-1.0, 1.0, (G, 2)),
    ], -1).astype(np.float32)
    boxes[~valid] = 0.0  # padding rows
    labels = np.where(valid, rng.randint(0, cfg.model.head.num_classes, G), 0)
    return {
        "images": rng.randn(1, N, H, W, 3).astype(np.float32),
        "img2lidar": make_cams(1, N),
        "img_hw": np.tile(np.array([H, W], np.float32), (1, N, 1)),
        "gt_boxes": boxes[None],
        "gt_labels": labels[None].astype(np.int64),
        "gt_valid": valid[None],
    }


def compare_steps(torch, name, a, b, loss_rtol, grad_rtol):
    """Two grad_fn results (total, losses, grads, assignment): the assignment
    equal, the loss and every gradient within the stated tolerances."""
    import numpy as np

    (ta, _, ga, ia), (tb, _, gb, ib) = a, b
    assert np.array_equal(ia, ib), f"{name}: the assignments differ at {int((ia != ib).sum())} of {ia.size} GTs"
    loss_err = abs(ta.item() - tb.item()) / abs(tb.item())
    top = max(g.abs().max().item() for g in gb.values())
    rel, raw = {}, {}
    for n in gb:
        own = gb[n].abs().max().item()
        err = (ga[n] - gb[n]).abs().max().item()
        rel[n] = err / max(own, STEP_GRAD_FLOOR * top)
        raw[n] = (err, own)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    log(f"  {name}: assignments equal ({ia.size} GT rows over layers), loss {ta.item():.6f} vs "
        f"{tb.item():.6f} (relative error {loss_err:.2e}, tol {loss_rtol}); gradients of {len(rel)} "
        f"parameters (largest entry {top:.3e}), worst max abs err / max(max |grad|, "
        f"{STEP_GRAD_FLOOR} x largest): "
        + ", ".join(f"{n} {r:.2e} (err {raw[n][0]:.2e}, max |grad| {raw[n][1]:.2e})" for n, r in worst)
        + f" (tol {grad_rtol})")
    assert loss_err <= loss_rtol, f"{name}: loss differs by {loss_err:.3e}"
    assert worst[0][1] <= grad_rtol, f"{name}: gradient {worst[0][0]} differs by {worst[0][1]:.3e}"


def check_training(torch, ca, card):
    import dataclasses

    import numpy as np

    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.models import draw_train_noise, layers
    from petr_tpu_torch.ops.matcher import match_layers
    from petr_tpu_torch.train import create_train_state, make_grad_fn, make_train_step
    from petr_tpu_torch.train.losses import match_cost, target_codes

    cfg = get_config(FLAGSHIP)
    mc = cfg.model
    assert mc.head.dropout_rate == DROPOUT and mc.use_grid_mask and mc.use_flash_attention
    B = cfg.train.optim.batch_size_per_device
    log(f"phase 5: {FLAGSHIP} training at full width, random weights (seed {SEED}), "
        f"{mc.compute_dtype}, batch {B}, dropout {mc.head.dropout_rate}, GridMask on, "
        f"remat {mc.remat} (scope {mc.remat_scope})")
    t0 = time.perf_counter()
    state = create_train_state(cfg, SEED, total_steps=1000, device="cuda")
    model = state.model
    batches = [{k: torch.as_tensor(v).cuda() for k, v in make_train_batch(cfg, SEED + i).items()}
               for i in range(4)]
    log(f"  train state and 4 synthetic batches in {time.perf_counter() - t0:.1f} s; "
        f"{int(batches[0]['gt_valid'].sum())} valid GT rows of {cfg.data.max_gt} in the first")
    step_fn = make_train_step(cfg)
    gen = torch.Generator().manual_seed(SEED)
    watched = ("img_backbone.stem.stem_1/conv.weight",
               "pts_bbox_head.transformer.decoder.layers.0.attentions.1.attn.in_proj_weight",
               "pts_bbox_head.cls_branches.0.6.bias")
    params = dict(model.named_parameters())
    before = {n: params[n].detach().clone() for n in watched}
    buffers = {n: b.clone() for n, b in model.named_buffers()}

    steps = [0]

    def one_step():
        _, metrics = step_fn(state, batches[steps[0] % len(batches)], gen)
        steps[0] += 1
        assert metrics["skipped"] == 0 and metrics["grad_nonfinite"] == 0, metrics
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"]), metrics
        return metrics

    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):  # warm up
        m = one_step()
    torch.cuda.synchronize()
    n_timed = 5
    ca.LAUNCHES = ca.DKDV_LAUNCHES = ca.DQ_LAUNCHES = 0
    times, host = [], []
    for _ in range(n_timed):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        m = one_step()
        end.record()
        end.synchronize()
        host.append(time.perf_counter() - h0)
        times.append(start.elapsed_time(end))
    launches = {"K1": ca.LAUNCHES, "K2 dK/dV": ca.DKDV_LAUNCHES, "K2 dQ": ca.DQ_LAUNCHES}
    L = mc.head.num_layers
    want = {"K1": 2 * L * n_timed, "K2 dK/dV": L * n_timed, "K2 dQ": L * n_timed}
    log(f"  {n_timed} timed steps: kernel launches {launches} (expected {want}: per step {L} "
        f"forward + {L} recompute for K1, {L} for each K2 kernel)")
    assert launches == want, (launches, want)
    log("  last step's metrics: " + ", ".join(f"{k} {float(v):.4f}" for k, v in m.items()))
    for n in watched:
        moved = (params[n].detach() - before[n]).abs().max().item()
        log(f"  {n}: max |change| {moved:.3e} over {steps[0]} steps")
        assert moved > 0, f"{n} did not move"
    for n, b in model.named_buffers():
        assert torch.equal(b, buffers[n]), f"buffer {n} moved"
    log(f"  every BN statistic ({len(buffers)} buffers) unchanged")
    med = statistics.median(times)
    log(f"  train step at batch {B} (6 views {cfg.data.image_size[0]}x{cfg.data.image_size[1]}): median "
        f"{med:.2f} ms on CUDA events ({', '.join(f'{t:.2f}' for t in times)}), host clock median "
        f"{statistics.median(host) * 1e3:.2f} ms, {B * 1e3 / med:.3f} samples/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]")
    dev_ms = profile(torch, one_step, card, iters=2, unit="step", inference=False)
    log(f"  device busy without the profiler: {100 * dev_ms / med:.1f}% of the median step "
        f"({dev_ms:.3f} ms of device time in {med:.2f} ms) [{card}]")

    # the matcher: one copy of the stacked costs to the host, then the LAPs
    b0 = batches[0]
    with torch.no_grad():
        out = model(b0["images"], b0["img2lidar"], b0["img_hw"],
                    noise=draw_train_noise(mc, b0["images"].shape[2], gen))
        ocfg = cfg.train.optim
        cost = match_cost(out["cls_logits"], out["bbox_codes"], target_codes(b0["gt_boxes"], b0["gt_valid"]),
                          b0["gt_labels"], cls_weight=ocfg.cls_weight, bbox_weight=ocfg.bbox_weight)
        torch.cuda.synchronize()
        match_s = []
        for _ in range(5):
            h0 = time.perf_counter()
            match_layers(cost, b0["gt_valid"])
            match_s.append(time.perf_counter() - h0)
    log(f"  matcher on the host: {statistics.median(match_s) * 1e3:.3f} ms median of 5 per step "
        f"({tuple(cost.shape)} costs copied once, then {L} x {B} LAPs of "
        f"{int(b0['gt_valid'].sum())} x {cost.shape[2]})")

    log("phase 5: one fp32 step with the kernels against the plain versions, and remat against none")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(mc, compute_dtype="float32"))
    grad_fn = make_grad_fn(cfg32)
    model32 = create_train_state(cfg32, SEED, 1000, device="cuda").model

    def grads_of(model_, plain=False):
        if plain:
            layers.flash_cross_attention = ca.flash_cross_attention_plain
        try:
            return grad_fn(model_, batches[1], torch.Generator().manual_seed(SEED + 7))
        finally:
            layers.flash_cross_attention = ca.flash_cross_attention

    ca.LAUNCHES = ca.DKDV_LAUNCHES = ca.DQ_LAUNCHES = 0
    with_kernels = grads_of(model32)
    assert (ca.LAUNCHES, ca.DKDV_LAUNCHES, ca.DQ_LAUNCHES) == (2 * L, L, L)
    plain = grads_of(model32, plain=True)
    assert (ca.LAUNCHES, ca.DKDV_LAUNCHES, ca.DQ_LAUNCHES) == (2 * L, L, L), "the plain route launched a kernel"
    compare_steps(torch, "kernels vs plain versions (remat on)", with_kernels, plain,
                  STEP_LOSS_RTOL, STEP_GRAD_RTOL)
    del plain, model32
    cfg_nr = dataclasses.replace(cfg32, model=dataclasses.replace(cfg32.model, remat=False))
    no_remat = grads_of(create_train_state(cfg_nr, SEED, 1000, device="cuda").model)
    compare_steps(torch, "remat on vs remat off (kernels)", with_kernels, no_remat,
                  STEP_LOSS_RTOL, STEP_GRAD_RTOL)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, False
    return launches


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
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    sources = ("flash_cross_attention", "flash_cross_attention_bwd")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        libs = list(pool.map(build.build, sources))
    log(f"  built {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        report = lib.with_name(lib.name + ".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    log("  ptxas:", line.strip())

    k1 = check_flash_attention(torch, ca, sm_clock_hz, card)
    k2 = check_flash_backward(torch, ca, sm_clock_hz, card)
    k1["launches"] = check_serving(torch, ca, card)
    train_launches = check_training(torch, ca, card)
    k1["launches_train"] = train_launches["K1"]
    k2[0]["launches"] = train_launches["K2 dK/dV"]
    k2[1]["launches"] = train_launches["K2 dQ"]

    log(card)
    log(json.dumps({"kernels": [k1, *k2]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
