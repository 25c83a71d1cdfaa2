#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (petr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout; imports no JAX and
nothing of petr_tpu. Phases, each fatal on failure:

1. device: the card's name and power limit, torch/CUDA versions; TF32 off
   so that fp32 comparisons are fp32.
2. build: every kernel of the main paths from `petr_tpu_torch/csrc/`, one
   nvcc per source, all started together.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it, then timed beside the plain version, the
   PyTorch library call that computes the same function where there is
   one, and the least time the card could take (``bound_ms``). A record's
   ``ms``, ``plain_ms`` and ``library_ms`` are one call between CUDA
   events; its ``device_ms`` (and ``library_device_ms``) the kernels' own
   time from the profiler. Every kernel comes in two variants, bf16 on the
   tensor cores and fp32 on the CUDA cores, each launch counted on its
   variant's counter. K1 without and with dropout, at the flagship's L, the
   r50dcn decoder's L = 16,896 and PETRv2's L = 12,000 (also at batch 2,
   where the 64-row plan runs; a fully masked batch row must give exact
   zeros and lse 1e30): the bf16 variant against its rounding floor (the
   plain version rounding p to bf16 where the kernel does) under
   KERNEL_TOL, on inputs whose logits are exact in fp32, and against the
   unrounded plain version; timed beside SDPA; K2 (its dK/dV and dQ
   kernels) at dropout 0 and 0.1, the bf16 variant checked and
   timed also at L = 16,896 and 12,000, with the distance that rounding P and dS to
   bf16 alone puts between the plain backward and itself; K3's lse
   cotangent through the autograd Function
   (a fully masked batch row must give exact zeros); K4 (DCNv2) at both
   r50dcn stages in fp32 and bf16, a small odd shape at stride 2 and a
   Cout of 300 (the bf16 variant against its rounding floor, with samples
   and weight rounded to bf16, under KERNEL_TOL and against the unrounded
   plain version under OPERAND_TOL), and its gradients through its
   Function; K5 (the fused conv3x3): the bf16
   tensor-core kernel at each of the 10 shapes of the flagship's route,
   timed at each beside cuDNN and its bound and summed over a forward's 80
   launches, the fp32 CUDA-core kernel at stages 2 and 4, both with and
   without the BN/ReLU epilogue. Then K1 and K2 in fp32 and bf16 and the
   bf16 K4 at the synthetic recipes' shapes (phase 11), held and timed
   alike (records ``*_synth``).
4. serving: the flagship ``petr_vov_p4_800x320`` at full width with random
   weights drawn from a seed, in bf16, answering requests through
   ``InferenceServer`` (batch 2, one batch partial and padded). Launch
   counts are set to 0 just before and read just after; outputs are checked
   for shape and finiteness, against direct serving calls, and against the
   same model with each kernel's call routed to its plain version; the
   bf16 model launches only the bf16 variants, the fp32 twin below only the
   fp32 ones. Then the
   B=1 latency and one ``torch.profiler`` pass for the device time per
   forward, the device-busy share and each kernel's share. Then the same
   model with ``PETR_TPU_TORCH_CONV_IMPL=cuda``: the route's convs match
   the shapes phase 3 timed, K5's bf16 kernel launches 80 times per
   forward, its outputs are held to the cuDNN route's, the forward is
   profiled beside the cuDNN route's device time, and the two routes'
   forwards are timed in alternating pairs; then the fp32
   twin on the route (80 launches of the fp32 kernel) against the fp32
   cuDNN route.
5. training: the flagship's train step at full width in bf16 (random
   weights from a seed, dropout 0.1, GridMask on, remat as configured,
   batch 1) on synthetic batches drawn from a seed: 2 warm-up steps, then
   timed steps with K1 launched 12 times (6 forward, 6 in the decoder's
   recompute) and each bf16 K2 kernel 6 times per step (the fp32 variants
   never), K2's device time per step beside the CUDA-core kernels'; finite loss and
   gradients, no skipped step, backbone and head parameters moved and BN
   statistics not. Then one fp32 step's loss, assignment and every gradient
   against the same step with the attention routed to its plain versions
   (K2's fp32 variants, 6 launches each), and against the same step
   without remat. The step time, peak memory, one
   ``torch.profiler`` pass and the matcher's host time are printed.
6. r50dcn serving: ``petr_r50_p4_1408x512`` at full width (6 views of
   512x1408, ResNet-50 with DCNv2 in stages 3 and 4, CPFPN) in bf16, random
   weights from a seed with the offset convs redrawn, through
   ``InferenceServer`` as in phase 4: K4 launches 9 and K1 6 times per
   forward; outputs against direct calls and against K4's plain version;
   B=1 latency and one profiler pass. Then the no-neck preset
   ``petr_r50_c5_1408x512`` (the head on C5, L = 4,224 decoder keys),
   served the same way (3 requests, K4 9 and K1 6 per forward) and timed
   at B=1.
7. r50dcn training: its bf16 train step at batch 1 (dropout 0.1, GridMask,
   remat): K4 launches 18 times per step (9 in the bottlenecks' recompute),
   K1 12 and each K2 kernel 6; finite loss and gradients, DCN weights and
   offset convs moved, the backbone's frozen BN affine and every BN
   statistic not; step time, peak memory, one profiler pass. Two identical
   bf16 steps (same weights, batch and generator seed) must give the same
   loss, ``grad_norm`` and parameters bit for bit. Then one fp32
   step with K4 against the same step on its plain version, beside the
   plain step with its images nudged by one ulp.
8. PETRv2: ``petrv2_vov_p4_800x320`` at full width (2 frames of 6 views at
   320x800, FPE, with_time, RegLayer, one branch per decoder layer; L =
   12,000 decoder keys) in bf16, random weights from a seed. Serving: 3
   requests with timestamps through ``InferenceServer`` at batch 2 (one
   batch padded), K1 6 times per forward (bf16 only), outputs against
   direct calls and against K1's plain version (``MODEL_*``), the head's
   last stage recomputed from the decoder's output (each layer's own
   branches; velocities over the frames' mean step), B=1 latency and one
   profiler pass. Streaming: ``StreamingPETRv2`` primed, then 3 frames,
   each through the backbone on 6 views and held to the full 12-view
   forward under ROUTE_TOL. Training: 2 warm-up and 3 timed bf16 steps
   (dropout 0.1, GridMask over the 12 views, remat), K1 12 and each K2
   kernel 6 times per step; step time, peak memory, one profiler pass; one
   fp32 step with the kernels against the plain versions, beside the plain
   step with its images nudged by one ulp.
9. Depthr: ``depthr_r50_c5_512x1408_gtdepth`` at full width (6 views of
   512x1408, ResNet-50 with DCNv2 in stages 3 and 4, C5 only; a GT-depth
   encoder over 81-bin LID maps at stride 8; 6 Depthr layers over L =
   4,224 depth tokens, the attention on its plain branch) in bf16, random
   weights as phase 6. Batches whose GT boxes mostly straddle two cameras:
   the depth maps' covered share per view, above 0 in every view a box
   counts in, and equal on the card and the CPU bit for bit. Evaluation:
   ``make_eval_step`` on 3 batches, K4 9 times per forward (bf16 only, no
   K1); the rebinding: other images with the same cameras and boxes give
   the same outputs bit for bit; B=1 forwards on CUDA events and one
   profiler pass, with the backbone's share of the device time (its
   output reaches nothing); the bf16 outputs and decode against an fp32
   twin on the plain routes. Training: 2 warm-up and 3 timed bf16 steps
   (dropout 0.1, GridMask, remat, the BN affine frozen), K4 9 times per
   step (no gradient reaches the backbone, so its checkpointed bottlenecks
   are never recomputed); step time, peak memory, one profiler pass; two
   identical steps bit for bit; one fp32 step with K4 against the plain
   version, equal bit for bit.
10. evaluation: synthetic scenes rendered by the port at 900x1600 (4
   scenes of 3 frames, 2 held out: 6 val and 6 train samples, 96 JPEGs);
   one flagship bf16 train step on a train-split loader batch (training
   IDA, GridMask), a checkpoint, and step 2 from the restored state equal
   to the uninterrupted one bit for bit (loss, ``grad_norm``, weights,
   AdamW moments); the flagship scored from that checkpoint by
   ``evaluate_model`` (K1 6 times per batch, bf16 only), its outputs,
   decode and metrics held to K1's plain route, and by ``python -m
   petr_tpu_torch.cli.test`` in a process of its own (the same metric
   lines, a submission entry per val token, the same scores); the
   loader's host time per batch, the eval step on CUDA events, the share
   of an eval pass the card waits on the loader, samples/s; PETRv2
   streamed through ``cli.test --streaming`` (4 of 6 frames from the
   feature cache; K1 6 per frame) and each frame held to the 12-view eval
   forward and eval step of the same sample.
11. training from the command line: synthetic scenes at 128x320 (6 scenes
   of 4 frames, 1 held out: 20 train and 4 val samples); one synth_small
   fp32 step with bn_mode="batch", remat on and off: the same BN running
   statistics, one EMA of the step's batch moments; ``python -m
   petr_tpu_torch.cli.train`` on synth_small_r50dcn (bf16) at batch 2 with
   ``--eval-infos`` in a process of its own, sent SIGTERM after a logged
   step of its second epoch (exit 0, a checkpoint at the step boundary),
   then ``--resume`` (it resumes at that step and replays the epoch to its
   end); the CLI again in this process for 3 steps: the same losses and
   gradient norms bit for bit, K1 6, K2 3 + 3 and K4 18 launches per step
   on their bf16 variants (K4 12 at the stride-16 shape, 6 at stride 32),
   and synth_small for 6 steps on the fp32 variants only; both recipes'
   steps at their batch of 4 timed on CUDA events and the host's clock
   with the loader (busy and wait shares, one profiler pass, an eval
   pass) and their learning runs' wall time projected; the harness,
   ``tools.synth_train_eval --config synth_small --steps 30 --bn-warmup 4
   --eval-every 15 --floor 0`` through its entry point in this process:
   its JSON line, a loss that fell, BN statistics moved by the warm-up.
12. parallel training over torch.distributed, ranks spawned on the one
   card (Gloo stages all-reduce and broadcast of CUDA tensors through the
   host; NCCL refuses two ranks on one device). K3 at the token shard's
   shapes (B=2, the rows each rank holds at data 1 x model 2, and B=1;
   L = 3,000 keys from offset 3,000, dropout 0.1, a non-zero lse
   cotangent) against its plain route in fp32 and bf16, timed beside SDPA.
   Every rank checks the all-reduce (MAX) of CUDA tensors that takes the
   lse combine's shift.
   The flagship at full width on a global batch of 2 (dropout 0.1,
   GridMask, remat), bf16 and fp32, in two layouts, data 2 x model 1 and
   data 1 x model 2 (each rank 3,000 of the 6,000 decoder keys through K3):
   each rank's eval and train-mode forward against the 1-rank forward's
   rows, its step's loss, grad_norm and parameters against the 1-rank step
   on the whole batch (fp32 within phase 5's tolerances, with every
   gradient; bf16 by its mean error), K1 12 and each K2 kernel 6 launches
   per rank per step on the dtype's variants, the step's time and its
   share in all-reduces; ``dryrun_multichip(4)`` at data 2 x model 2;
   ``cli.train`` at world size 1 over NCCL; ``cli.train`` over 2 Gloo
   ranks with the eval hook on an odd val split (rank 0 alone logs and
   checkpoints; the metrics equal ``evaluate_model`` of the first epoch's
   checkpoint within 1e-6), both ranks sent SIGTERM in the second epoch
   (exit 0 at one step), in one run.
13. deployment: K6, the int8 conv with int32 sums (its activation
   quantisation pass and its conv: wgmma on TMA-fed tiles, K split where
   the tiles do not fill the card), at each of the 20 conv shapes of the
   flagship's V-99 at 6 views: the int32 sums equal the plain version's
   bit for bit (and at one shape on inputs whose every x / sa is a
   rounding tie), the bf16 outputs within KERNEL_TOL; each timed from CUDA
   graphs (the op on operands prepared once, the conv and the pass alone)
   beside cuDNN's bf16 F.conv2d and torch._int_mm on the im2col patches,
   with its bound at the int8 peak, and summed per forward. The flagship
   calibrated by ``cli.quantize --synthetic`` (its entry point, in this
   process) and served int8 through ``InferenceServer`` (K6
   99 and K1 6 launches per forward, its 99 convs the shapes above, their
   weights prepared once and not again per forward; held to K6's plain
   version under phase 4's limits; its relative L2 error against the bf16 model
   reported beside petr_tpu's bound of 0.05; B=1 forwards of both on CUDA
   events and profiled); ``cli.test --fuse-conv-bn`` and ``--tta hflip``
   (its entry point, in this process) on 3 val samples of phase 10's
   synthetic scenes; the serving
   artifacts (``torch.export``, weights embedded) of the flagship in bf16
   and int8 at B=2 and of ``petr_r50_p4_1408x512`` at B=1, replayed in a
   fresh process that imports the runtime and the op library and no
   model module: K1 6, K4 9 (r50) and K6 99 (int8) launches per call, the
   outputs equal to ``make_serving_fn``'s; PETRv2's streaming pair over 3
   frames through ``StreamingArtifactRunner``, each equal to
   ``StreamingPETRv2.step`` (K1 6 per frame).
14. tools: ``cli.benchmark`` (its entry point, in this process) on the
   flagship at B=1 for inference, ``--train`` and int8 (phase 13's
   scales), each JSON line printed with its ``mfu_pct``, K1 6 launches
   per forward, 12 and K2 6 + 6 per step, K6 99 per int8 forward;
   ``utils.mfu.count_flops`` of the bf16 forward and of the train step
   equal on the kernel route (K1's op by its formula, K2 by its formula
   in the backward) and with every kernel routed to its plain version,
   and ``cli.flops``' line with that count and the forward's peak memory;
   the native loader built from ``csrc/dataload.cpp`` with g++ and
   libjpeg (or a line saying the machine has no ``jpeglib.h``) and held
   to the PIL path on phase 10's val samples at 900x1600 under petr_tpu's
   limits, then the loader's time per batch and an eval pass's wait on it
   on each branch; ``cli.convert`` of a reference-shaped ``.pth`` (the
   flagship's random weights under legacy keys in mmcv's wrapper), the
   converted model's forward equal to the source model's bit for bit,
   and ``cli.publish`` of that checkpoint round-tripped through
   ``load_published``.
Phases 10, 13 and 14 share one rendering of the scenes, and 13 and 14 one
calibration. The seconds of each phase are printed before the card's line.
``--phases 3,8`` runs only the phases named (1 and 2 always run), prints no
kernels record and no result line, and exits 1 either way: a failed check
raises an AssertionError; ``--phases 3`` alone checks and times every kernel. With no
arguments every phase runs. The line before the last is the kernels' JSON
record; the last line is ``{"ok": true, "device": {...}}``. Without a card
it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor
# cores and HBM3. The bf16 peak is the card's from utils.mfu's table once
# main has read it (the SXM's where the table has no entry, said so in the
# run). exp2 runs on the SFUs at 16 results per SM per clock (CUDA C
# Programming Guide, arithmetic throughput table, compute 9.0).
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
# the r50dcn fp32 step's worst gradient against that of a one-ulp nudge of
# its images (check_r50_training)
NUDGE_MARGIN = 3.0
# the r50dcn presets, and the fp32 SM peak of one H100 SXM (data sheet)
R50 = "petr_r50_p4_1408x512"
R50_C5 = "petr_r50_c5_1408x512"
# Depthr: the r50dcn backbone (C5, no neck) and a decoder over 6 x 16 x 44 depth tokens
DEPTHR = "depthr_r50_c5_512x1408_gtdepth"
# PETRv2: two frames of 6 views at 320x800, p4 -> L = 12 x 20 x 50 decoder keys
PETRV2 = "petrv2_vov_p4_800x320"
LV2 = 12 * 20 * 50
PEAK_FP32_FLOPS = 67e12
# A kernel against its plain version, elementwise: fp32 within 2e-5 of the
# largest |ref| (sums in other orders); bf16 within one bf16 step of |ref|
# (at most 2^-7 |ref|) plus that, since both round one fp32 sum.
KERNEL_TOL = {"fp32": (2e-5, 0.0), "bf16": (2e-5, 2.0 ** -7)}
# K1 against the unrounded plain version, elementwise atol + rtol * |ref|
# (absolute: the outputs are ~N(0, 0.023) at the flagship shape). fp32: sums
# in other orders. bf16: one bf16 step of a value x is up to x/128; atol is a
# tenth of a typical output. The bf16 kernel's rounding of p moves it by far
# less (the floor's distance is printed beside).
K1_FP32_TOL = (1e-4, 0.0)
K1_BF16_TOL = (2e-3, 1e-2)
# The bf16 K4 against the unrounded plain version, as KERNEL_TOL (atol x
# max|ref| + rtol x |ref|): it rounds the samples and the weight to bf16
# before their products, as petr_tpu's Pallas kernel does, which moves a sum
# of 2,304 (stage 3) or 4,608 (stage 4) terms by about 2^-9 of its terms'
# root sum of squares. Its rounding floor (the plain version with
# operand_dtype=bfloat16) took 0.52 (stage 3), 0.48 (stage 4), 0.26 (the
# stride-2 odd shape) and 0.55 (Cout 300) of this bound on an H100; the
# shares of each run are printed.
OPERAND_TOL = (4e-3, 1.6e-2)
# Whole bf16 models on two routes that round at other points (K5 against
# cuDNN, K4 against its plain version): per output, atol + rtol * |ref|,
# and a limit on the mean. One bf16 step of a feature flips the later
# layers' rounding, and a centre code is sigmoid(logit) x 102.4 m, so one
# bf16 step of a logit near 4 moves it by up to 0.8. The CPU parity tests
# saw that spread (max 0.24 on logits, 1.4 on codes, mean 0.033) between
# two bf16 packages; on the card the K5 and K4 routes gave max 3.1e-2 on
# logits and 7.5e-2 on codes, mean 2.2e-3.
ROUTE_TOL = {"cls_logits": (0.3, 3e-2), "bbox_codes": (2.0, 3e-2)}
ROUTE_MEAN = 5e-2
# The r50dcn model with K4 against its plain version in fp32
# (check_r50_routes): the backbone's features in relative L2 (measured
# 4.2e-6 at C4, 1.25e-5 at C5) and the head's outputs on average (measured
# 2.8e-7; max 1.5e-5).
R50_FP32_MEAN = 1e-4
R50_FP32_FEAT = 1e-4
# The flagship's fp32 twin on the K5 route (its fp32 kernel) against the
# cuDNN route, TF32 off: both sum in fp32, in other orders, so per output
# atol + rtol * |ref| and a limit on the mean, at 100x what the r50dcn fp32
# twin's K4 route gave against its plain version (max 1.5e-5, mean 2.8e-7).
FP32_ROUTE_TOL = {"cls_logits": (2e-3, 2e-4), "bbox_codes": (2e-3, 2e-4)}
FP32_ROUTE_MEAN = 1e-4


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


def profiled_kernels(torch, fn, iters, inference=False):
    """One torch.profiler pass over ``iters`` calls of ``fn`` -> ([(device ms
    per call, launches per call, kernel name)], largest first; the pass's
    wall ms). A pass now and then comes back without its device events: then
    it profiles again, up to three times."""
    import contextlib

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        mode = torch.inference_mode() if inference else contextlib.nullcontext()
        with mode, torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                # a kernel whose launch no recorded op encloses (a ctypes call
                # outside an autograd Function) is left out of key_averages
                with torch.profiler.record_function("call"):
                    fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted(
            ((e.self_device_time_total / 1e3 / iters, e.count // iters, e.key)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
             # a record_function range on the device (ours, AdamW's) is not a kernel
             and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")),
            reverse=True,
        )
        if rows:
            return rows, wall_ms
    raise AssertionError("the profiler saw no device time in three passes")


def device_ms(torch, fn, name=None, warmup=3, iters=20):
    """Device time per call of ``fn`` (the self time of every kernel it
    launches, from ``profiled_kernels``); with ``name``, also that of the
    kernels whose name holds it, as a second number. One call between CUDA
    events (``cuda_time_ms``, the records' ``ms``) also counts the host's
    time between the call's launches, which a kernel of a few tens of
    microseconds does not cover; this is the kernels' time alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    rows, _ = profiled_kernels(torch, fn, iters)
    total = sum(r[0] for r in rows)
    if name is None:
        return total
    named = sum(r[0] for r in rows if name in r[2])
    assert named > 0, f"the profiler saw no kernel named {name}"
    return total, named


def bound_ms(pairs, flops_per_pair, nbytes, sm_count, sm_clock_hz, peak_flops=None):
    """Least time for an attention kernel: the larger of its products over the
    peak of their type (the bf16 tensor cores by default), its exponentials
    (one per pair) over the SFU rate, and its bytes (each input read once,
    each output written once) over HBM bandwidth. ``pairs`` counts the
    (query, unmasked key) pairs of the inputs."""
    t_flops = flops_per_pair * pairs / (peak_flops or PEAK_BF16_FLOPS)
    t_exp = pairs / (sm_count * SFU_EXP_PER_SM_CLOCK * sm_clock_hz)
    t_bytes = nbytes / PEAK_HBM_BYTES
    bound = max(t_flops, t_exp, t_bytes)
    return bound * 1e3, ("bytes" if bound == t_bytes else "operations"), {
        "tensor_core_ms": t_flops * 1e3, "exp_ms": t_exp * 1e3, "bytes_ms": t_bytes * 1e3,
    }


def attention_inputs(torch, gen, batch, dtype, H=8, Q=900, L=6000, D=32, grid=False):
    """q/k/v at the flagship decoder shape, as the (B, H, ., D) transposes of
    (B, ., H, D) projections, exactly as MultiheadAttention hands them over,
    and a key mask with a padded tail and padding inside. With ``grid`` the
    N(0, 1) draws are rounded to multiples of 1/8 in [-4, 4]: every q.k is
    then exact in fp32 in any order of its sum, so the kernel's logits equal
    the plain version's bit for bit (see check_flash_attention)."""
    def draw(n):
        t = torch.randn(batch, n, H, D, generator=gen, device="cuda")
        if grid:
            t = (t * 8).round().clamp(-32, 32) / 8
        return t.to(dtype).transpose(1, 2)

    q, k, v = draw(Q), draw(L), draw(L)
    mask = torch.zeros(batch, L, dtype=torch.bool, device="cuda")
    mask[:, L - 700:] = True
    mask[:, 1000:1200] = True
    return q, k, v, mask


def check_flash_attention(torch, ca, sm_clock_hz, card):
    """K1 against its plain versions at the flagship decoder shape and the
    r50dcn decoder's L = 16,896, without and with dropout, then timed.

    The bf16 kernel (tensor cores) rounds p to bf16 for its product with v,
    against each row's final maximum; ``round_p=True`` makes the plain
    version round it at the same point: the rounding floor. On inputs whose
    logits are exact in fp32 (``grid``) the two compute every p bit for bit
    and differ only in the order of the fp32 sums, so they are held to
    KERNEL_TOL. On N(0, 1) inputs the kernel's q.k (mma) and torch's differ
    in the last bit, which flips the bf16 rounding of about one p in 10^4-10^5;
    there the kernel is held to the unrounded plain version within
    K1_BF16_TOL, and the floor's own distance from it is printed beside. The
    fp32 kernel (CUDA cores) is held to the unrounded plain version within
    K1_FP32_TOL. Each call must move its variant's launch counter only."""
    import torch.nn.functional as F

    B, H, Q, L, D = 1, 8, 900, 6000, 32
    Lr = 6 * 32 * 88  # the r50dcn decoder: L = 6 views x 32 x 88 tokens at 512x1408, p4
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def counts():
        return ca.LAUNCHES, ca.LAUNCHES_FP32

    def run(q, k, v, mask, rate):
        seed = DROP_SEED if rate > 0 else None
        before = counts()
        out, lse = ca.flash_cross_attention(q, k, v, mask, rate, seed)
        torch.cuda.synchronize()
        bf16 = q.dtype == torch.bfloat16
        assert counts() == (before[0] + bf16, before[1] + (not bf16)), (
            f"a {q.dtype} call did not move its own launch counter alone: {before} -> {counts()}")
        assert out.dtype == q.dtype and out.shape == q.shape and lse.shape == q.shape[:3]
        return out, lse

    def check_lse_and_masked_rows(name, out, lse, ref_lse, masked_rows):
        live = torch.ones(out.shape[0], dtype=torch.bool, device="cuda")
        live[list(masked_rows)] = False
        lse_err = (lse[live] - ref_lse[live]).abs().max().item()
        assert lse_err <= 1e-3, f"{name}: lse error {lse_err}"
        for b in masked_rows:
            assert (out[b] == 0).all(), f"{name}: fully masked row {b} has nonzero output"
            assert (lse[b] == 1e30).all(), f"{name}: fully masked row {b} lse is not +1e30"
        return lse_err

    def compare(name, q, k, v, mask, tol, masked_rows=(), rate=0.0):
        """The kernel against the unrounded plain version, elementwise within
        atol + rtol * |ref|; for bf16 also the floor's distance from it."""
        seed = DROP_SEED if rate > 0 else None
        out, lse = run(q, k, v, mask, rate)
        ref_out, ref_lse = ca.flash_cross_attention_reference(q, k, v, mask, rate, seed)
        o, r = out.float(), ref_out.float()
        atol, rtol = tol
        err = (o - r).abs()
        bound = atol + rtol * r.abs()
        lse_err = check_lse_and_masked_rows(name, out, lse, ref_lse, masked_rows)
        floor = ""
        if q.dtype == torch.bfloat16:
            fl_out, _ = ca.flash_cross_attention_reference(q, k, v, mask, rate, seed, round_p=True)
            fe = (fl_out.float() - r).abs()
            ke = (o - fl_out.float()).abs()
            floor = (f"; the floor (round_p) vs unrounded: max {fe.max().item():.3e}, worst share of the bound "
                     f"{(fe / bound).max().item():.3f} (kernel {(err / bound).max().item():.3f}); kernel vs floor "
                     f"max {ke.max().item():.3e}")
        log(f"  {name}: out max abs err {err.max().item():.3e} (atol {atol}, rtol {rtol}), lse max abs err "
            f"{lse_err:.3e} (tol 1e-3){floor}")
        assert not (err > bound).any(), f"{name}: {int((err > bound).sum())} outputs out of tolerance"
        return err.max().item()

    def compare_floor(name, q, k, v, mask, masked_rows=(), rate=0.0):
        """The bf16 kernel against its rounding floor under KERNEL_TOL."""
        seed = DROP_SEED if rate > 0 else None
        out, lse = run(q, k, v, mask, rate)
        fl_out, fl_lse = ca.flash_cross_attention_reference(q, k, v, mask, rate, seed, round_p=True)
        check_lse_and_masked_rows(name, out, lse, fl_lse, masked_rows)
        return kernel_compare(torch, name, out, fl_out, "bf16")

    log("phase 3: flash_cross_attention (K1) against its plain versions")
    q32, k32, v32, m32 = attention_inputs(torch, gen, B, torch.float32)
    fp32_err = compare("fp32", q32, k32, v32, m32, K1_FP32_TOL)
    q16, k16, v16, m16 = attention_inputs(torch, gen, B, torch.bfloat16)
    max_err = compare("bf16", q16, k16, v16, m16, K1_BF16_TOL)
    qm, km, vm, mm = attention_inputs(torch, gen, 2, torch.bfloat16)
    mm[1] = True  # batch row 1 is all padding
    compare("bf16, batch row 1 fully masked", qm, km, vm, mm, K1_BF16_TOL, masked_rows=(1,))
    qmf, kmf, vmf, mmf = attention_inputs(torch, gen, 2, torch.float32)
    mmf[1] = True
    compare("fp32, batch row 1 fully masked", qmf, kmf, vmf, mmf, K1_FP32_TOL, masked_rows=(1,))
    qr, kr, vr, mr = attention_inputs(torch, gen, B, torch.bfloat16, H, Q, Lr, D)
    r50_err = compare(f"bf16, r50dcn L {Lr}", qr, kr, vr, mr, K1_BF16_TOL)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    qv, kv, vv, mv = attention_inputs(torch, gen, B, torch.bfloat16, H, Q, LV2, D)
    v2_err = compare(f"bf16, PETRv2 L {LV2}", qv, kv, vv, mv, K1_BF16_TOL)
    qv2, kv2, vv2, mv2 = attention_inputs(torch, gen, 2, torch.bfloat16, H, Q, LV2, D)
    v2_plan = ca.attention_plan(2 * H, Q, sms)
    assert v2_plan == 4, f"batch 2 at L {LV2} should take the 64-row plan, took {v2_plan} query warps"
    v2_b2_err = compare(f"bf16, PETRv2 L {LV2}, batch 2 (64-row plan)", qv2, kv2, vv2, mv2, K1_BF16_TOL)

    log(f"phase 3: K1 with dropout {DROPOUT} (seed {DROP_SEED}) against its plain versions")
    kept = ca.dropout_keep_mask(DROP_SEED, 2, H, Q, L, DROPOUT, "cuda").float().mean().item()
    log(f"  kept fraction of the hashed mask over 2 x {H} x {Q} x {L}: {kept:.5f} (1 - rate = {1 - DROPOUT})")
    assert abs(kept - (1 - DROPOUT)) <= 0.01, kept
    compare("fp32, dropout", q32, k32, v32, m32, K1_FP32_TOL, rate=DROPOUT)
    drop_err = compare("bf16, dropout", q16, k16, v16, m16, K1_BF16_TOL, rate=DROPOUT)
    compare("bf16, dropout, batch row 1 fully masked", qm, km, vm, mm, K1_BF16_TOL, (1,), DROPOUT)
    compare("fp32, dropout, batch row 1 fully masked", qmf, kmf, vmf, mmf, K1_FP32_TOL, (1,), DROPOUT)
    compare(f"bf16, dropout, r50dcn L {Lr}", qr, kr, vr, mr, K1_BF16_TOL, rate=DROPOUT)
    v2_drop_err = compare(f"bf16, dropout, PETRv2 L {LV2}", qv, kv, vv, mv, K1_BF16_TOL, rate=DROPOUT)
    compare(f"bf16, dropout, PETRv2 L {LV2}, batch 2 (64-row plan)", qv2, kv2, vv2, mv2, K1_BF16_TOL,
            rate=DROPOUT)
    del qv2, kv2, vv2, mv2

    log("phase 3: bf16 K1 against its rounding floor (round_p=True) under KERNEL_TOL, on inputs whose "
        "logits are exact in fp32 (N(0, 1) draws rounded to multiples of 1/8)")
    floor_errs, v2_floor_errs = [], []
    for Lc in (L, Lr, LV2):
        for rate in (0.0, DROPOUT):
            for batch in (1, 2):
                qg, kg, vg, mg = attention_inputs(torch, gen, batch, torch.bfloat16, H, Q, Lc, D, grid=True)
                rows = ()
                if batch == 2:
                    mg[1] = True
                    rows = (1,)
                name = f"floor, L {Lc}, rate {rate}" + (", batch row 1 fully masked" if rows else "")
                (v2_floor_errs if Lc == LV2 else floor_errs).append(compare_floor(name, qg, kg, vg, mg, rows, rate))
                del qg, kg, vg, mg

    def timed(q, k, v, m, Lc, peak):
        """One call between CUDA events and the device time, of K1 (rate 0 and
        0.1), its plain version and SDPA with a boolean mask; the bound."""
        keep = ~m[:, None, None, :]  # SDPA's boolean mask: True = attend
        t = {
            "ms": cuda_time_ms(lambda: ca.flash_cross_attention(q, k, v, m)),
            "device_ms": device_ms(torch, lambda: ca.flash_cross_attention(q, k, v, m)),
            "dropout_ms": cuda_time_ms(lambda: ca.flash_cross_attention(q, k, v, m, DROPOUT, DROP_SEED)),
            "dropout_device_ms": device_ms(torch, lambda: ca.flash_cross_attention(q, k, v, m, DROPOUT, DROP_SEED)),
            "plain_ms": cuda_time_ms(lambda: ca.flash_cross_attention_reference(q, k, v, m), warmup=2, iters=10),
            "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep)),
            "library_device_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep)),
        }
        e = q.element_size()
        nbytes = e * B * H * D * (2 * Q + 2 * Lc) + 4 * B * H * Q + B * Lc  # q, k, v, mask; out, lse
        t["bound_ms"], t["bound_by"], t["bound_parts"] = bound_ms(H * Q * int((~m).sum()), 4.0 * D, nbytes, sms,
                                                                  sm_clock_hz, peak)
        return t

    t16 = timed(q16, k16, v16, m16, L, PEAK_BF16_FLOPS)
    tr = timed(qr, kr, vr, mr, Lr, PEAK_BF16_FLOPS)
    tv = timed(qv, kv, vv, mv, LV2, PEAK_BF16_FLOPS)
    t32 = timed(q32, k32, v32, m32, L, PEAK_FP32_FLOPS)
    t32["dropout_plain_ms"] = cuda_time_ms(
        lambda: ca.flash_cross_attention_reference(q32, k32, v32, m32, DROPOUT, DROP_SEED), warmup=2, iters=10)
    drop_plain_ms = cuda_time_ms(lambda: ca.flash_cross_attention_reference(q16, k16, v16, m16, DROPOUT, DROP_SEED),
                                 warmup=2, iters=10)
    plan = ca.attention_plan(B * H, Q, sms)
    plans = {qw: device_ms(torch, lambda: ca._forward_cuda(q16, k16, v16, m16, 0.0, None, query_warps=qw))
             for qw in (2, 4)}
    masks = {L: m16, Lr: mr, LV2: mv}
    for tag, Lc, t in (("bf16", L, t16), ("bf16", Lr, tr), ("bf16", LV2, tv), ("fp32", L, t32)):
        log(f"  timing {tag} B={B} H={H} Q={Q} L={Lc} ({int((~masks[Lc]).sum())} unmasked) D={D}: "
            f"kernel_ms {t['ms']:.4f} ({t['dropout_ms']:.4f} with dropout {DROPOUT}), plain_ms {t['plain_ms']:.4f}, "
            f"library_ms (SDPA, boolean mask) {t['library_ms']:.4f} (one call between CUDA events); device time: "
            f"kernel {t['device_ms']:.4f} ({t['dropout_device_ms']:.4f} with dropout), SDPA "
            f"{t['library_device_ms']:.4f}, kernel / SDPA {t['device_ms'] / t['library_device_ms']:.3f}; bound_ms "
            f"{t['bound_ms']:.4f} ({t['bound_by']}; {json.dumps({k: round(v, 5) for k, v in t['bound_parts'].items()})}"
            f") [{card}]")
    log(f"  bf16 plan at the flagship: {plan} query warps per block (attention_plan); device time with 2: "
        f"{plans[2]:.4f} ms, with 4: {plans[4]:.4f} ms [{card}]")
    bf16_rec = {
        "name": "flash_cross_attention_fwd",
        "route": "cuda",
        "source": "petr_tpu_torch/csrc/flash_cross_attention.cu",
        "replaces": "petr_tpu/ops/pallas/cross_attention.py:62::_kernel",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "floor_max_abs_err": max(floor_errs),
        "ms": t16["ms"],
        "kernel_ms": t16["ms"],
        "plain_ms": t16["plain_ms"],
        "bound_ms": t16["bound_ms"],
        "bound_by": t16["bound_by"],
        "library_ms": t16["library_ms"],
        "device_ms": t16["device_ms"],
        "library_device_ms": t16["library_device_ms"],
        "device_ms_over_sdpa": t16["device_ms"] / t16["library_device_ms"],
        "query_warps": plan,
        "device_ms_by_query_warps": plans,
        "dropout_kernel_ms": t16["dropout_ms"],
        "dropout_device_ms": t16["dropout_device_ms"],
        "dropout_plain_ms": drop_plain_ms,
        "dropout_max_abs_err": drop_err,
        "r50_L": Lr,
        "r50_kernel_ms": tr["ms"],
        "r50_device_ms": tr["device_ms"],
        "r50_dropout_kernel_ms": tr["dropout_ms"],
        "r50_dropout_device_ms": tr["dropout_device_ms"],
        "r50_plain_ms": tr["plain_ms"],
        "r50_library_ms": tr["library_ms"],
        "r50_library_device_ms": tr["library_device_ms"],
        "r50_bound_ms": tr["bound_ms"],
        "r50_max_abs_err": r50_err,
    }
    fp32_rec = {
        "name": "flash_cross_attention_fwd_fp32",
        "route": "cuda",
        "source": "petr_tpu_torch/csrc/flash_cross_attention.cu",
        "replaces": "petr_tpu/ops/pallas/cross_attention.py:62::_kernel",
        "launches": None,  # filled from the flagship's fp32 train step
        "max_abs_err": fp32_err,
        "ms": t32["ms"],
        "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"],
        "bound_by": t32["bound_by"],
        "library_ms": t32["library_ms"],
        "device_ms": t32["device_ms"],
        "library_device_ms": t32["library_device_ms"],
        "dropout_kernel_ms": t32["dropout_ms"],
        "dropout_device_ms": t32["dropout_device_ms"],
        "dropout_plain_ms": t32["dropout_plain_ms"],
    }
    v2_rec = {
        "name": f"flash_cross_attention_fwd_L{LV2}",
        "route": "cuda",
        "source": "petr_tpu_torch/csrc/flash_cross_attention.cu",
        "replaces": "petr_tpu/ops/pallas/cross_attention.py:62::_kernel",
        "launches": None,  # filled from the PETRv2 serving run (phase 8)
        "shape": {"B": B, "H": H, "Q": Q, "L": LV2, "D": D, "unmasked": int((~mv).sum())},
        "max_abs_err": v2_err,
        "batch2_max_abs_err": v2_b2_err,
        "batch2_query_warps": v2_plan,
        "floor_max_abs_err": max(v2_floor_errs),
        "ms": tv["ms"],
        "plain_ms": tv["plain_ms"],
        "bound_ms": tv["bound_ms"],
        "bound_by": tv["bound_by"],
        "bound_parts": tv["bound_parts"],
        "library_ms": tv["library_ms"],
        "device_ms": tv["device_ms"],
        "library_device_ms": tv["library_device_ms"],
        "device_ms_over_sdpa": tv["device_ms"] / tv["library_device_ms"],
        "dropout_kernel_ms": tv["dropout_ms"],
        "dropout_device_ms": tv["dropout_device_ms"],
        "dropout_max_abs_err": v2_drop_err,
    }
    return bf16_rec, fp32_rec, v2_rec


def rounded_plain_backward(torch, ca, q, k, v, mask, out, lse, gout, rate, seed):
    """The plain backward with P (after dropout) and dS rounded to bf16 before
    their products, as the tensor-core kernels round them: how far that
    rounding alone moves the fp32 plain backward."""
    import math

    B, H, Q, D = q.shape
    L = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), gout.float()
    delta = ca._delta(gout, out, None)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s = s.masked_fill(mask[:, None, None, :], ca.NEG)
    p = torch.exp(torch.clamp(s - lse[..., None], max=0.0))
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    keep = ca.dropout_keep_mask(seed, B, H, Q, L, rate, q.device)
    p_drop = torch.where(keep, p / (1.0 - rate), 0.0)
    dp = torch.where(keep, dp / (1.0 - rate), 0.0)
    ds = (p * (dp - delta[..., None])).bfloat16().float()
    dv = torch.matmul(p_drop.bfloat16().float().transpose(-1, -2), gf)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return tuple(g.to(q.dtype) for g in (dq, dk, dv))


def check_flash_backward(torch, ca, sm_clock_hz, card):
    """K2 (its dK/dV and dQ kernels, bf16 on the tensor cores and fp32 on the
    CUDA cores) against the plain backward at the flagship decoder shape,
    and the bf16 ones also at the r50dcn decoder's L = 16,896, where its
    train step runs them; K3's lse cotangent through the autograd Function;
    then each kernel timed at both L."""
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

    def counts():
        return {"bf16": (ca.DKDV_LAUNCHES, ca.DQ_LAUNCHES), "fp32": (ca.DKDV_LAUNCHES_FP32, ca.DQ_LAUNCHES_FP32)}

    log(f"phase 3: K2 (flash_cross_attention backward) against its plain version")
    Lr = 6 * 32 * 88  # the r50dcn decoder's keys: 6 views x 32 x 88 tokens
    cases = [(dtype, tag, rate, batch, L) for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16"))
             for rate in (0.0, DROPOUT) for batch in (1, 2)]
    cases += [(torch.bfloat16, "bf16", rate, 1, Lc) for rate in (0.0, DROPOUT)  # the r50dcn and PETRv2 steps'
              for Lc in (Lr, LV2)]
    errs = {}
    for dtype, tag, rate, batch, Lc in cases:
        q, k, v, m = attention_inputs(torch, gen, batch, dtype, H, Q, Lc, D)
        if batch == 2:
            m[1] = True  # batch row 1 is all padding
        gout = cotangent(batch, dtype)
        out, lse = ca.flash_cross_attention_reference(q, k, v, m, rate, DROP_SEED)
        delta = ca._delta(gout, out, None)
        before = counts()
        got = ca._backward_cuda(q, k, v, m, gout, lse, delta, rate, DROP_SEED)
        torch.cuda.synchronize()
        after = counts()
        other = "fp32" if tag == "bf16" else "bf16"
        assert after[tag] == (before[tag][0] + 1, before[tag][1] + 1) and after[other] == before[other], (
            f"the {tag} call did not launch the {tag} variants: {before} -> {after}")
        want = ca.flash_cross_attention_backward_reference(q, k, v, m, out, lse, gout, None, rate, DROP_SEED)
        name = f"{tag}, rate {rate}, L {Lc}" + (", batch row 1 fully masked" if batch == 2 else "")
        errs[(tag, rate, batch, Lc)] = check_grads(name, tag, got, want, batch == 2)
        if tag == "bf16" and batch == 1 and rate == DROPOUT and Lc == L:
            # how far rounding P and dS to bf16 moves the plain backward alone
            rounded = rounded_plain_backward(torch, ca, q, k, v, m, out, lse, gout, rate, DROP_SEED)
            for g_name, r, w, g in zip(("dq", "dk", "dv"), rounded, want, got):
                r, w, g = r.float(), w.float(), g.float()
                scale = w.abs().max().item()
                atol, rtol = BWD_TOL["bf16"]
                log(f"  plain backward with P and dS rounded to bf16, {g_name}: max abs err "
                    f"{(r - w).abs().max().item():.3e} (kernel {(g - w).abs().max().item():.3e}); worst "
                    f"share of the bound {((r - w).abs() / (atol * scale + rtol * w.abs())).max().item():.3f} "
                    f"(kernel {((g - w).abs() / (atol * scale + rtol * w.abs())).max().item():.3f})")
        del q, k, v, m, gout, out, lse, delta, got, want

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

    # timing at the train path's inputs, with and without dropout, at the
    # flagship's L and the r50dcn decoder's (6 views x 32 x 88 tokens)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timing = {}
    for tag, dtype, Lt in (("bf16", torch.bfloat16, L), ("bf16", torch.bfloat16, Lr), ("bf16", torch.bfloat16, LV2),
                           ("fp32", torch.float32, L)):
        q, k, v, m = attention_inputs(torch, gen, B, dtype, H, Q, Lt, D)
        gout = cotangent(B, dtype)
        out, lse = ca.flash_cross_attention(q, k, v, m, DROPOUT, DROP_SEED)
        delta = ca._delta(gout, out, None)
        args = (q, k, v, m, gout, lse, delta)
        t = {}
        for rate in (DROPOUT, 0.0):
            for which in ("dkdv", "dq"):
                def call():
                    ca._backward_cuda(*args, rate, DROP_SEED, kernels=(which,))
                t[(which, rate)] = cuda_time_ms(call)
                t[(which, rate, "device")] = device_ms(torch, call)
        t["plain"] = cuda_time_ms(lambda: ca.flash_cross_attention_backward_reference(
            q, k, v, m, out, lse, gout, None, DROPOUT, DROP_SEED), warmup=2, iters=10)
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=~m[:, None, None, :])

        def sdpa_backward():
            torch.autograd.grad(sdpa, (qs, ks, vs), gout, retain_graph=True)
        t["library"] = cuda_time_ms(sdpa_backward)
        t["library_device"] = device_ms(torch, sdpa_backward)
        pairs = H * Q * int((~m).sum())
        e, f = (2 if tag == "bf16" else 4), 8 * B * H * Q + B * Lt  # element bytes; lse, delta and mask bytes
        peak = PEAK_BF16_FLOPS if tag == "bf16" else PEAK_FP32_FLOPS
        t["bounds"] = {
            "dkdv": bound_ms(pairs, 8.0 * D, e * B * H * D * (2 * Q + 4 * Lt) + f, sms, sm_clock_hz, peak),
            "dq": bound_ms(pairs, 6.0 * D, e * B * H * D * (3 * Q + 2 * Lt) + f, sms, sm_clock_hz, peak),
            "both": bound_ms(pairs, 10.0 * D, e * B * H * D * (3 * Q + 4 * Lt) + f, sms, sm_clock_hz, peak),
        }
        timing[(tag, Lt)] = t
        for which in ("dkdv", "dq", "both"):
            b_ms, b_by, parts = t["bounds"][which]
            log(f"  {tag} L={Lt} bound_ms {which} {b_ms:.4f} ({b_by}; "
                f"{json.dumps({k: round(v, 5) for k, v in parts.items()})})")
        for unit, key in (("one call between CUDA events", ()), ("device time", ("device",))):
            lib = t["library" if not key else "library_device"]
            dkdv = {r: t[("dkdv", r, *key)] for r in (DROPOUT, 0.0)}
            dq = {r: t[("dq", r, *key)] for r in (DROPOUT, 0.0)}
            log(f"  timing {tag} B={B} H={H} Q={Q} L={Lt} ({pairs // (H * Q)} unmasked) D={D}, {unit}: dropout "
                f"{DROPOUT}: dK/dV {dkdv[DROPOUT]:.4f}, dQ {dq[DROPOUT]:.4f} (sum {dkdv[DROPOUT] + dq[DROPOUT]:.4f}); "
                f"rate 0: dK/dV {dkdv[0.0]:.4f}, dQ {dq[0.0]:.4f} (sum {dkdv[0.0] + dq[0.0]:.4f}); library_ms (SDPA "
                f"backward, boolean mask, rate 0) {lib:.4f}" + ("" if key else f"; plain backward {t['plain']:.4f}")
                + f" [{card}]")
    records = []
    for tag, suffix in (("bf16", ""), ("fp32", "_fp32")):
        t = timing[(tag, L)]
        for which, name in (("dkdv", "flash_cross_attention_bwd_dkdv"), ("dq", "flash_cross_attention_bwd_dq")):
            b_ms, b_by, _ = t["bounds"][which]
            grads = ("dk", "dv") if which == "dkdv" else ("dq",)
            rec = {
                "name": name + suffix,
                "route": "cuda",
                "source": "petr_tpu_torch/csrc/flash_cross_attention_bwd.cu",
                "replaces": "petr_tpu/ops/pallas/cross_attention.py:198::_bwd_kernel",
                "launches": None,  # filled from the train path's run
                "max_abs_err": max(errs[(tag, DROPOUT, 1, L)][g] for g in grads),
                "ms": t[(which, DROPOUT)],
                "kernel_ms": t[(which, DROPOUT)],
                "rate0_kernel_ms": t[(which, 0.0)],
                "plain_ms": t["plain"],  # the whole plain backward (dq, dk and dv)
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": t["library"],  # SDPA's whole backward at rate 0
                "device_ms": t[(which, DROPOUT, "device")],
                "rate0_device_ms": t[(which, 0.0, "device")],
                "library_device_ms": t["library_device"],
            }
            if tag == "bf16":
                tr = timing[("bf16", Lr)]
                rec.update({"r50_L": Lr, "r50_ms": tr[(which, DROPOUT)], "r50_rate0_ms": tr[(which, 0.0)],
                            "r50_device_ms": tr[(which, DROPOUT, "device")],
                            "r50_rate0_device_ms": tr[(which, 0.0, "device")],
                            "r50_bound_ms": tr["bounds"][which][0], "r50_library_ms": tr["library"],
                            "r50_library_device_ms": tr["library_device"], "r50_plain_ms": tr["plain"],
                            "r50_max_abs_err": max(errs[(tag, DROPOUT, 1, Lr)][g] for g in grads)})
            records.append(rec)
    t = timing[("bf16", LV2)]
    for which, name in (("dkdv", "flash_cross_attention_bwd_dkdv"), ("dq", "flash_cross_attention_bwd_dq")):
        b_ms, b_by, parts = t["bounds"][which]
        grads = ("dk", "dv") if which == "dkdv" else ("dq",)
        records.append({
            "name": f"{name}_L{LV2}",
            "route": "cuda",
            "source": "petr_tpu_torch/csrc/flash_cross_attention_bwd.cu",
            "replaces": "petr_tpu/ops/pallas/cross_attention.py:198::_bwd_kernel",
            "launches": None,  # filled from the PETRv2 train run (phase 8)
            "shape": {"B": B, "H": H, "Q": Q, "L": LV2, "D": D},
            "max_abs_err": max(errs[("bf16", DROPOUT, 1, LV2)][g] for g in grads),
            "rate0_max_abs_err": max(errs[("bf16", 0.0, 1, LV2)][g] for g in grads),
            "ms": t[(which, DROPOUT)],
            "rate0_ms": t[(which, 0.0)],
            "plain_ms": t["plain"],  # the whole plain backward (dq, dk and dv)
            "bound_ms": b_ms,
            "bound_by": b_by,
            "bound_parts": parts,
            "library_ms": t["library"],  # SDPA's whole backward at rate 0
            "device_ms": t[(which, DROPOUT, "device")],
            "rate0_device_ms": t[(which, 0.0, "device")],
            "library_device_ms": t["library_device"],
        })
    return records


def kernel_compare(torch, name, got, want, tag):
    """A kernel's output against its plain version under KERNEL_TOL."""
    atol, rtol = KERNEL_TOL[tag]
    g, w = got.float(), want.float()
    scale = w.abs().max().item()
    err = (g - w).abs()
    bad = err > atol * scale + rtol * w.abs()
    log(f"  {name}: max abs err {err.max().item():.3e} (max |ref| {scale:.3e}; atol {atol} x max|ref|, "
        f"rtol {rtol})")
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    assert not bad.any(), f"{name}: {int(bad.sum())} of {bad.numel()} outputs out of tolerance"
    return err.max().item()


def roofline(flops, nbytes, peak_flops=None):
    """(bound_ms, bound_by, parts): the larger of the products over the
    bf16 tensor-core peak (or ``peak_flops``) and the bytes (each input read
    once, each output written once) over HBM bandwidth."""
    t_flops, t_bytes = flops / (peak_flops or PEAK_BF16_FLOPS), nbytes / PEAK_HBM_BYTES
    bound = max(t_flops, t_bytes)
    return bound * 1e3, ("bytes" if t_bytes >= t_flops else "operations"), {
        "tensor_core_ms": t_flops * 1e3, "bytes_ms": t_bytes * 1e3, "fp32_core_ms": flops / PEAK_FP32_FLOPS * 1e3}


def dcn_inputs(torch, gen, B, Cin, H, W, Cout, stride, dtype):
    """x in ``dtype``, fp32 off_mask with offsets of std 3 pixels (taps past
    every edge) and mask logits of std 1.5, a He-scaled fp32 weight."""
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = torch.randn(B, Cin, H, W, generator=gen, device="cuda").to(dtype)
    om = torch.cat([torch.randn(B, 18, Ho, Wo, generator=gen, device="cuda") * 3.0,
                    torch.randn(B, 9, Ho, Wo, generator=gen, device="cuda") * 1.5], 1)
    w = torch.randn(Cout, Cin, 3, 3, generator=gen, device="cuda") * (2.0 / (9 * Cin)) ** 0.5
    return x, om, w


def check_dcn(torch, dcn, card):
    """K4 against its plain versions at both r50dcn stages (6 views of
    512x1408) and a small odd shape at stride 2, in fp32 and bf16; its
    gradients through the autograd Function against the plain route; then
    timed beside the plain version and cuDNN's dense 3x3 conv at the same
    shape (a floor, not the same function: no PyTorch call computes DCNv2).

    The bf16 kernel (tensor cores) rounds the modulated samples and the
    weight to bf16 before their products; the plain version with
    operand_dtype=bfloat16 rounds the same values at the same points (its
    rounding floor), so the two differ only in the order of the fp32 sums
    and are held to KERNEL_TOL; the unrounded plain version is held to
    OPERAND_TOL. The fp32 kernel (CUDA cores) is held to the unrounded plain version under
    KERNEL_TOL. Each call must move its variant's launch counter only."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    shapes = {"stage3": (6, 256, 32, 88, 256, 1), "stage4": (6, 512, 16, 44, 512, 1), "odd": (2, 5, 7, 9, 3, 2),
              "odd-wide": (1, 70, 3, 130, 300, 1)}
    log("phase 3: modulated_deform_conv (K4) against its plain versions")
    errs, inputs = {}, {}

    def counted(fn, bf16):
        before = (dcn.LAUNCHES, dcn.LAUNCHES_FP32)
        out = fn()
        torch.cuda.synchronize()
        after = (dcn.LAUNCHES, dcn.LAUNCHES_FP32)
        assert after == (before[0] + bf16, before[1] + (not bf16)), (
            f"the call did not move its own launch counter alone: {before} -> {after}")
        return out

    for label, (B, Cin, H, W, Cout, stride) in shapes.items():
        for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            x, om, w = dcn_inputs(torch, gen, B, Cin, H, W, Cout, stride, dtype)
            inputs[(label, tag)] = (x, om, w)
            name = f"{label} {tag} x {tuple(x.shape)} -> {Cout} stride {stride}"
            want = dcn.modulated_deform_conv_reference(x, om, w, stride)
            if tag == "fp32":
                out = counted(lambda: dcn.modulated_deform_conv(x, om, w, stride), False)
                errs[(label, tag)] = kernel_compare(torch, name, out, want, tag)
                continue
            floor = dcn.modulated_deform_conv_reference(x, om, w, stride, operand_dtype=torch.bfloat16)
            out = counted(lambda: dcn.modulated_deform_conv(x, om, w, stride), True)
            errs[(label, tag, "floor")] = kernel_compare(torch, f"{name} vs its rounding floor", out, floor, tag)
            atol, rtol = OPERAND_TOL
            r = want.float()
            bound = atol * r.abs().max() + rtol * r.abs()
            err, ferr = (out.float() - r).abs(), (floor.float() - r).abs()
            log(f"  {name} vs the unrounded plain version: max abs err {err.max().item():.3e} (max |ref| "
                f"{r.abs().max().item():.3e}; atol {atol} x max|ref|, rtol {rtol}), worst share of the bound "
                f"{(err / bound).max().item():.3f}; the floor's {(ferr / bound).max().item():.3f}")
            assert not (err > bound).any(), f"{name}: {int((err > bound).sum())} outputs out of OPERAND_TOL"
            errs[(label, tag)] = err.max().item()

    log("phase 3: K4's gradients through the autograd Function against the plain route (fp32, stage 4 shape)")
    x, om, w = inputs[("stage4", "fp32")]
    gout = torch.randn(6, 512, 16, 44, generator=gen, device="cuda")
    grads = []
    for fn in (dcn.modulated_deform_conv, dcn.modulated_deform_conv_plain):
        ins = [t.detach().clone().requires_grad_() for t in (x, om, w)]
        fn(*ins).backward(gout)
        g_om = ins[1].grad
        grads.append({"x": ins[0].grad, "offsets": g_om[:, :18], "mask logits": g_om[:, 18:], "weight": ins[2].grad})
    for key in grads[0]:
        a, b = grads[0][key], grads[1][key]
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        log(f"  d{key}: max abs err {err:.3e} (max |ref| {scale:.3e}; tol 1e-5 x max|ref|)")
        assert err <= 1e-5 * scale, key

    timing = {}
    for label in ("stage3", "stage4"):
        B, Cin, H, W, Cout, _ = shapes[label]
        x, om, w = inputs[(label, "bf16")]
        x32, om32, w32 = inputs[(label, "fp32")]
        P = H * W
        flops = 2.0 * B * P * Cout * 9 * Cin
        nbytes = 2 * B * Cin * H * W + 4 * B * 27 * P + 4 * Cout * Cin * 9 + 2 * B * Cout * P
        b_ms, b_by, parts = roofline(flops, nbytes)
        nbytes32 = 4 * B * Cin * H * W + 4 * B * 27 * P + 4 * Cout * Cin * 9 + 4 * B * Cout * P
        b32_ms, b32_by, _ = roofline(flops, nbytes32, PEAK_FP32_FLOPS)
        wb = w.to(torch.bfloat16)
        t = {
            "kernel_ms": cuda_time_ms(lambda: dcn.modulated_deform_conv(x, om, w)),
            # the whole call (copy of x, weight repack, sigmoid) and the tensor-core kernel alone
            "device_ms": device_ms(torch, lambda: dcn.modulated_deform_conv(x, om, w), "deform_conv_fwd_tc"),
            "plain_ms": cuda_time_ms(lambda: dcn.modulated_deform_conv_reference(x, om, w), warmup=2, iters=10),
            "dense_conv_ms": cuda_time_ms(lambda: F.conv2d(x, wb, padding=1)),
            "dense_conv_device_ms": device_ms(torch, lambda: F.conv2d(x, wb, padding=1)),
            "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            "fp32_ms": cuda_time_ms(lambda: dcn.modulated_deform_conv(x32, om32, w32)),
            "fp32_device_ms": device_ms(torch, lambda: dcn.modulated_deform_conv(x32, om32, w32)),
            "fp32_plain_ms": cuda_time_ms(lambda: dcn.modulated_deform_conv_reference(x32, om32, w32),
                                          warmup=2, iters=10),
            "fp32_dense_conv_ms": cuda_time_ms(lambda: F.conv2d(x32, w32, padding=1)),
            "fp32_dense_conv_device_ms": device_ms(torch, lambda: F.conv2d(x32, w32, padding=1)),
            "fp32_bound_ms": b32_ms, "fp32_bound_by": b32_by,
        }
        timing[label] = t
        dev, tc_dev = t["device_ms"]
        log(f"  timing bf16 {label} x {tuple(x.shape)} -> {Cout}: kernel_ms {t['kernel_ms']:.4f}, plain_ms "
            f"{t['plain_ms']:.4f}, dense_conv_ms (cuDNN 3x3 conv at the shape, a floor, not DCNv2) "
            f"{t['dense_conv_ms']:.4f} (one call between CUDA events); device time: the call {dev:.4f} (the "
            f"tensor-core kernel {tc_dev:.4f}, the rest the channels-last copy of x, the weight repack and the "
            f"sigmoid), cuDNN {t['dense_conv_device_ms']:.4f}; "
            f"bound_ms {b_ms:.4f} ({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB; "
            f"{json.dumps({k: round(v, 5) for k, v in parts.items()})}), {flops / tc_dev / 1e9:.1f} TFLOP/s "
            f"[{card}]")
        log(f"  timing fp32 {label}: kernel_ms {t['fp32_ms']:.4f} (device time {t['fp32_device_ms']:.4f}), plain_ms "
            f"{t['fp32_plain_ms']:.4f}, dense_conv_ms (cuDNN fp32, TF32 off) {t['fp32_dense_conv_ms']:.4f} (device "
            f"{t['fp32_dense_conv_device_ms']:.4f}), bound_ms {b32_ms:.4f} ({b32_by}, at the fp32 peak) [{card}]")
    t3, t4 = timing["stage3"], timing["stage4"]
    bf16_rec = {
        "name": "deform_conv_fwd",
        "route": "cuda",
        "source": "petr_tpu_torch/csrc/deform_conv.cu",
        "replaces": "petr_tpu/ops/pallas/dcn.py:134::_dcn_pallas_raw",
        "launches": None,  # filled from the r50dcn serving run
        "max_abs_err": errs[("stage3", "bf16")],
        "floor_max_abs_err": errs[("stage3", "bf16", "floor")],
        "ms": t3["kernel_ms"],  # stage 3: 6 of the 9 calls of a forward
        "kernel_ms": t3["kernel_ms"],
        "plain_ms": t3["plain_ms"],
        "bound_ms": t3["bound_ms"],
        "bound_by": t3["bound_by"],
        "library_ms": None,  # no PyTorch call computes DCNv2
        "device_ms": t3["device_ms"][0],
        "tc_kernel_device_ms": t3["device_ms"][1],
        "dense_conv_ms": t3["dense_conv_ms"],
        "dense_conv_device_ms": t3["dense_conv_device_ms"],
        "stage4": {k: (v[0] if isinstance(v, tuple) else v) for k, v in t4.items() if not k.startswith("fp32")}
        | {"tc_kernel_device_ms": t4["device_ms"][1]},
    }
    fp32_rec = {
        "name": "deform_conv_fwd_fp32",
        "route": "cuda",
        "source": "petr_tpu_torch/csrc/deform_conv.cu",
        "replaces": "petr_tpu/ops/pallas/dcn.py:134::_dcn_pallas_raw",
        "launches": None,  # filled from the r50dcn fp32 train step
        "max_abs_err": errs[("stage3", "fp32")],
        "ms": t3["fp32_ms"],
        "plain_ms": t3["fp32_plain_ms"],
        "bound_ms": t3["fp32_bound_ms"],
        "bound_by": t3["fp32_bound_by"],
        "library_ms": None,
        "device_ms": t3["fp32_device_ms"],
        "dense_conv_ms": t3["fp32_dense_conv_ms"],
        "dense_conv_device_ms": t3["fp32_dense_conv_device_ms"],
        "stage4": {k[5:]: t4[k] for k in t4 if k.startswith("fp32")},
    }
    return bf16_rec, fp32_rec


# The synthetic recipes' shapes (phase 11; petr_tpu_torch/tools/synth_train_eval.py):
# batch 4 of 6 views at 128x320. The decoder (4 heads of 32, 64 queries)
# attends to the stride-16 level, L = 6 x 8 x 20 keys; synth_small_r50dcn's
# DCN convs run on 24 images at stride 16 (256 channels, 8x20) and 32 (512,
# 4x10). synth_small computes in fp32 (the CUDA-core variants),
# synth_small_r50dcn in bf16 (the tensor-core ones).
SYNTH_ATTN = dict(B=4, H=4, Q=64, L=6 * 8 * 20, D=32)
SYNTH_DCN = {"stage3": (24, 256, 8, 20, 256, 1), "stage4": (24, 512, 4, 10, 512, 1)}


def synth_attention_inputs(torch, gen, dtype, grid=False):
    """q/k/v at the synthetic decoder shape, as MultiheadAttention hands them
    over (``attention_inputs``); batch row 3's last view is padded (its 160
    keys masked), the others are not. ``grid`` as in ``attention_inputs``."""
    B, H, Q, L, D = (SYNTH_ATTN[k] for k in "BHQLD")

    def draw(n):
        t = torch.randn(B, n, H, D, generator=gen, device="cuda")
        if grid:
            t = (t * 8).round().clamp(-32, 32) / 8
        return t.to(dtype).transpose(1, 2)

    q, k, v = draw(Q), draw(L), draw(L)
    mask = torch.zeros(B, L, dtype=torch.bool, device="cuda")
    mask[3, L - 160:] = True
    return q, k, v, mask


def check_synth_shapes(torch, ca, dcn, sm_clock_hz, card):
    """K1 and K2 (fp32 and bf16) at the synthetic recipes' decoder shape,
    with dropout 0.1 and without, and the bf16 K4 at synth_small_r50dcn's
    two DCN shapes, each against its plain version as phase 3 holds the
    other shapes, then timed beside SDPA and cuDNN. Returns their records
    (launches filled from phase 11)."""
    import torch.nn.functional as F

    B, H, Q, L, D = (SYNTH_ATTN[k] for k in "BHQLD")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    log(f"phase 3: K1 and K2 at the synthetic recipes' decoder shape B={B} H={H} Q={Q} L={L} D={D}, "
        "fp32 (synth_small) and bf16 (synth_small_r50dcn), against their plain versions")
    errs, inputs = {}, {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        bf16 = tag == "bf16"
        q, k, v, m = synth_attention_inputs(torch, gen, dtype)
        inputs[tag] = (q, k, v, m)
        for rate in (0.0, DROPOUT):
            seed = DROP_SEED if rate else None
            before = (ca.LAUNCHES, ca.LAUNCHES_FP32)
            out, lse = ca.flash_cross_attention(q, k, v, m, rate, seed)
            torch.cuda.synchronize()
            assert (ca.LAUNCHES, ca.LAUNCHES_FP32) == (before[0] + bf16, before[1] + (not bf16)), (
                f"the {tag} call did not move its own launch counter alone")
            ref, ref_lse = ca.flash_cross_attention_reference(q, k, v, m, rate, seed)
            atol, rtol = K1_BF16_TOL if bf16 else K1_FP32_TOL
            err = (out.float() - ref.float()).abs()
            lse_err = (lse - ref_lse).abs().max().item()
            log(f"  K1 {tag}, rate {rate}: out max abs err {err.max().item():.3e} (atol {atol}, rtol {rtol}), "
                f"lse max abs err {lse_err:.3e} (tol 1e-3)")
            assert not (err > atol + rtol * ref.float().abs()).any() and lse_err <= 1e-3, f"K1 {tag} rate {rate}"
            errs[("K1", tag, rate)] = err.max().item()
            if bf16:
                qg, kg, vg, mg = synth_attention_inputs(torch, gen, dtype, grid=True)
                got, _ = ca.flash_cross_attention(qg, kg, vg, mg, rate, seed)
                floor, _ = ca.flash_cross_attention_reference(qg, kg, vg, mg, rate, seed, round_p=True)
                errs[("K1 floor", rate)] = kernel_compare(torch, f"K1 bf16, rate {rate}, vs its rounding floor "
                                                          "(inputs on a 1/8 grid)", got, floor, "bf16")
            gout = torch.randn(B, Q, H, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)
            delta = ca._delta(gout, ref, None)
            before = {"bf16": (ca.DKDV_LAUNCHES, ca.DQ_LAUNCHES), "fp32": (ca.DKDV_LAUNCHES_FP32, ca.DQ_LAUNCHES_FP32)}
            got = ca._backward_cuda(q, k, v, m, gout, ref_lse, delta, rate, DROP_SEED)
            torch.cuda.synchronize()
            after = {"bf16": (ca.DKDV_LAUNCHES, ca.DQ_LAUNCHES), "fp32": (ca.DKDV_LAUNCHES_FP32, ca.DQ_LAUNCHES_FP32)}
            other = "fp32" if bf16 else "bf16"
            assert after[tag] == (before[tag][0] + 1, before[tag][1] + 1) and after[other] == before[other], (
                f"the {tag} backward did not launch the {tag} variants: {before} -> {after}")
            want = ca.flash_cross_attention_backward_reference(q, k, v, m, ref, ref_lse, gout, None, rate, DROP_SEED)
            atol, rtol = BWD_TOL[tag]
            for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
                g, w = g.float(), w.float()
                e = (g - w).abs()
                log(f"  K2 {tag}, rate {rate}, {g_name}: max abs err {e.max().item():.3e} (max |ref| "
                    f"{w.abs().max().item():.3e}; atol {atol} x max|ref|, rtol {rtol})")
                assert not (e > atol * w.abs().max() + rtol * w.abs()).any(), f"K2 {tag} rate {rate} {g_name}"
                errs[("K2", tag, rate, g_name)] = e.max().item()

    log(f"phase 3: bf16 K4 at synth_small_r50dcn's DCN shapes against its plain versions")
    for label, (n, cin, h, w, cout, stride) in SYNTH_DCN.items():
        x, om, wt = dcn_inputs(torch, gen, n, cin, h, w, cout, stride, torch.bfloat16)
        inputs[label] = (x, om, wt)
        before = (dcn.LAUNCHES, dcn.LAUNCHES_FP32)
        out = dcn.modulated_deform_conv(x, om, wt, stride)
        torch.cuda.synchronize()
        assert (dcn.LAUNCHES, dcn.LAUNCHES_FP32) == (before[0] + 1, before[1]), "K4 bf16: the wrong counter moved"
        name = f"K4 bf16 {label} x {tuple(x.shape)} -> {cout}"
        floor = dcn.modulated_deform_conv_reference(x, om, wt, stride, operand_dtype=torch.bfloat16)
        errs[("K4 floor", label)] = kernel_compare(torch, f"{name} vs its rounding floor", out, floor, "bf16")
        r = dcn.modulated_deform_conv_reference(x, om, wt, stride).float()
        atol, rtol = OPERAND_TOL
        e = (out.float() - r).abs()
        log(f"  {name} vs the unrounded plain version: max abs err {e.max().item():.3e} (max |ref| "
            f"{r.abs().max().item():.3e}; atol {atol} x max|ref|, rtol {rtol})")
        assert not (e > atol * r.abs().max() + rtol * r.abs()).any(), f"{name}: out of OPERAND_TOL"
        errs[("K4", label)] = e.max().item()

    # timing: one call between CUDA events and the device time, beside the
    # plain version and the library call; the bounds from this run's inputs
    records = []
    for tag in ("bf16", "fp32"):
        q, k, v, m = inputs[tag]
        peak = PEAK_BF16_FLOPS if tag == "bf16" else PEAK_FP32_FLOPS
        e = q.element_size()
        pairs = H * Q * int((~m).sum())
        keep = ~m[:, None, None, :]
        fwd = lambda: ca.flash_cross_attention(q, k, v, m, DROPOUT, DROP_SEED)  # noqa: E731 (the train path's rate)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep)  # noqa: E731
        b_ms, b_by, parts = bound_ms(pairs, 4.0 * D, e * B * H * D * (2 * Q + 2 * L) + 4 * B * H * Q + B * L,
                                     sms, sm_clock_hz, peak)
        rec = {
            "name": "flash_cross_attention_fwd" + ("_fp32" if tag == "fp32" else "") + "_synth",
            "route": "cuda",
            "source": "petr_tpu_torch/csrc/flash_cross_attention.cu",
            "replaces": "petr_tpu/ops/pallas/cross_attention.py:62::_kernel",
            "launches": None,  # filled from phase 11
            "shape": dict(SYNTH_ATTN, unmasked=int((~m).sum()), dropout=DROPOUT),
            "max_abs_err": max(errs[("K1", tag, r)] for r in (0.0, DROPOUT)),
            "ms": cuda_time_ms(fwd),
            "device_ms": device_ms(torch, fwd),
            "rate0_ms": cuda_time_ms(lambda: ca.flash_cross_attention(q, k, v, m)),
            "plain_ms": cuda_time_ms(lambda: ca.flash_cross_attention_reference(q, k, v, m, DROPOUT, DROP_SEED),
                                     warmup=2, iters=10),
            "bound_ms": b_ms, "bound_by": b_by, "bound_parts": parts,
            "library_ms": cuda_time_ms(sdpa),  # SDPA, boolean mask, rate 0
            "library_device_ms": device_ms(torch, sdpa),
        }
        if tag == "bf16":
            rec["floor_max_abs_err"] = max(errs[("K1 floor", r)] for r in (0.0, DROPOUT))
        records.append(rec)
        gout = torch.randn(B, Q, H, D, generator=gen, device="cuda").to(q.dtype).transpose(1, 2)
        out, lse = ca.flash_cross_attention(q, k, v, m, DROPOUT, DROP_SEED)
        args = (q, k, v, m, gout, lse, ca._delta(gout, out, None))
        plain_ms = cuda_time_ms(lambda: ca.flash_cross_attention_backward_reference(
            q, k, v, m, out, lse, gout, None, DROPOUT, DROP_SEED), warmup=2, iters=10)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=keep)

        def sdpa_backward():
            torch.autograd.grad(sdpa_out, (qs, ks, vs), gout, retain_graph=True)
        lib_ms, lib_dev = cuda_time_ms(sdpa_backward), device_ms(torch, sdpa_backward)
        extra = 8 * B * H * Q + B * L  # lse, delta and mask bytes
        for which, flops, nbytes, grads in (
                ("dkdv", 8.0 * D, e * B * H * D * (2 * Q + 4 * L) + extra, ("dk", "dv")),
                ("dq", 6.0 * D, e * B * H * D * (3 * Q + 2 * L) + extra, ("dq",))):
            def call(which=which):
                ca._backward_cuda(*args, DROPOUT, DROP_SEED, kernels=(which,))
            b_ms, b_by, parts = bound_ms(pairs, flops, nbytes, sms, sm_clock_hz, peak)
            records.append({
                "name": f"flash_cross_attention_bwd_{which}" + ("_fp32" if tag == "fp32" else "") + "_synth",
                "route": "cuda",
                "source": "petr_tpu_torch/csrc/flash_cross_attention_bwd.cu",
                "replaces": "petr_tpu/ops/pallas/cross_attention.py:198::_bwd_kernel",
                "launches": None,  # filled from phase 11
                "shape": dict(SYNTH_ATTN, unmasked=int((~m).sum()), dropout=DROPOUT),
                "max_abs_err": max(errs[("K2", tag, r, g)] for r in (0.0, DROPOUT) for g in grads),
                "ms": cuda_time_ms(call),
                "device_ms": device_ms(torch, call),
                "plain_ms": plain_ms,  # the whole plain backward (dq, dk and dv)
                "bound_ms": b_ms, "bound_by": b_by, "bound_parts": parts,
                "library_ms": lib_ms,  # SDPA's whole backward, rate 0
                "library_device_ms": lib_dev,
            })
    for label, (n, cin, h, w, cout, stride) in SYNTH_DCN.items():
        x, om, wt = inputs[label]
        wb = wt.to(torch.bfloat16)
        P = h * w
        flops = 2.0 * n * P * cout * 9 * cin
        nbytes = 2 * n * cin * h * w + 4 * n * 27 * P + 4 * cout * cin * 9 + 2 * n * cout * P
        b_ms, b_by, parts = roofline(flops, nbytes)
        call = lambda: dcn.modulated_deform_conv(x, om, wt)  # noqa: E731
        dense = lambda: F.conv2d(x, wb, padding=1)  # noqa: E731
        records.append({
            "name": f"deform_conv_fwd_synth_{label}",
            "route": "cuda",
            "source": "petr_tpu_torch/csrc/deform_conv.cu",
            "replaces": "petr_tpu/ops/pallas/dcn.py:134::_dcn_pallas_raw",
            "launches": None,  # filled from phase 11
            "shape": {"x": [n, cin, h, w], "cout": cout},
            "max_abs_err": errs[("K4", label)],
            "floor_max_abs_err": errs[("K4 floor", label)],
            "ms": cuda_time_ms(call),
            "device_ms": device_ms(torch, call),
            "plain_ms": cuda_time_ms(lambda: dcn.modulated_deform_conv_reference(x, om, wt), warmup=2, iters=10),
            "bound_ms": b_ms, "bound_by": b_by, "bound_parts": parts,
            "library_ms": None,  # no PyTorch call computes DCNv2
            "dense_conv_ms": cuda_time_ms(dense),  # cuDNN's dense 3x3 conv at the shape: a floor, not DCNv2
            "dense_conv_device_ms": device_ms(torch, dense),
        })
    for rec in records:
        log(f"  timing {rec['name']}: ms {rec['ms']:.4f} (device {rec['device_ms']:.4f}), plain_ms "
            f"{rec['plain_ms']:.4f}, library_ms {rec['library_ms'] if rec['library_ms'] is None else round(rec['library_ms'], 4)}"
            + (f" (device {rec['library_device_ms']:.4f})" if "library_device_ms" in rec else "")
            + (f", dense conv {rec['dense_conv_ms']:.4f} (device {rec['dense_conv_device_ms']:.4f})"
               if "dense_conv_ms" in rec else "")
            + f", bound_ms {rec['bound_ms']:.5f} ({rec['bound_by']}) [{card}]")
    return records


# K5's shapes on the flagship's route: 6 views; (Cin, H, W, Co) and the
# launches per forward (petr_tpu_torch/models/vovnet.py: V-99-eSE's OSA blocks,
# whose first conv takes the block's input and the four others its own width).
# Phase 4 checks this table against the convs the route runs.
CONV_VIEWS = 6
CONV_SHAPES = {
    "s2": ((128, 80, 200, 128), 5),
    "s3 in256": ((256, 40, 100, 160), 1),
    "s3 in512": ((512, 40, 100, 160), 2),
    "s3": ((160, 40, 100, 160), 12),
    "s4 in512": ((512, 20, 50, 192), 1),
    "s4 in768": ((768, 20, 50, 192), 8),
    "s4": ((192, 20, 50, 192), 36),
    "s5 in768": ((768, 10, 25, 224), 1),
    "s5 in1024": ((1024, 10, 25, 224), 2),
    "s5": ((224, 10, 25, 224), 12),
}


def conv_inputs(torch, gen, C, H, W, Co, dtype, B=CONV_VIEWS):
    x = torch.randn(B, C, H, W, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(Co, C, 3, 3, generator=gen, device="cuda") * (2.0 / (9 * C)) ** 0.5).to(dtype)
    mul = torch.rand(Co, generator=gen, device="cuda") + 0.5
    add = torch.randn(Co, generator=gen, device="cuda") * 0.3
    return x, w, mul, add


def conv_shape_split(torch, conv, C, H, W, Co, B=CONV_VIEWS):
    """The split of K the bf16 K5 takes at this shape on this card."""
    th, tw = conv.conv_tile(H, W)
    blocks = -(-H // th) * -(-W // tw) * -(-Co // conv.TILE_CHANNELS) * B
    return conv.conv_split(blocks, -(-C // conv.CHUNK_CHANNELS),
                           torch.cuda.get_device_properties(0).multi_processor_count)


def check_conv3x3(torch, conv, card):
    """K5 against its plain version: the bf16 tensor-core kernel at every
    shape of the flagship's route, the fp32 CUDA-core kernel at stages 2 and
    4 and an odd shape, with and without the BN/ReLU epilogue at stages 2
    and 4; then the bf16 kernel timed at every shape beside cuDNN's
    ``F.conv2d`` (the conv alone: the library time leaves out the epilogue)
    and its bound, and summed over a forward's 80 launches; the fp32 kernel
    and the plain version timed at stage 4 (and 2)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    log("phase 3: conv3x3_bn_relu (K5) against its plain version")
    errs, inputs = {}, {}
    cases = [(label, shape, torch.bfloat16, "bf16") for label, (shape, _) in CONV_SHAPES.items()]
    cases += [(label, CONV_SHAPES[label][0], torch.float32, "fp32") for label in ("s2", "s4")]
    cases += [("odd", (13, 5, 7, 70), torch.float32, "fp32"), ("odd", (13, 5, 7, 70), torch.bfloat16, "bf16")]
    for label, (C, H, W, Co), dtype, tag in cases:
        x, w, mul, add = conv_inputs(torch, gen, C, H, W, Co, dtype, B=1 if label == "odd" else CONV_VIEWS)
        inputs[(label, tag)] = (x, w, mul, add)
        epilogues = ((True, True), (False, False)) if label in ("s2", "s4", "odd") else ((True, True),)
        for affine, relu in epilogues:
            m, a = (mul, add) if affine else (None, None)
            counter = "LAUNCHES" if tag == "bf16" else "LAUNCHES_FP32"
            before = (conv.LAUNCHES, conv.LAUNCHES_FP32)
            out = conv.conv3x3_bn_relu(x, w, m, a, relu)
            torch.cuda.synchronize()
            want_counts = (before[0] + (tag == "bf16"), before[1] + (tag == "fp32"))
            assert (conv.LAUNCHES, conv.LAUNCHES_FP32) == want_counts, f"{counter} did not count the launch"
            want = conv.conv3x3_bn_relu_reference(x, w, m, a, relu)
            errs[(label, tag, affine)] = kernel_compare(
                torch, f"{tag} {label} x {tuple(x.shape)} -> {Co}, epilogue {affine}", out, want, tag)

    log(f"phase 3: K5 timed at each shape of the route (bf16, {CONV_VIEWS} views, BN + ReLU epilogue): one "
        f"call between CUDA events, and the device time per call from the profiler")
    sums = ("kernel_ms", "device_ms", "library_ms", "library_device_ms", "bound_ms")
    shapes, route = [], dict.fromkeys(sums, 0.0) | {"launches": 0}
    for label, ((C, H, W, Co), per_forward) in CONV_SHAPES.items():
        x, w, mul, add = inputs[(label, "bf16")]
        flops = 2.0 * CONV_VIEWS * H * W * Co * 9 * C
        nbytes = 2 * CONV_VIEWS * C * H * W + 2 * Co * C * 9 + 8 * Co + 2 * CONV_VIEWS * Co * H * W
        b_ms, b_by, _ = roofline(flops, nbytes)

        def call():
            conv.conv3x3_bn_relu(x, w, mul, add, True)

        def library():
            F.conv2d(x, w, padding=1)
        k_ms = cuda_time_ms(call)
        # the conv kernel and its split-K reduction; the rest is the weight repack
        dev_ms, tc_ms = device_ms(torch, call, "conv3x3_bn_relu_tc")
        lib_ms, lib_dev_ms = cuda_time_ms(library), device_ms(torch, library)
        split = conv_shape_split(torch, conv, C, H, W, Co)
        shapes.append({"label": label, "cin": C, "h": H, "w": W, "co": Co, "tile": list(conv.conv_tile(H, W)),
                       "split_k": split, "launches_per_forward": per_forward, "kernel_ms": k_ms,
                       "device_ms": dev_ms, "tc_device_ms": tc_ms, "library_ms": lib_ms,
                       "library_device_ms": lib_dev_ms, "bound_ms": b_ms, "gflop": flops / 1e9})
        for key in sums:
            route[key] += per_forward * shapes[-1][key]
        route["launches"] += per_forward
        log(f"  {label:10s} {C:4d} -> {Co} at {H}x{W}, tile {conv.conv_tile(H, W)}, split K {split}, "
            f"x{per_forward} per forward: kernel_ms {k_ms:.4f}, library_ms (cuDNN F.conv2d, no epilogue) "
            f"{lib_ms:.4f} (one call between CUDA events); device time: kernel {dev_ms:.4f} (the conv and its "
            f"split-K reduction {tc_ms:.4f}, the rest the weight repack), cuDNN {lib_dev_ms:.4f}; bound_ms "
            f"{b_ms:.4f} ({b_by}; {flops / 1e9:.2f} GFLOP), {flops / tc_ms / 1e9:.1f} TFLOP/s [{card}]")
    log(f"  the route's {route['launches']} launches per forward: kernel {route['kernel_ms']:.4f} ms, cuDNN's convs "
        f"{route['library_ms']:.4f} ms (CUDA events); device time: kernel {route['device_ms']:.4f} ms, cuDNN's "
        f"convs {route['library_device_ms']:.4f} ms; bound {route['bound_ms']:.4f} ms [{card}]")
    assert route["launches"] == 80
    x, w, _, _ = inputs[("s4", "bf16")]
    wbig = inputs[("s5 in1024", "bf16")][1]
    repack_ms = device_ms(torch, lambda: conv.repack_weight(w))
    repack_big_ms = device_ms(torch, lambda: conv.repack_weight(wbig))
    log(f"  weight repack (OIHW -> (Co, 3, 3, Cp) bf16, inside each call above): {repack_ms:.4f} ms at 192 -> 192, "
        f"{repack_big_ms:.4f} ms at 1024 -> 224 [{card}]")

    timing = {}
    for label in ("s4", "s2"):
        (C, H, W, Co), _ = CONV_SHAPES[label]
        x, w, mul, add = inputs[(label, "bf16")]
        p_ms = cuda_time_ms(lambda: conv.conv3x3_bn_relu_reference(x, w, mul, add, True), warmup=2, iters=10)
        x32, w32, mul32, add32 = inputs[(label, "fp32")]
        f_ms = cuda_time_ms(lambda: conv.conv3x3_bn_relu(x32, w32, mul32, add32, True))
        f_dev_ms = device_ms(torch, lambda: conv.conv3x3_bn_relu(x32, w32, mul32, add32, True))
        f_plain_ms = cuda_time_ms(lambda: conv.conv3x3_bn_relu_reference(x32, w32, mul32, add32, True),
                                  warmup=2, iters=10)
        f_lib_ms = cuda_time_ms(lambda: F.conv2d(x32, w32, padding=1))
        flops = 2.0 * CONV_VIEWS * H * W * Co * 9 * C
        nbytes32 = 4 * CONV_VIEWS * C * H * W + 4 * Co * C * 9 + 8 * Co + 4 * CONV_VIEWS * Co * H * W
        f_bound, f_by, _ = roofline(flops, nbytes32, PEAK_FP32_FLOPS)
        timing[label] = {"plain_ms": p_ms, "fp32_ms": f_ms, "fp32_device_ms": f_dev_ms, "fp32_plain_ms": f_plain_ms,
                         "fp32_library_ms": f_lib_ms, "fp32_bound_ms": f_bound, "fp32_bound_by": f_by}
        log(f"  {label}: plain_ms (bf16) {p_ms:.4f}; fp32 kernel_ms {f_ms:.4f} (device time {f_dev_ms:.4f}), "
            f"plain_ms {f_plain_ms:.4f}, library_ms (cuDNN fp32, TF32 off) {f_lib_ms:.4f}, bound_ms {f_bound:.4f} "
            f"({f_by}, at the fp32 peak) [{card}]")
    s4 = next(r for r in shapes if r["label"] == "s4")
    s2 = next(r for r in shapes if r["label"] == "s2")
    b_ms, b_by, _ = roofline(s4["gflop"] * 1e9, 2 * CONV_VIEWS * 192 * 1000 * 2 + 2 * 192 * 192 * 9 + 8 * 192)
    bf16_rec = {
        "name": "conv3x3_bn_relu_fwd",
        "route": "cuda",
        "source": "petr_tpu_torch/csrc/conv3x3_bn_relu.cu",
        "replaces": "petr_tpu/ops/pallas/conv3x3.py:78::_conv3x3_raw",
        "launches": None,  # filled from the flagship's bf16 forward on the opt-in route
        "max_abs_err": max(v for (lab, tag, _), v in errs.items() if tag == "bf16"),
        "ms": s4["kernel_ms"],  # stage 4, 192 -> 192: 36 of the 80 launches of a forward
        "kernel_ms": s4["kernel_ms"],
        "plain_ms": timing["s4"]["plain_ms"],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": s4["library_ms"],  # cuDNN's conv alone, without the epilogue
        "device_ms": s4["device_ms"],
        "library_device_ms": s4["library_device_ms"],
        "stage2": {k: s2[k] for k in ("kernel_ms", "device_ms", "library_ms", "library_device_ms", "bound_ms")}
        | {"plain_ms": timing["s2"]["plain_ms"]},
        "shapes": shapes,
        "route_per_forward": route,
        "repack_device_ms": {"192->192": repack_ms, "1024->224": repack_big_ms},
    }
    fp32_rec = {
        "name": "conv3x3_bn_relu_fwd_fp32",
        "route": "cuda",
        "source": "petr_tpu_torch/csrc/conv3x3_bn_relu.cu",
        "replaces": "petr_tpu/ops/pallas/conv3x3.py:78::_conv3x3_raw",
        "launches": None,  # filled from the flagship's fp32 forward on the opt-in route
        "max_abs_err": max(v for (lab, tag, _), v in errs.items() if tag == "fp32"),
        "ms": timing["s4"]["fp32_ms"],
        "plain_ms": timing["s4"]["fp32_plain_ms"],
        "bound_ms": timing["s4"]["fp32_bound_ms"],
        "bound_by": timing["s4"]["fp32_bound_by"],
        "library_ms": timing["s4"]["fp32_library_ms"],
        "device_ms": timing["s4"]["fp32_device_ms"],
        "stage2_ms": timing["s2"]["fp32_ms"],
    }
    return bf16_rec, fp32_rec


def make_cams(B, N, H=320, W=800):
    """img2lidar of N outward-facing pinhole cameras around the ego car, for
    H x W images (focal length W, principal point at the centre)."""
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
            K[0, 0] = K[1, 1] = float(W)
            K[0, 2], K[1, 2] = W / 2.0, H / 2.0
            mats[b, i] = K @ E
    return np.linalg.inv(mats).astype(np.float32)


def view_cams(cfg, B=1, ego_shift=2.0):
    """img2lidar (B, N, 4, 4) of a config's views: ``make_cams``' 6 cameras,
    and for a 2-frame config (PETRv2) the same 6 again for the previous
    frame, expressed in the current frame's lidar coordinates: the ego car
    drove ``ego_shift`` metres forward in between."""
    import numpy as np

    H, W = cfg.data.image_size
    cams = make_cams(B, cfg.data.num_views, H, W)
    if cfg.data.num_frames == 1:
        return cams
    prev_to_cur = np.eye(4, dtype=np.float32)
    prev_to_cur[0, 3] = -ego_shift
    return np.concatenate([cams, prev_to_cur @ cams], axis=1).astype(np.float32)


def frame_timestamps(rng, B=1, dt=0.5):
    """(B, 12) lidar-relative timestamps: the current 6 views within 20 ms
    of 0, the previous frame's 6 ``dt`` seconds later in the data layer's
    convention (`petr_tpu/serve/streaming.py::self_padded_timestamp`)."""
    import numpy as np

    cur = rng.uniform(-0.02, 0.02, (B, 6))
    return np.concatenate([cur, cur + dt], axis=1).astype(np.float32)


def make_requests(cfg, n=3):
    """``n`` serving requests drawn from SEED; request 1 has two views padded
    (their tokens are masked in the decoder). A 2-frame config's requests
    hold 12 views and their timestamps."""
    import numpy as np

    N = cfg.data.num_views * cfg.data.num_frames
    H, W = cfg.data.image_size
    rng = np.random.RandomState(SEED)
    requests = []
    for r in range(n):
        img_hw = np.tile(np.array([H, W], np.float32), (N, 1))
        if r == 1:
            img_hw[2] = [H - 32, W - 96]
            img_hw[4] = [H, W - 160]
        req = {
            "images": rng.randn(N, H, W, 3).astype(np.float32),
            "img2lidar": view_cams(cfg)[0],
            "img_hw": img_hw,
        }
        if cfg.data.num_frames > 1:
            req["timestamp"] = frame_timestamps(rng)[0]
        requests.append(req)
    return requests


def forward(model, args):
    """The detector on the serving inputs (images, img2lidar, img_hw[,
    timestamp]) as tensors."""
    return model(*args[:3], timestamp=args[3] if len(args) > 3 else None)


def compare_outputs(torch, what, a_out, b_out, tol, mean_tol, shape):
    """cls_logits and bbox_codes of two runs: finite, of ``shape`` (but the
    last axis), each output within atol + rtol * |ref|, and the mean error
    within ``mean_tol``. ``tol`` maps each key to (atol, rtol)."""
    for key in ("cls_logits", "bbox_codes"):
        a, b = a_out[key].float(), b_out[key].float()
        assert a.shape[:-1] == shape, (key, a.shape, shape)
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), key
        atol, rtol = tol[key]
        err = (a - b).abs()
        log(f"  {key}, {what}: max abs err {err.max().item():.4e}, mean {err.mean().item():.4e}, "
            f"max |value| {b.abs().max().item():.4e} (atol {atol}, rtol {rtol}, mean {mean_tol})")
        assert (err <= atol + rtol * b.abs()).all(), f"{key}: {what} disagree"
        assert err.mean().item() <= mean_tol, f"{key}: {what} disagree on average"


def serve_and_check(torch, cfg, model, counters, per_forward, plain_routes, tol, mean_tol, card):
    """Serve ``make_requests`` through ``InferenceServer`` at batch 2 and
    check launches, outputs and, where ``plain_routes`` names any, the
    outputs on the plain route. ``counters`` maps a kernel label to (module, count name),
    ``per_forward`` to its launches per forward; ``plain_routes`` lists
    (module, attribute, plain function) to swap in for the comparison.
    Returns (launches, the padded request's inputs on the card, the
    serving function, the served results)."""
    import numpy as np

    from petr_tpu_torch.serve import InferenceServer, make_serving_fn, serving_input_spec

    fn = make_serving_fn(cfg, model, device="cuda")
    requests = make_requests(cfg)
    keys = tuple(serving_input_spec(cfg))
    forwards = 0

    def counted(*args):
        nonlocal forwards
        forwards += 1
        return fn(*args)

    fn(*[np.stack([requests[0][k]] * 2) for k in keys])  # warm up
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    with InferenceServer(counted, batch_size=2, input_keys=keys, max_delay_ms=50.0) as server:
        futures = [server.submit(req) for req in requests]
        results = [f.result(timeout=600) for f in futures]
    serve_s = time.perf_counter() - t0
    launches = {label: getattr(mod, attr) for label, (mod, attr) in counters.items()}
    want = {label: per_forward[label] * forwards for label in counters}
    log(f"  {len(requests)} requests in {forwards} batches in {serve_s:.3f} s; launches {launches} "
        f"(expected {want}: per forward {per_forward})")
    assert forwards == 2, f"3 requests at batch 2 should take 2 batches, took {forwards}"
    assert launches == want, (launches, want)

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
        direct = fn(*[np.stack([req[k]] * 2) for k in keys])
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

    # the same model and weights with each kernel's call routed to its plain version
    args = [torch.as_tensor(np.stack([requests[1][k]])).cuda() for k in keys]
    if not plain_routes:
        return launches, args, fn, results
    with torch.inference_mode():
        out_k = forward(model, args)
        kept = [getattr(mod, attr) for mod, attr, _ in plain_routes]
        for mod, attr, plain in plain_routes:
            setattr(mod, attr, plain)
        try:
            out_plain = forward(model, args)
        finally:
            for (mod, attr, _), fn_kept in zip(plain_routes, kept):
                setattr(mod, attr, fn_kept)
    hc = cfg.model.head
    routed = ", ".join(f"{m.__name__.split('.')[-1]}.{a}" for m, a, _ in plain_routes)
    compare_outputs(torch, f"kernels vs plain versions of {routed} (padded views)", out_k, out_plain,
                    tol, mean_tol, (hc.num_layers, 1, hc.num_query))
    return launches, args, fn, results


def serving_latency(torch, cfg, model, fn, results, card):
    """B=1 latency of the serving step (host clock), the forward alone on
    CUDA events, and one profiler pass -> (forward ms, B=1 inputs)."""
    import numpy as np

    from petr_tpu_torch.serve import serving_input_spec

    N = cfg.data.num_views * cfg.data.num_frames
    H, W = cfg.data.image_size
    one = [np.stack([make_requests(cfg, 1)[0][k]]) for k in serving_input_spec(cfg)]
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
        fwd_ms = cuda_time_ms(lambda: forward(model, one_t), warmup=2, iters=10)
    log(f"  serving step at B=1 ({N} views {H}x{W}): median {med * 1e3:.2f} ms over "
        f"{len(lat)} runs (host clock), {1.0 / med:.2f} samples/s; forward alone "
        f"{fwd_ms:.2f} ms (CUDA events, median of 10) [{card}]")
    dev_ms, per_kernel = profile(torch, lambda: forward(model, one_t), card)
    return fwd_ms, dev_ms, one_t, per_kernel


def check_serving(torch, ca, conv, card):
    import dataclasses
    import os

    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.models import PETRDetector, layers
    from petr_tpu_torch.serve import build_detector

    cfg = get_config(FLAGSHIP)
    log(f"phase 4: {FLAGSHIP} serving at full width, random weights (seed {SEED}), "
        f"{cfg.model.compute_dtype}")
    t0 = time.perf_counter()
    model = build_detector(cfg, seed=SEED, device="cuda")
    nparams = sum(p.numel() for p in model.parameters())
    log(f"  model built in {time.perf_counter() - t0:.1f} s: {nparams} parameters, "
        f"{cfg.model.head.num_layers} decoder layers, {cfg.model.backbone.spec}")
    L = cfg.model.head.num_layers
    model_tol = {"cls_logits": (MODEL_ATOL, MODEL_RTOL), "bbox_codes": (MODEL_ATOL, MODEL_RTOL)}
    launches, _, fn, results = serve_and_check(
        torch, cfg, model, {"K1": (ca, "LAUNCHES"), "K1 fp32": (ca, "LAUNCHES_FP32")}, {"K1": L, "K1 fp32": 0},
        [(layers, "flash_cross_attention", ca.flash_cross_attention_reference)], model_tol, MODEL_MEAN, card)
    fwd_ms, dev_ms, one_t, _ = serving_latency(torch, cfg, model, fn, results, card)

    # the opt-in route: every OSA conv through K5, against the default (cuDNN)
    osa = 5 * sum(len(getattr(model.img_backbone, f"stage{s}")) for s in range(2, 6))
    log(f"phase 4: the same model with {conv.CONV_IMPL_ENV}=cuda (K5 on the {osa} OSA 3x3 convs; "
        f"the stem stays on cuDNN)")
    assert osa == 80, osa
    hc = cfg.model.head
    seen = []

    def recording(x, w, *args, **kwargs):
        seen.append((tuple(x.shape), w.shape[0]))
        return conv_fn(x, w, *args, **kwargs)

    conv_fn = layers.conv3x3_bn_relu
    with torch.inference_mode():
        out_cudnn = model(*one_t)
        os.environ[conv.CONV_IMPL_ENV] = "cuda"
        try:
            layers.conv3x3_bn_relu = recording
            model(*one_t)
            layers.conv3x3_bn_relu = conv_fn
            want = sorted(((CONV_VIEWS, C, H, W), Co) for (C, H, W, Co), n in CONV_SHAPES.values() for _ in range(n))
            assert sorted(seen) == want, f"the route's convs differ from CONV_SHAPES: {sorted(seen)}"
            conv.LAUNCHES = conv.LAUNCHES_FP32 = conv.SPLITK_LAUNCHES = 0
            out_k5 = model(*one_t)
            k5_per_forward, splitk_per_forward = conv.LAUNCHES, conv.SPLITK_LAUNCHES
            want_split = sum(n for (C, H, W, Co), n in CONV_SHAPES.values()
                             if conv_shape_split(torch, conv, C, H, W, Co) > 1)
            log(f"  K5 launches in one bf16 forward: {k5_per_forward} of the tensor-core kernel (expected {osa}, "
                f"every shape of CONV_SHAPES), {splitk_per_forward} of them with a split K and its ordered "
                f"reduction (expected {want_split}), {conv.LAUNCHES_FP32} of the fp32 one (expected 0)")
            assert (k5_per_forward, splitk_per_forward, conv.LAUNCHES_FP32) == (osa, want_split, 0), (
                k5_per_forward, splitk_per_forward, conv.LAUNCHES_FP32)
            compare_outputs(torch, "K5 route vs cuDNN route (B=1)", out_k5, out_cudnn, ROUTE_TOL, ROUTE_MEAN,
                            (hc.num_layers, 1, hc.num_query))
            k5_dev_ms, k5_shares = profile(torch, lambda: model(*one_t), card)
        finally:
            layers.conv3x3_bn_relu = conv_fn
            os.environ.pop(conv.CONV_IMPL_ENV)
        walls = alternating_forwards(torch, model, one_t, conv.CONV_IMPL_ENV)
    verdict = "wins" if k5_dev_ms < dev_ms else "loses"
    log(f"  device time per B=1 forward: K5 route {k5_dev_ms:.3f} ms (K5 itself {k5_shares.get('K5', 0.0):.3f} ms), "
        f"cuDNN route {dev_ms:.3f} ms: the K5 route {verdict} by {abs(dev_ms - k5_dev_ms):.3f} ms [{card}]")
    faster = sum(a < b for a, b in zip(walls["cuda"], walls["cudnn"]))
    wall = {r: statistics.median(t) for r, t in walls.items()}
    verdict = {len(walls["cuda"]): "wins", 0: "loses"}.get(faster, "is unresolved: the pairs disagree")
    log(f"  forward at B=1 on CUDA events, the routes alternated {len(walls['cuda'])} times (median of 3 calls "
        f"each): K5 route median {wall['cuda']:.2f} ms (" + ", ".join(f"{t:.2f}" for t in walls["cuda"])
        + f"), cuDNN route median {wall['cudnn']:.2f} ms (" + ", ".join(f"{t:.2f}" for t in walls["cudnn"])
        + f"); the K5 route is faster in {faster} of {len(walls['cuda'])} pairs: by the wall clock the route {verdict} "
        f"[{card}]")

    # the fp32 twin on both routes: the fp32 variant of K5 on the route
    model32 = PETRDetector(dataclasses.replace(cfg.model, compute_dtype="float32")).cuda().eval()
    model32.load_state_dict(model.state_dict())
    with torch.inference_mode():
        out32 = model32(*one_t)
        os.environ[conv.CONV_IMPL_ENV] = "cuda"
        try:
            conv.LAUNCHES = conv.LAUNCHES_FP32 = ca.LAUNCHES = ca.LAUNCHES_FP32 = 0
            out32_k5 = model32(*one_t)
            k5_fp32_per_forward = conv.LAUNCHES_FP32
        finally:
            os.environ.pop(conv.CONV_IMPL_ENV)
    log(f"  fp32 twin on the route: {k5_fp32_per_forward} launches of K5's fp32 kernel, {conv.LAUNCHES} of the "
        f"bf16 one (expected {osa} and 0); K1 fp32 {ca.LAUNCHES_FP32}, bf16 {ca.LAUNCHES} (expected {L} and 0)")
    assert k5_fp32_per_forward == osa and conv.LAUNCHES == 0
    assert (ca.LAUNCHES_FP32, ca.LAUNCHES) == (L, 0)
    compare_outputs(torch, "fp32 K5 route vs fp32 cuDNN route (B=1)", out32_k5, out32, FP32_ROUTE_TOL,
                    FP32_ROUTE_MEAN, (hc.num_layers, 1, hc.num_query))
    del model32
    return launches["K1"], k5_per_forward, k5_fp32_per_forward, {
        "splitk_launches": splitk_per_forward,
        "forward_ms_cudnn": walls["cudnn"], "forward_ms_k5": walls["cuda"], "forward_device_ms_cudnn": dev_ms,
        "forward_device_ms_k5": k5_dev_ms, "k5_device_ms_per_forward": k5_shares.get("K5", 0.0)}


def alternating_forwards(torch, model, args, env, rounds=8):
    """The B=1 forward on the cuDNN route and on the K5 route (``env`` set to
    "cuda"), alternated ``rounds`` times, each time the median of 3 calls
    between CUDA events -> {"cudnn": [ms], "cuda": [ms]}. The forward is
    host-bound, and the host's speed drifts within a run by more than the
    routes differ, so the routes are compared pair by pair."""
    import os

    walls = {"cudnn": [], "cuda": []}
    for _ in range(rounds):
        for route in walls:
            if route == "cuda":
                os.environ[env] = "cuda"
            try:
                walls[route].append(cuda_time_ms(lambda: model(*args), warmup=1, iters=3))
            finally:
                os.environ.pop(env, None)
    return walls


# kernel names in a profile (each prefix takes both variants of K1, K2, K4 and K5)
KERNEL_NAMES = {"K1": "flash_fwd", "K2 dK/dV": "flash_bwd_dkdv", "K2 dQ": "flash_bwd_dq",
                "K4": "deform_conv_fwd", "K5": "conv3x3_bn_relu", "K6": "conv_int8_kernel",
                "K6 quant": "quantize_act_kernel"}


def profile(torch, fn, card, iters=5, unit="forward", inference=True):
    """Device time per call of ``fn`` by kernel, from one torch.profiler pass
    -> (device ms per call, {kernel label: its ms per call})."""
    rows, wall_ms = profiled_kernels(torch, fn, iters, inference)
    dev_ms = sum(r[0] for r in rows)
    shares, per_kernel = [], {}
    for label, kname in KERNEL_NAMES.items():
        k_ms = sum(r[0] for r in rows if kname in r[2])
        if k_ms > 0:
            per_kernel[label] = k_ms
            shares.append(f"{label} {k_ms:.3f} ms per {unit} ({100 * k_ms / dev_ms:.1f}% of device time)")
    log(f"  profile of {iters} B=1 {unit}s: device time {dev_ms:.3f} ms per {unit} in "
        f"{sum(r[1] for r in rows)} launches of {len(rows)} kernel names; device busy "
        f"{100 * dev_ms * iters / wall_ms:.1f}% of the traced window ({wall_ms / iters:.3f} ms "
        f"per {unit} under the profiler); {'; '.join(shares)} [{card}]")
    log(f"    ms/{unit}  calls/{unit}  kernel")
    for ms, calls, name in rows[:12]:
        log(f"    {ms:7.3f}  {calls:9d}  {name[:100]}")
    return dev_ms, per_kernel


def make_train_batch(cfg, seed, valid_gt=40):
    """One synthetic batch of one sample, drawn from ``seed`` with numpy: 6
    normalised views (12 and their timestamps for a 2-frame config),
    ``view_cams`` cameras, ``max_gt`` GT rows of which ``valid_gt`` are
    real: centres inside pc_range, positive sizes, any yaw, small
    velocities, labels in [0, num_classes)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    N, (H, W), G = cfg.data.num_views * cfg.data.num_frames, cfg.data.image_size, cfg.data.max_gt
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
    batch = {
        "images": rng.randn(1, N, H, W, 3).astype(np.float32),
        "img2lidar": view_cams(cfg),
        "img_hw": np.tile(np.array([H, W], np.float32), (1, N, 1)),
        "gt_boxes": boxes[None],
        "gt_labels": labels[None].astype(np.int64),
        "gt_valid": valid[None],
    }
    if cfg.data.num_frames > 1:
        batch["timestamp"] = frame_timestamps(rng)
    return batch


def compare_steps(torch, name, a, b, loss_rtol, grad_rtol, floor=None):
    """Two grad_fn results (total, losses, grads, assignment, BN moments): the assignment
    equal, the loss and every gradient within the stated tolerances. With
    ``floor`` (the per-parameter errors of a step whose input was nudged by
    one ulp, from an earlier call) the worst gradient may differ by up to
    NUDGE_MARGIN x the floor's worst, and the median must stay within
    ``grad_rtol``. Returns each parameter's error."""
    import numpy as np

    (ta, _, ga, ia, _), (tb, _, gb, ib, _) = a, b
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
    median = statistics.median(rel.values())
    limit = grad_rtol if floor is None else max(grad_rtol, NUDGE_MARGIN * max(floor.values()))
    log(f"  {name}: assignments equal ({ia.size} GT rows over layers), loss {ta.item():.6f} vs "
        f"{tb.item():.6f} (relative error {loss_err:.2e}, tol {loss_rtol}); gradients of {len(rel)} "
        f"parameters (largest entry {top:.3e}), max abs err / max(max |grad|, {STEP_GRAD_FLOOR} x largest): "
        f"median {median:.2e}, worst "
        + ", ".join(f"{n} {r:.2e} (err {raw[n][0]:.2e}, max |grad| {raw[n][1]:.2e}"
                    + ("" if floor is None else f"; the floor there {floor[n]:.2e}") + ")" for n, r in worst)
        + f" (tol {limit:.2e}" + ("" if floor is None else f", median tol {grad_rtol}") + ")")
    assert loss_err <= loss_rtol, f"{name}: loss differs by {loss_err:.3e}"
    assert worst[0][1] <= limit, f"{name}: gradient {worst[0][0]} differs by {worst[0][1]:.3e}"
    assert median <= grad_rtol, f"{name}: the median gradient differs by {median:.3e}"
    return rel


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
    ca.LAUNCHES = ca.DKDV_LAUNCHES = ca.DQ_LAUNCHES = ca.DKDV_LAUNCHES_FP32 = ca.DQ_LAUNCHES_FP32 = 0
    ca.LAUNCHES_FP32 = 0
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
    launches = {"K1": ca.LAUNCHES, "K2 dK/dV": ca.DKDV_LAUNCHES, "K2 dQ": ca.DQ_LAUNCHES,
                "K1 fp32": ca.LAUNCHES_FP32, "K2 dK/dV fp32": ca.DKDV_LAUNCHES_FP32,
                "K2 dQ fp32": ca.DQ_LAUNCHES_FP32}
    L = mc.head.num_layers
    want = {"K1": 2 * L * n_timed, "K2 dK/dV": L * n_timed, "K2 dQ": L * n_timed,
            "K1 fp32": 0, "K2 dK/dV fp32": 0, "K2 dQ fp32": 0}
    log(f"  {n_timed} timed steps: kernel launches {launches} (expected {want}: per step {L} "
        f"forward + {L} recompute for bf16 K1, {L} for each bf16 K2 kernel, none of the fp32 ones)")
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
    dev_ms, per_kernel = profile(torch, one_step, card, iters=2, unit="step", inference=False)
    log(f"  device busy without the profiler: {100 * dev_ms / med:.1f}% of the median step "
        f"({dev_ms:.3f} ms of device time in {med:.2f} ms) [{card}]")
    k2_ms = per_kernel.get("K2 dK/dV", 0.0) + per_kernel.get("K2 dQ", 0.0)
    log(f"  K2 (dK/dV + dQ) per step: {k2_ms:.3f} ms of device time [{card}]")

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

    ca.LAUNCHES = ca.DKDV_LAUNCHES = ca.DQ_LAUNCHES = ca.DKDV_LAUNCHES_FP32 = ca.DQ_LAUNCHES_FP32 = 0
    ca.LAUNCHES_FP32 = 0

    def fp32_counts():
        return (ca.LAUNCHES_FP32, ca.DKDV_LAUNCHES_FP32, ca.DQ_LAUNCHES_FP32, ca.LAUNCHES, ca.DKDV_LAUNCHES,
                ca.DQ_LAUNCHES)

    with_kernels = grads_of(model32)
    log(f"  fp32 step: K1 fp32, K2 dK/dV fp32, K2 dQ fp32, K1 bf16, K2 dK/dV bf16, K2 dQ bf16 launches "
        f"{fp32_counts()} (expected {(2 * L, L, L, 0, 0, 0)})")
    assert fp32_counts() == (2 * L, L, L, 0, 0, 0), fp32_counts()
    fp32_launches = fp32_counts()[:3]
    plain = grads_of(model32, plain=True)
    assert fp32_counts() == (2 * L, L, L, 0, 0, 0), "the plain route launched a kernel"
    compare_steps(torch, "kernels vs plain versions (remat on)", with_kernels, plain,
                  STEP_LOSS_RTOL, STEP_GRAD_RTOL)
    del plain, model32
    cfg_nr = dataclasses.replace(cfg32, model=dataclasses.replace(cfg32.model, remat=False))
    no_remat = grads_of(create_train_state(cfg_nr, SEED, 1000, device="cuda").model)
    compare_steps(torch, "remat on vs remat off (kernels)", with_kernels, no_remat,
                  STEP_LOSS_RTOL, STEP_GRAD_RTOL)
    return launches, fp32_launches


def normalize_bn_statistics(torch, model, *inputs) -> int:
    """Set every frozen BN's running statistics to the per-channel mean and
    variance (fp32, over batch and plane) of what reaches it in one eval
    forward of ``model`` on ``inputs``; returns how many BNs it set. Each
    BN's statistics are set just before it runs, so the later ones see the
    normalised activations, as a trained network's BNs would."""
    from petr_tpu_torch.models.layers import FrozenBatchNorm

    def set_stats(module, args) -> None:
        x = args[0].float()
        module.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        module.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    norms = [m for m in model.modules() if isinstance(m, FrozenBatchNorm)]
    handles = [m.register_forward_pre_hook(set_stats) for m in norms]
    training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(*inputs)
    finally:
        for h in handles:
            h.remove()
        model.train(training)
    return len(norms)


def r50_random_weights(torch, cfg, model, weight_std=0.15):
    """Redraw the offset convs (``init_weights`` zeroes them, which leaves
    every offset 0 and every mask 0.5) and normalise the BN statistics on
    one request (``normalize_bn_statistics``: at 0 / 1 the features reach
    |x| ~ 1000 and the decoder's attention turns nearly one-hot, so a
    last-bit change tips whole queries). The offsets are a per-tap shift
    of up to 3 pixels plus a per-pixel part of about 0.1 pixel (weight_std
    0.15 at an input rms near 0.7): the offset path feeds a change of a
    DCN's input back into its sampling positions, and at a per-pixel part
    of 1 pixel the 9 DCN bottlenecks amplified a relative change of 1e-6
    at each K4 call to 1.3e-3 (relative L2) at C5 in fp32. With
    ``weight_std=0`` every offset and mask is its tap's bias alone, the
    same at every pixel and on every route. Returns the number of offset
    convs drawn."""
    from petr_tpu_torch.models import resnet

    drawn = resnet.redraw_offset_convs(model, SEED + 1, weight_std=weight_std)
    images = torch.as_tensor(make_requests(cfg, 1)[0]["images"]).cuda()  # (N, H, W, 3)
    # every BN is in the backbone: its input as extract_feats gives it
    normalize_bn_statistics(torch, model.img_backbone, images.permute(0, 3, 1, 2).contiguous().to(model.dtype))
    return drawn


def check_r50_serving(torch, ca, dcn, card):
    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.models import resnet
    from petr_tpu_torch.serve import build_detector

    cfg = get_config(R50)
    log(f"phase 6: {R50} serving at full width, random weights (seed {SEED}, offset convs redrawn "
        f"from seed {SEED + 1}, BN statistics normalised on one request), {cfg.model.compute_dtype}")
    t0 = time.perf_counter()
    model = build_detector(cfg, seed=SEED, device="cuda")
    drawn = r50_random_weights(torch, cfg, model)
    nparams = sum(p.numel() for p in model.parameters())
    log(f"  model built in {time.perf_counter() - t0:.1f} s: {nparams} parameters, ResNet-50 with "
        f"{drawn} DCN convs (stages {cfg.model.backbone.dcn_stages}), {cfg.model.head.num_layers} decoder "
        f"layers, {cfg.data.num_views} views of {cfg.data.image_size}")
    assert drawn == 9
    launches, args, fn, results = serve_and_check(
        torch, cfg, model, {"K4": (dcn, "LAUNCHES"), "K1": (ca, "LAUNCHES"), "K4 fp32": (dcn, "LAUNCHES_FP32"),
                            "K1 fp32": (ca, "LAUNCHES_FP32")},
        {"K4": 9, "K1": cfg.model.head.num_layers, "K4 fp32": 0, "K1 fp32": 0}, [], None, None, card)
    check_r50_routes(torch, cfg, model, dcn, resnet, args)
    fwd_ms, _, _, _ = serving_latency(torch, cfg, model, fn, results, card)
    del model
    torch.cuda.empty_cache()

    # the no-neck preset: the same backbone at the same shape, the head on C5
    c5 = get_config(R50_C5)
    H, W = c5.data.image_size
    log(f"phase 6: {R50_C5} serving at full width (no neck: the head reads C5, L = {c5.data.num_views} x "
        f"{H // 32} x {W // 32} = {c5.data.num_views * (H // 32) * (W // 32)} decoder keys), random weights as above")
    model = build_detector(c5, seed=SEED, device="cuda")
    assert r50_random_weights(torch, c5, model) == 9 and model.img_neck is None
    c5_launches, _, fn, results = serve_and_check(
        torch, c5, model, {"K4": (dcn, "LAUNCHES"), "K1": (ca, "LAUNCHES"), "K4 fp32": (dcn, "LAUNCHES_FP32"),
                           "K1 fp32": (ca, "LAUNCHES_FP32")},
        {"K4": 9, "K1": c5.model.head.num_layers, "K4 fp32": 0, "K1 fp32": 0}, [], None, None, card)
    c5_ms, c5_dev_ms, _, c5_kernels = serving_latency(torch, c5, model, fn, results, card)
    del model
    torch.cuda.empty_cache()
    return launches, fwd_ms, {"launches_r50_c5": c5_launches["K4"], "r50_c5_forward_ms": c5_ms,
                              "r50_c5_forward_device_ms": c5_dev_ms,
                              "r50_c5_k4_device_ms_per_forward": c5_kernels.get("K4")}


def check_r50_routes(torch, cfg, model, dcn, resnet, args):
    """The model with K4 against the same weights with K4's call routed to
    its plain version, in bf16 (as served) and in an fp32 twin.

    Inside the model each bf16 K4 call differs from the plain version by
    one bf16 step in a few outputs, and that flips the later layers'
    rounding. So: in fp32, the backbone's features within R50_FP32_FEAT in
    relative L2 (the DCN convs feed each call's rounding into the next
    one's sampling points) and the head's outputs within R50_FP32_MEAN on
    average; in bf16, each output within ROUTE_TOL, and the mean error
    within ROUTE_MEAN and within 1.5x the plain bf16 model's own mean
    distance from the fp32 one."""
    import dataclasses

    from petr_tpu_torch.models import PETRDetector

    model32 = PETRDetector(dataclasses.replace(cfg.model, compute_dtype="float32")).cuda().eval()
    model32.load_state_dict(model.state_dict())
    N, (H, W) = cfg.data.num_views, cfg.data.image_size
    outs, feats = {}, {}
    with torch.inference_mode():
        for dtype, m in (("bf16", model), ("fp32", model32)):
            x = args[0].reshape(N, H, W, 3).permute(0, 3, 1, 2).contiguous().to(m.dtype)
            for route in ("K4", "plain"):
                if route == "plain":
                    resnet.modulated_deform_conv = dcn.modulated_deform_conv_plain
                dcn.LAUNCHES = dcn.LAUNCHES_FP32 = 0
                try:
                    outs[(dtype, route)] = m(*args)
                    feats[(dtype, route)] = m.img_backbone(x)
                finally:
                    resnet.modulated_deform_conv = dcn.modulated_deform_conv
                # two passes over the backbone: 18 launches of the dtype's variant on the K4 route, none on the plain
                want = (18 * (dtype == "bf16"), 18 * (dtype == "fp32")) if route == "K4" else (0, 0)
                assert (dcn.LAUNCHES, dcn.LAUNCHES_FP32) == want, (dtype, route, dcn.LAUNCHES, dcn.LAUNCHES_FP32)
    for i, (a, b) in enumerate(zip(feats[("fp32", "K4")], feats[("fp32", "plain")])):
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        rel = ((a - b).norm() / b.norm()).item()
        log(f"  fp32 backbone output {i} {tuple(a.shape)}, K4 vs plain: relative L2 error {rel:.4e} (tol "
            f"{R50_FP32_FEAT}), max abs err {err:.4e} (max |value| {scale:.4e})")
        assert rel <= R50_FP32_FEAT, f"backbone output {i}: K4 and its plain version disagree in fp32"
    hc = cfg.model.head
    for key in ("cls_logits", "bbox_codes"):
        def dist(a, b):
            e = (outs[a][key].float() - outs[b][key].float()).abs()
            return e, e.max().item(), e.mean().item()

        e32, max32, mean32 = dist(("fp32", "K4"), ("fp32", "plain"))
        e16, max16, mean16 = dist(("bf16", "K4"), ("bf16", "plain"))
        _, max_floor, floor = dist(("bf16", "plain"), ("fp32", "plain"))
        ref = outs[("bf16", "plain")][key].float()
        assert outs[("bf16", "K4")][key].shape[:-1] == (hc.num_layers, 1, hc.num_query)
        assert torch.isfinite(outs[("bf16", "K4")][key]).all(), key
        atol, rtol = ROUTE_TOL[key]
        log(f"  {key}: fp32 K4 vs plain max {max32:.4e} mean {mean32:.4e} (mean tol {R50_FP32_MEAN}); bf16 K4 vs "
            f"plain max {max16:.4e} mean {mean16:.4e} (atol {atol}, rtol {rtol}, mean {ROUTE_MEAN} and 1.5 x "
            f"the floor); floor, bf16 plain vs fp32 plain: max {max_floor:.4e} mean {floor:.4e}; max |value| "
            f"{ref.abs().max().item():.4e}")
        assert mean32 <= R50_FP32_MEAN, f"{key}: K4 and its plain version disagree in fp32"
        assert (e16 <= atol + rtol * ref.abs()).all(), f"{key}: K4 and its plain version disagree in bf16"
        assert mean16 <= min(ROUTE_MEAN, 1.5 * floor), f"{key}: K4 and its plain version disagree on average"


def timed_steps(torch, one_step, counters, want_per_step, n_timed, card, label):
    """Run ``n_timed`` steps with the launch counts set to 0 before; check the
    counts, and return the step times on CUDA events and the host clock."""
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
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
    launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    want = {k: v * n_timed for k, v in want_per_step.items()}
    log(f"  {n_timed} timed steps ({label}): kernel launches {launches} (expected {want}: per step "
        f"{want_per_step})")
    assert launches == want, (launches, want)
    return m, times, host, launches


def check_r50_training(torch, ca, dcn, card):
    import dataclasses

    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.models import resnet
    from petr_tpu_torch.models.layers import FrozenBatchNorm
    from petr_tpu_torch.train import create_train_state, make_grad_fn, make_train_step

    cfg = get_config(R50)
    mc = cfg.model
    assert mc.head.dropout_rate == DROPOUT and mc.use_grid_mask and mc.remat
    assert not mc.backbone.train_bn_affine
    B = cfg.train.optim.batch_size_per_device
    log(f"phase 7: {R50} training at full width, random weights (seed {SEED}, offset convs from seed "
        f"{SEED + 1}, BN statistics normalised), {mc.compute_dtype}, batch {B}, dropout "
        f"{mc.head.dropout_rate}, GridMask on, remat {mc.remat} (scope {mc.remat_scope}), backbone BN "
        f"affine frozen")
    t0 = time.perf_counter()
    state = create_train_state(cfg, SEED, total_steps=1000, device="cuda")
    model = state.model
    r50_random_weights(torch, cfg, model)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [{k: torch.as_tensor(v).cuda() for k, v in make_train_batch(cfg, SEED + i).items()}
               for i in range(3)]
    log(f"  train state and 3 synthetic batches in {time.perf_counter() - t0:.1f} s")
    step_fn = make_train_step(cfg)
    gen = torch.Generator().manual_seed(SEED)
    params = dict(model.named_parameters())
    watched = ("img_backbone.layer3.0.conv2.weight", "img_backbone.layer3.0.conv2.conv_offset.weight",
               "img_backbone.layer4.2.conv2.weight", "img_backbone.layer4.2.conv2.conv_offset.bias",
               "img_backbone.conv1.weight", "pts_bbox_head.cls_branches.0.6.bias")
    bn_affine = [n for n, m in model.img_backbone.named_modules() if isinstance(m, FrozenBatchNorm)]
    frozen = {f"img_backbone.{n}.{leaf}" for n in bn_affine for leaf in ("weight", "bias")}
    assert all(not params[n].requires_grad for n in frozen)
    before = {n: params[n].detach().clone() for n in (*watched, *frozen)}
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
        one_step()
    torch.cuda.synchronize()
    L = mc.head.num_layers
    counters = {"K4": (dcn, "LAUNCHES"), "K1": (ca, "LAUNCHES"), "K2 dK/dV": (ca, "DKDV_LAUNCHES"),
                "K2 dQ": (ca, "DQ_LAUNCHES"), "K4 fp32": (dcn, "LAUNCHES_FP32"), "K1 fp32": (ca, "LAUNCHES_FP32"),
                "K2 dK/dV fp32": (ca, "DKDV_LAUNCHES_FP32"), "K2 dQ fp32": (ca, "DQ_LAUNCHES_FP32")}
    m, times, host, launches = timed_steps(
        torch, one_step, counters,
        {"K4": 18, "K1": 2 * L, "K2 dK/dV": L, "K2 dQ": L, "K4 fp32": 0, "K1 fp32": 0, "K2 dK/dV fp32": 0,
         "K2 dQ fp32": 0}, 3, card, "K4: 9 forward + 9 in the bottlenecks' recompute")
    log("  last step's metrics: " + ", ".join(f"{k} {float(v):.4f}" for k, v in m.items()))
    for n in watched:
        moved = (params[n].detach() - before[n]).abs().max().item()
        log(f"  {n}: max |change| {moved:.3e} over {steps[0]} steps")
        assert moved > 0, f"{n} did not move"
    for n in frozen:
        assert torch.equal(params[n].detach(), before[n]), f"frozen BN affine {n} moved"
    for n, b in model.named_buffers():
        assert torch.equal(b, buffers[n]), f"buffer {n} moved"
    log(f"  the backbone BN affine ({len(frozen)} tensors, train_bn_affine=False) and every BN statistic "
        f"({len(buffers)} buffers) unchanged")
    med = statistics.median(times)
    log(f"  train step at batch {B} (6 views {cfg.data.image_size[0]}x{cfg.data.image_size[1]}): median "
        f"{med:.2f} ms on CUDA events ({', '.join(f'{t:.2f}' for t in times)}), host clock median "
        f"{statistics.median(host) * 1e3:.2f} ms, {B * 1e3 / med:.3f} samples/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]")
    dev_ms, per_kernel = profile(torch, one_step, card, iters=2, unit="step", inference=False)
    log(f"  device busy without the profiler: {100 * dev_ms / med:.1f}% of the median step "
        f"({dev_ms:.3f} ms of device time in {med:.2f} ms) [{card}]")
    k2_ms = per_kernel.get("K2 dK/dV", 0.0) + per_kernel.get("K2 dQ", 0.0)
    log(f"  K2 (dK/dV + dQ) per step: {k2_ms:.3f} ms of device time [{card}]")
    check_reproducible(torch, cfg, step_fn, initial, batches[0])

    # In fp32 the step is sensitive to the last bit: a ReLU whose input lies
    # within rounding of 0 switches, or a sampling point crosses a pixel
    # edge where the sample's derivative in its offset jumps, and one whole
    # term then changes a gradient that is a sum of ~10^4 terms of both
    # signs (the CPU parity test saw one ReLU switch move stages 1-3 by up
    # to 1.5%). K4's other order of the fp32 sums is such a last-bit change.
    # So the yardstick is the plain route with its images nudged by one ulp:
    # K4's worst gradient within NUDGE_MARGIN x that step's worst, and the
    # median within STEP_GRAD_RTOL. The offsets are drawn per tap (weight_std
    # 0), fractional and past the edges, the same at every pixel, so that
    # K4's rounding cannot move a sampling point.
    log("phase 7: one fp32 step with K4 against the same step on its plain version "
        "(offsets and masks per tap, the same at every pixel)")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(mc, compute_dtype="float32"))
    grad_fn = make_grad_fn(cfg32)
    model32 = create_train_state(cfg32, SEED, 1000, device="cuda").model
    r50_random_weights(torch, cfg32, model32, weight_std=0.0)
    batch = {k: torch.as_tensor(v).cuda() for k, v in make_train_batch(cfg, SEED + 1).items()}
    nudged = dict(batch, images=torch.nextafter(batch["images"], torch.tensor(float("inf"), device="cuda")))

    def grads_of(plain=False, inputs=batch):
        if plain:
            resnet.modulated_deform_conv = dcn.modulated_deform_conv_plain
        try:
            return grad_fn(model32, inputs, torch.Generator().manual_seed(SEED + 7))
        finally:
            resnet.modulated_deform_conv = dcn.modulated_deform_conv

    dcn.LAUNCHES = ca.DKDV_LAUNCHES = ca.DQ_LAUNCHES = ca.DKDV_LAUNCHES_FP32 = ca.DQ_LAUNCHES_FP32 = 0
    dcn.LAUNCHES_FP32 = ca.LAUNCHES = ca.LAUNCHES_FP32 = 0
    with_kernel = grads_of()
    counts = (dcn.LAUNCHES_FP32, ca.LAUNCHES_FP32, ca.DKDV_LAUNCHES_FP32, ca.DQ_LAUNCHES_FP32, dcn.LAUNCHES,
              ca.LAUNCHES, ca.DKDV_LAUNCHES, ca.DQ_LAUNCHES)
    log(f"  fp32 step: K4 fp32, K1 fp32, K2 dK/dV fp32, dQ fp32 launches {counts[:4]} (expected "
        f"{(18, 2 * L, L, L)}); K4, K1, K2 dK/dV, dQ bf16 {counts[4:]} (expected 0)")
    assert counts == (18, 2 * L, L, L, 0, 0, 0, 0), counts
    fp32_k4_launches = dcn.LAUNCHES_FP32
    plain = grads_of(plain=True)
    nudge = compare_steps(torch, "plain version, images nudged by one ulp vs not (the floor)",
                          grads_of(plain=True, inputs=nudged), plain, STEP_LOSS_RTOL, 1.0)
    assert dcn.LAUNCHES_FP32 == 18, "the plain route launched K4"
    compare_steps(torch, "K4 vs its plain version (remat on)", with_kernel, plain, STEP_LOSS_RTOL, STEP_GRAD_RTOL,
                  floor=nudge)
    return launches, fp32_k4_launches


def check_reproducible(torch, cfg, step_fn, initial, batch, phase=7):
    """Two bf16 train steps from the same weights (``initial``, a
    state_dict), batch and generator seed, each on a fresh optimizer: the
    same ``grad_norm`` and the same parameters after the update, bit for
    bit. (The DCN's plain backward, autograd of the bilinear gather, once
    summed each pixel's gradient with atomics, ``ops/sampling.py``; and
    cuDNN's weight gradient of the offset convs took a nondeterministic
    algorithm until ``create_train_state`` pinned deterministic ones.)"""
    from petr_tpu_torch.train import create_train_state

    log(f"phase {phase}: two identical bf16 steps (same weights, batch and generator seed): bit for bit the same")
    runs = []
    for _ in range(2):
        state = create_train_state(cfg, SEED, total_steps=1000, device="cuda")
        state.model.load_state_dict(initial)
        _, metrics = step_fn(state, batch, torch.Generator().manual_seed(SEED + 11))
        runs.append((metrics["grad_norm"].clone(), metrics["loss"].clone(),
                     {n: p.detach().clone() for n, p in state.model.named_parameters()}))
        del state
    (g0, l0, p0), (g1, l1, p1) = runs
    differ = [n for n in p0 if not torch.equal(p0[n], p1[n])]
    log(f"  loss {l0.item():.9g} / {l1.item():.9g}, grad_norm {g0.item():.9g} / {g1.item():.9g} "
        f"({'equal' if torch.equal(g0, g1) else 'NOT equal'} bit for bit); {len(differ)} of {len(p0)} "
        f"parameters differ after the update" + (f" (first: {differ[:3]})" if differ else ""))
    assert torch.equal(l0, l1), "two identical steps gave different losses"
    assert torch.equal(g0, g1), "two identical steps gave different grad_norm"
    assert not differ, f"two identical steps left {len(differ)} parameters different"


def check_petrv2_head_tail(torch, model, args):
    """The v2 head's last stage recomputed here from the decoder's output:
    layer l's cls logits are ``cls_branches[l]`` of the layer's output, and
    its velocity codes ``reg_branches[l]``'s last two outputs divided by the
    mean step from the current frame's timestamps to the previous frame's
    (with_time; |dt| >= 1e-3). The decoder's output is caught by a hook on
    the transformer."""
    head = model.pts_bbox_head
    caught = []
    hook = head.transformer.register_forward_hook(lambda mod, inp, o: caught.append(o))
    try:
        with torch.inference_mode():
            out = forward(model, args)
    finally:
        hook.remove()
    dec = torch.nan_to_num(caught[0])
    ts = args[3].float()
    dt = (ts[:, 6:] - ts[:, :6]).mean(-1)
    assert (dt.abs() >= 1e-3).all()
    worst = 0.0
    with torch.inference_mode():
        for lvl in range(dec.shape[0]):
            cls = head.cls_branches[lvl](dec[lvl]).float()
            vel = head.reg_branches[lvl](dec[lvl]).float()[..., 8:] / dt[:, None, None]
            for got, want in ((out["cls_logits"][lvl], cls), (out["bbox_codes"][lvl][..., 8:], vel)):
                err = (got - want).abs().max().item()
                worst = max(worst, err / max(want.abs().max().item(), 1e-30))
    log(f"  the head's last stage recomputed from the decoder's output (each layer's own branches, "
        f"velocities / mean frame step {dt.tolist()}): worst relative error {worst:.3e} (tol 1e-6)")
    assert worst <= 1e-6, "the v2 head's branches or its velocity normalisation disagree with their recomputation"


def check_petrv2(torch, ca, card):
    """Phase 8: PETRv2 at full width in bf16 (random weights from SEED):
    served through InferenceServer with timestamps, streamed, and trained."""
    import dataclasses

    import numpy as np

    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.models import layers
    from petr_tpu_torch.serve import StreamingPETRv2, build_detector
    from petr_tpu_torch.train import create_train_state, make_grad_fn, make_train_step

    cfg = get_config(PETRV2)
    mc, hc = cfg.model, cfg.model.head
    L = hc.num_layers
    assert cfg.data.num_frames == 2 and hc.with_fpe and hc.with_time and hc.with_multi_reg and not hc.shared_branches
    log(f"phase 8: {PETRV2} serving at full width, random weights (seed {SEED}), {mc.compute_dtype}: "
        f"{cfg.data.num_views} views x {cfg.data.num_frames} frames at {cfg.data.image_size}, FPE, with_time, "
        f"RegLayer, unshared branches, L = {LV2} decoder keys")
    t0 = time.perf_counter()
    model = build_detector(cfg, seed=SEED, device="cuda")
    log(f"  model built in {time.perf_counter() - t0:.1f} s: {sum(p.numel() for p in model.parameters())} "
        f"parameters")
    k1 = {"K1": (ca, "LAUNCHES"), "K1 fp32": (ca, "LAUNCHES_FP32")}
    model_tol = {"cls_logits": (MODEL_ATOL, MODEL_RTOL), "bbox_codes": (MODEL_ATOL, MODEL_RTOL)}
    serve_launches, args, fn, results = serve_and_check(
        torch, cfg, model, k1, {"K1": L, "K1 fp32": 0},
        [(layers, "flash_cross_attention", ca.flash_cross_attention_reference)], model_tol, MODEL_MEAN, card)
    check_petrv2_head_tail(torch, model, args)
    fwd_ms, dev_ms, _, per_kernel = serving_latency(torch, cfg, model, fn, results, card)
    serving = {"forward_ms": fwd_ms, "forward_device_ms": dev_ms, "k1_device_ms_per_forward": per_kernel.get("K1")}

    log("phase 8: streaming (StreamingPETRv2): prime, then 3 frames; each frame against the full 12-view forward "
        "over (frame t, frame t - 1)")
    H, W = cfg.data.image_size
    rng = np.random.RandomState(SEED + 21)
    frames = [torch.as_tensor(rng.randn(1, 6, H, W, 3).astype(np.float32)).cuda() for _ in range(4)]
    cams = torch.as_tensor(view_cams(cfg)).cuda()
    img_hw = torch.tensor([H, W], dtype=torch.float32, device="cuda").expand(1, 12, 2).contiguous()
    stream = StreamingPETRv2(cfg, model, decode=False, device="cuda")
    batches = []
    hook = model.img_backbone.register_forward_pre_hook(lambda mod, inp: batches.append(inp[0].shape[0]))
    try:
        stream.prime(frames[0])
        ca.LAUNCHES = ca.LAUNCHES_FP32 = 0
        stream_err = []
        for t in range(1, 4):
            ts = torch.as_tensor(frame_timestamps(rng)).cuda()
            got = stream.step(frames[t], cams, img_hw, ts)
            n_backbone = len(batches)
            with torch.inference_mode():
                full = model(torch.cat([frames[t], frames[t - 1]], 1), cams, img_hw, timestamp=ts)
            assert batches[n_backbone - 1] == 6 and batches[n_backbone] == 12, batches
            errs = {}
            for key in ("cls_logits", "bbox_codes"):
                e = (got[key].float() - full[key].float()).abs()
                errs[key] = (e.max().item(), e.mean().item())
            log(f"  frame {t}: " + ", ".join(f"{k} max abs err {m:.4e} mean {a:.4e}" for k, (m, a) in errs.items())
                + f" (ROUTE_TOL {ROUTE_TOL}, mean {ROUTE_MEAN})")
            compare_outputs(torch, f"streaming frame {t} vs the full 12-view forward", got, full, ROUTE_TOL,
                            ROUTE_MEAN, (L, 1, hc.num_query))
            stream_err.append(errs)
    finally:
        hook.remove()
    stream_batches = batches[1::2]  # the frames' own backbone runs (the full forwards' in between)
    log(f"  backbone batch per call: prime {batches[0]}, frames {stream_batches} (6 views each), full forwards "
        f"{batches[2::2]}; K1 launches over 3 frames and 3 full forwards: {ca.LAUNCHES} bf16, "
        f"{ca.LAUNCHES_FP32} fp32 (expected {2 * 3 * L} and 0)")
    assert batches[0] == 6 and stream_batches == [6, 6, 6], batches
    assert (ca.LAUNCHES, ca.LAUNCHES_FP32) == (2 * 3 * L, 0)
    with torch.inference_mode():
        cached = stream._prev_feats
        stream_ms = cuda_time_ms(lambda: model.forward_head(torch.cat([stream.model.extract_feats(frames[3]),
                                                                        cached], 1), cams, img_hw, (H, W),
                                                             timestamp=ts), warmup=2, iters=10)
        full_ms = cuda_time_ms(lambda: model(torch.cat([frames[3], frames[2]], 1), cams, img_hw, timestamp=ts),
                               warmup=2, iters=10)

    def inference(fn):
        def run():
            with torch.inference_mode():
                fn()
        return run

    stream_dev = device_ms(torch, inference(lambda: model.forward_head(
        torch.cat([model.extract_feats(frames[3]), cached], 1), cams, img_hw, (H, W), timestamp=ts)), iters=5)
    full_dev = device_ms(torch, inference(lambda: model(torch.cat([frames[3], frames[2]], 1), cams, img_hw,
                                                        timestamp=ts)), iters=5)
    log(f"  a streaming frame (backbone on 6 views + head) {stream_ms:.2f} ms, the full 12-view forward "
        f"{full_ms:.2f} ms (CUDA events, median of 10); device time {stream_dev:.3f} and {full_dev:.3f} ms [{card}]")
    del model, stream
    torch.cuda.empty_cache()

    log(f"phase 8: {PETRV2} training at full width, random weights (seed {SEED}), {mc.compute_dtype}, batch "
        f"{cfg.train.optim.batch_size_per_device}, dropout {hc.dropout_rate}, GridMask on all 12 views, remat "
        f"{mc.remat} (scope {mc.remat_scope}), code weights {cfg.train.optim.code_weights}")
    assert hc.dropout_rate == DROPOUT and mc.use_grid_mask and mc.remat
    state = create_train_state(cfg, SEED, total_steps=1000, device="cuda")
    train_batches = [{k: torch.as_tensor(v).cuda() for k, v in make_train_batch(cfg, SEED + i).items()}
                     for i in range(3)]
    step_fn = make_train_step(cfg)
    gen = torch.Generator().manual_seed(SEED)
    params = dict(state.model.named_parameters())
    watched = ("img_backbone.stem.stem_1/conv.weight", "pts_bbox_head.fpe.conv_reduce.weight",
               "pts_bbox_head.cls_branches.5.6.bias", "pts_bbox_head.reg_branches.5.task_heads.4.2.weight")
    before = {n: params[n].detach().clone() for n in watched}
    steps = [0]

    def one_step():
        _, metrics = step_fn(state, train_batches[steps[0] % len(train_batches)], gen)
        steps[0] += 1
        assert metrics["skipped"] == 0 and metrics["grad_nonfinite"] == 0, metrics
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"]), metrics
        return metrics

    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):  # warm up
        one_step()
    torch.cuda.synchronize()
    counters = {"K1": (ca, "LAUNCHES"), "K2 dK/dV": (ca, "DKDV_LAUNCHES"), "K2 dQ": (ca, "DQ_LAUNCHES"),
                "K1 fp32": (ca, "LAUNCHES_FP32"), "K2 dK/dV fp32": (ca, "DKDV_LAUNCHES_FP32"),
                "K2 dQ fp32": (ca, "DQ_LAUNCHES_FP32")}
    m, times, host, train_launches = timed_steps(
        torch, one_step, counters, {"K1": 2 * L, "K2 dK/dV": L, "K2 dQ": L, "K1 fp32": 0, "K2 dK/dV fp32": 0,
                                    "K2 dQ fp32": 0}, 3, card, f"K1: {L} forward + {L} in the decoder's recompute")
    log("  last step's metrics: " + ", ".join(f"{k} {float(v):.4f}" for k, v in m.items()))
    for n in watched:
        moved = (params[n].detach() - before[n]).abs().max().item()
        log(f"  {n}: max |change| {moved:.3e} over {steps[0]} steps")
        assert moved > 0, f"{n} did not move"
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  train step at batch 1 (12 views {H}x{W}): median {med:.2f} ms on CUDA events "
        f"({', '.join(f'{t:.2f}' for t in times)}), host clock median {statistics.median(host) * 1e3:.2f} ms, "
        f"{1e3 / med:.3f} samples/s; peak memory {peak:.3f} GiB [{card}]")
    step_dev_ms, step_kernels = profile(torch, one_step, card, iters=2, unit="step", inference=False)
    log(f"  device busy without the profiler: {100 * step_dev_ms / med:.1f}% of the median step "
        f"({step_dev_ms:.3f} ms of device time in {med:.2f} ms) [{card}]")
    del state, train_batches
    torch.cuda.empty_cache()

    log("phase 8: one fp32 step with the kernels against the same step on the plain versions, beside the plain "
        "step with its images nudged one ulp up and one down")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(mc, compute_dtype="float32"))
    grad_fn = make_grad_fn(cfg32)
    model32 = create_train_state(cfg32, SEED, 1000, device="cuda").model
    batch = {k: torch.as_tensor(v).cuda() for k, v in make_train_batch(cfg, SEED + 1).items()}
    nudged = {d: dict(batch, images=torch.nextafter(batch["images"], torch.tensor(d * float("inf"), device="cuda")))
              for d in (1, -1)}

    def grads_of(plain=False, inputs=batch):
        if plain:
            layers.flash_cross_attention = ca.flash_cross_attention_plain
        try:
            return grad_fn(model32, inputs, torch.Generator().manual_seed(SEED + 7))
        finally:
            layers.flash_cross_attention = ca.flash_cross_attention

    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    with_kernels = grads_of()
    fp32_counts = (ca.LAUNCHES_FP32, ca.DKDV_LAUNCHES_FP32, ca.DQ_LAUNCHES_FP32, ca.LAUNCHES, ca.DKDV_LAUNCHES,
                   ca.DQ_LAUNCHES)
    log(f"  fp32 step: K1 fp32, K2 dK/dV fp32, K2 dQ fp32, K1 bf16, K2 dK/dV bf16, K2 dQ bf16 launches "
        f"{fp32_counts} (expected {(2 * L, L, L, 0, 0, 0)})")
    assert fp32_counts == (2 * L, L, L, 0, 0, 0), fp32_counts
    plain = grads_of(plain=True)
    # the floor: what a last-bit change of the input alone does to this
    # step, per parameter the larger of a nudge up and a nudge down (a
    # decoder FFN whose ReLU input lies within rounding of 0 switches, and
    # its weight's gradient loses or gains one query's term)
    nudges = [compare_steps(torch, f"plain versions, images nudged one ulp {way} vs not (the floor)",
                            grads_of(plain=True, inputs=nudged[d]), plain, STEP_LOSS_RTOL, 1.0)
              for d, way in ((1, "up"), (-1, "down"))]
    floor = {n: max(nd[n] for nd in nudges) for n in nudges[0]}
    assert ca.LAUNCHES_FP32 == 2 * L, "the plain route launched K1"
    compare_steps(torch, "kernels vs plain versions (remat on)", with_kernels, plain, STEP_LOSS_RTOL,
                  STEP_GRAD_RTOL, floor=floor)
    del model32
    torch.cuda.empty_cache()
    return serve_launches, train_launches, {
        **serving, "stream_frame_ms": stream_ms, "full_forward_ms": full_ms, "stream_frame_device_ms": stream_dev,
        "full_forward_device_ms": full_dev, "stream_errors": stream_err,
        "step_ms": times, "step_device_ms": step_dev_ms, "step_peak_gib": peak,
        "k1_device_ms_per_step": step_kernels.get("K1"),
        "k2_device_ms_per_step": step_kernels.get("K2 dK/dV", 0.0) + step_kernels.get("K2 dQ", 0.0)}


def make_depthr_batch(cfg, seed):
    """One sample for the Depthr head (the GT-depth oracle), drawn from
    ``seed`` with numpy: ``make_train_batch``'s views and labels, the
    cameras' ``lidar2img``, and ``valid_gt`` boxes placed so that most
    straddle two cameras: two thirds at a bearing between two cameras, 5
    to 20 m away, a third ahead of one, 6 to 40 m away (inside the LID
    range, 60 m); 2 to 5 m in size, any yaw. The other rows of ``max_gt``
    are padding."""
    import numpy as np

    batch = make_train_batch(cfg, seed)
    rng = np.random.RandomState(seed + 1000)
    valid = batch["gt_valid"][0]
    g = int(valid.sum())
    n = cfg.data.num_views
    between = rng.rand(g) < 2 / 3
    bearing = 2 * np.pi * (rng.randint(0, n, g) + 0.5 * between) / n + rng.uniform(-0.03, 0.03, g)
    dist = np.where(between, rng.uniform(5.0, 20.0, g), rng.uniform(6.0, 40.0, g))
    boxes = np.zeros_like(batch["gt_boxes"][0])
    boxes[valid] = np.concatenate([
        (dist * np.cos(bearing))[:, None], (dist * np.sin(bearing))[:, None], rng.uniform(-1, 1, (g, 1)),
        rng.uniform(2.0, 5.0, (g, 3)), rng.uniform(-np.pi, np.pi, (g, 1)), rng.uniform(-1, 1, (g, 2)),
    ], -1)
    batch["gt_boxes"] = boxes[None].astype(np.float32)
    batch["lidar2img"] = np.linalg.inv(batch["img2lidar"]).astype(np.float32)
    return batch


def boxes_per_view(batch, H, W):
    """(N, G) bool: box g counts in view n by gt_depth_maps' rule (a corner
    inside the image at a depth above 1, all corners in front), in fp64."""
    import numpy as np

    b = batch["gt_boxes"][0].astype(np.float64)
    signs = np.array([[sx, sy, sz] for sx in (-0.5, 0.5) for sy in (-0.5, 0.5) for sz in (-0.5, 0.5)])
    local = signs[None] * b[:, None, 3:6]
    c, s = np.cos(b[:, 6])[:, None], np.sin(b[:, 6])[:, None]
    corners = np.stack([local[..., 0] * c - local[..., 1] * s, local[..., 0] * s + local[..., 1] * c,
                        local[..., 2]], -1) + b[:, None, :3]
    hom = np.concatenate([corners, np.ones(corners.shape[:-1] + (1,))], -1)
    uvd = np.einsum("nij,gkj->ngki", batch["lidar2img"][0, :, :3].astype(np.float64), hom)
    u, v, d = uvd[..., 0] / uvd[..., 2], uvd[..., 1] / uvd[..., 2], uvd[..., 2]
    inside = (u > 0) & (u < W) & (v > 0) & (v < H) & (d > 1.0)
    return inside.any(-1) & (d > 0.1).all(-1) & batch["gt_valid"][0][None]


def check_depth_maps(torch, cfg, batch):
    """GT depth maps of a phase-9 batch: the share of pixels covered in each
    view, above 0 in every view that a box counts in; the maps on the card
    equal to the CPU's bit for bit (elementwise fp32 sums in a fixed
    order). Returns the share per view."""
    from petr_tpu_torch.models.depth_encoder import gt_depth_maps

    H, W = cfg.data.image_size
    hc = cfg.model.head
    inputs = [torch.as_tensor(batch[k]) for k in ("gt_boxes", "gt_valid", "lidar2img")]
    cpu = gt_depth_maps(*inputs, (H, W), hc.depth_map_down_scale)
    card = gt_depth_maps(*[t.cuda() for t in inputs], (H, W), hc.depth_map_down_scale).cpu()
    in_view = boxes_per_view(batch, H, W)
    share = (cpu[0] > 0).float().mean(dim=(1, 2)).tolist()
    views = in_view.sum(0)[batch["gt_valid"][0]]
    log(f"  depth maps {tuple(cpu.shape)} (stride {hc.depth_map_down_scale}): covered share per view "
        + ", ".join(f"{x:.4f}" for x in share) + f"; boxes per view {in_view.sum(1).tolist()}; of "
        f"{int(batch['gt_valid'].sum())} boxes {int((views >= 2).sum())} count in two or more views, "
        f"{int((views == 1).sum())} in one, {int((views == 0).sum())} in none; depths "
        f"{cpu[cpu > 0].min().item():.3f} to {cpu.max().item():.3f} m")
    for n, (x, k) in enumerate(zip(share, in_view.sum(1))):
        assert k == 0 or x > 0, f"view {n}: {k} boxes count in it but no pixel is painted"
    assert sum(share) > 0, "no pixel painted: the phase would test nothing"
    differ = int((card != cpu).sum())
    log(f"  the maps on the card against the CPU: {differ} of {cpu.numel()} pixels differ (must be 0)")
    assert differ == 0, "gt_depth_maps differs between the card and the CPU"
    return share


def check_depthr(torch, ca, dcn, card):
    """Phase 9: the Depthr preset at full width in bf16, evaluated with the
    GT boxes (make_eval_step) and trained (make_train_step)."""
    import dataclasses

    import numpy as np

    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.models import PETRDetector, resnet
    from petr_tpu_torch.serve import build_detector, decode_last_layer
    from petr_tpu_torch.train import create_train_state, make_eval_step, make_grad_fn, make_train_step

    cfg = get_config(DEPTHR)
    mc, hc = cfg.model, cfg.model.head
    H, W = cfg.data.image_size
    L, Q = hc.num_layers, hc.num_query
    keys = 6 * (H // 32) * (W // 32)
    assert hc.kind == "depthr" and not mc.backbone.with_fpn and mc.backbone.dcn_stages == (2, 3)
    log(f"phase 9: {DEPTHR} evaluated at full width, random weights (seed {SEED}, offset convs redrawn from seed "
        f"{SEED + 1}, BN statistics normalised on one request), {mc.compute_dtype}: 6 views of {H}x{W}, ResNet-50 "
        f"with DCNv2 in stages 3-4, C5 only (no neck), {L} Depthr layers, {Q} queries, L = {keys} depth tokens "
        f"({hc.depth_bins} + 1 LID bins, maps at stride {hc.depth_map_down_scale}, encoder x"
        f"{hc.depth_encoder_down_scale}); attention on the plain branch")
    t0 = time.perf_counter()
    model = build_detector(cfg, seed=SEED, device="cuda")
    assert r50_random_weights(torch, cfg, model) == 9
    log(f"  model built in {time.perf_counter() - t0:.1f} s: {sum(p.numel() for p in model.parameters())} "
        f"parameters")
    batches = [make_depthr_batch(cfg, SEED + 30 + i) for i in range(3)]
    share = check_depth_maps(torch, cfg, batches[0])

    # evaluation: 3 batches through the eval step, launches counted
    eval_step = make_eval_step(cfg)
    args_device = next(model.parameters()).device
    eval_step(model, batches[0])  # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dcn.LAUNCHES = dcn.LAUNCHES_FP32 = ca.LAUNCHES = ca.LAUNCHES_FP32 = 0
    decoded = [eval_step(model, b) for b in batches]
    launches = {"K4": dcn.LAUNCHES, "K4 fp32": dcn.LAUNCHES_FP32, "K1": ca.LAUNCHES, "K1 fp32": ca.LAUNCHES_FP32}
    eval_peak = torch.cuda.max_memory_allocated() / 2**30
    k = min(cfg.max_det, Q * hc.num_classes)
    for d in decoded:
        assert d["boxes"].device == args_device and d["boxes"].shape == (1, k, 9), (d["boxes"].device, d["boxes"].shape)
        assert torch.isfinite(d["boxes"]).all() and torch.isfinite(d["scores"]).all()
    log(f"  make_eval_step on 3 batches: launches {launches} (expected K4 27, 9 per forward, and no other: the "
        f"decoder's attention is the plain branch); boxes {tuple(decoded[0]['boxes'].shape)} on the card, finite, "
        f"{[int(d['valid'].sum()) for d in decoded]} valid; peak memory {eval_peak:.3f} GiB [{card}]")
    assert launches == {"K4": 27, "K4 fp32": 0, "K1": 0, "K1 fp32": 0}, launches

    # the rebinding: other images, the same cameras and boxes, the same outputs
    args = {k: torch.as_tensor(v).cuda() for k, v in batches[0].items()}
    oracle = {k: args[k] for k in ("gt_boxes", "gt_valid", "lidar2img")}
    other = torch.as_tensor(np.random.RandomState(SEED + 40).randn(*batches[0]["images"].shape)
                            .astype(np.float32)).cuda()
    with torch.inference_mode():
        out = model(args["images"], args["img2lidar"], args["img_hw"], **oracle)
        out_other = model(other, args["img2lidar"], args["img_hw"], **oracle)
        feats = [model.extract_feats(x) for x in (args["images"], other)]
    feat_diff = (feats[0].float() - feats[1].float()).abs().max().item()
    same = all(torch.equal(out[key], out_other[key]) for key in out)
    log(f"  the rebinding: other images (C5 features differ by up to {feat_diff:.3e}), the same cameras and "
        f"boxes: outputs {'equal' if same else 'NOT equal'} bit for bit")
    assert feat_diff > 0
    assert same, "the Depthr outputs depend on the images: the decoder reads the image features"

    # time: B=1 forwards on CUDA events, device time from one profiler pass,
    # and the backbone's share of it (the dead path)
    def fwd():
        return model(args["images"], args["img2lidar"], args["img_hw"], **oracle)

    with torch.inference_mode():
        fwd_ms = cuda_time_ms(fwd, warmup=2, iters=10)
        backbone_ms = cuda_time_ms(lambda: model.extract_feats(args["images"]), warmup=2, iters=10)
    log(f"  forward at B=1: {fwd_ms:.2f} ms on CUDA events (median of 10), the backbone alone "
        f"{backbone_ms:.2f} ms [{card}]")
    dev_ms, per_kernel = profile(torch, fwd, card)

    def backbone():
        with torch.inference_mode():
            model.extract_feats(args["images"])

    backbone_dev = device_ms(torch, backbone, iters=5)
    log(f"  the backbone (ResNet-50-DCN to C5, whose output reaches nothing) takes {backbone_dev:.3f} ms of the "
        f"forward's {dev_ms:.3f} ms of device time ({100 * backbone_dev / dev_ms:.1f}%); K4 "
        f"{per_kernel.get('K4', 0.0):.3f} ms of it [{card}]")

    # the bf16 decode against an fp32 twin on the plain routes
    model32 = PETRDetector(dataclasses.replace(mc, compute_dtype="float32")).cuda().eval()
    model32.load_state_dict(model.state_dict())
    resnet.modulated_deform_conv = dcn.modulated_deform_conv_plain
    try:
        with torch.inference_mode():
            out32 = model32(args["images"], args["img2lidar"], args["img_hw"], **oracle)
    finally:
        resnet.modulated_deform_conv = dcn.modulated_deform_conv
    compare_outputs(torch, "bf16 vs the fp32 twin on the plain routes", out, out32, ROUTE_TOL, ROUTE_MEAN, (L, 1, Q))
    # the decoded scores, sorted: a score s moves by s (1 - s) times its
    # logit's error, which ROUTE_TOL bounds by atol + rtol |logit|; sorting
    # keeps the largest such bound over the scores, and the mean is held to
    # ROUTE_MEAN times the largest slope
    s16, s32 = decode_last_layer(cfg, out)["scores"][0], decode_last_layer(cfg, out32)["scores"][0]
    atol, rtol = ROUTE_TOL["cls_logits"]
    slope = s32 * (1 - s32)
    limit = (slope * (atol + rtol * torch.logit(s32).abs())).max().item()
    mean_limit = ROUTE_MEAN * slope.max().item()
    err = (s16 - s32).abs()
    log(f"  decoded scores (sorted; {s32.min().item():.4f} to {s32.max().item():.4f}), bf16 vs the fp32 twin: max "
        f"abs err {err.max().item():.4e} (tol {limit:.4e}), mean {err.mean().item():.4e} (tol {mean_limit:.4e})")
    assert err.max().item() <= limit and err.mean().item() <= mean_limit, "the bf16 decode disagrees with fp32"
    del model, model32
    torch.cuda.empty_cache()

    # training
    log(f"phase 9: {DEPTHR} training at full width, {mc.compute_dtype}, batch "
        f"{cfg.train.optim.batch_size_per_device}, dropout {hc.dropout_rate}, GridMask on, remat {mc.remat} "
        f"(scope {mc.remat_scope}), backbone BN affine frozen")
    assert hc.dropout_rate == DROPOUT and mc.use_grid_mask and mc.remat and not mc.backbone.train_bn_affine
    state = create_train_state(cfg, SEED, total_steps=1000, device="cuda")
    model = state.model
    r50_random_weights(torch, cfg, model)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    train_batches = [{k: torch.as_tensor(v).cuda() for k, v in b.items()} for b in batches]
    step_fn = make_train_step(cfg)
    gen = torch.Generator().manual_seed(SEED)
    params = dict(model.named_parameters())
    watched = ("pts_bbox_head.depth_gt_encoder.depth_head.0.0.weight",
               "pts_bbox_head.depth_gt_encoder.depth_pos_embed.weight",
               f"pts_bbox_head.transformer.decoder.layers.{L - 1}.attentions.2.attn.in_proj_weight",
               "pts_bbox_head.cls_branches.0.6.bias")
    frozen = {n for n, p in params.items() if not p.requires_grad}
    before = {n: params[n].detach().clone() for n in (*watched, *frozen)}
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    steps = [0]

    def one_step():
        _, metrics = step_fn(state, train_batches[steps[0] % len(train_batches)], gen)
        steps[0] += 1
        assert metrics["skipped"] == 0 and metrics["grad_nonfinite"] == 0, metrics
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"]), metrics
        return metrics

    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):  # warm up
        one_step()
    torch.cuda.synchronize()
    counters = {"K4": (dcn, "LAUNCHES"), "K4 fp32": (dcn, "LAUNCHES_FP32"), "K1": (ca, "LAUNCHES"),
                "K2 dK/dV": (ca, "DKDV_LAUNCHES"), "K2 dQ": (ca, "DQ_LAUNCHES")}
    m, times, host, train_launches = timed_steps(
        torch, one_step, counters, {"K4": 9, "K4 fp32": 0, "K1": 0, "K2 dK/dV": 0, "K2 dQ": 0}, 3, card,
        "K4: 9 in the forward; no gradient reaches the backbone, so its bottlenecks are never recomputed")
    log("  last step's metrics: " + ", ".join(f"{k} {float(v):.4f}" for k, v in m.items()))
    for n in watched:
        moved = (params[n].detach() - before[n]).abs().max().item()
        log(f"  {n}: max |change| {moved:.3e} over {steps[0]} steps")
        assert moved > 0, f"{n} did not move"
    for n in frozen:
        assert torch.equal(params[n].detach(), before[n]), f"frozen {n} moved"
    for n, b in model.named_buffers():
        assert torch.equal(b, buffers[n]), f"buffer {n} moved"
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {len(frozen)} frozen tensors (the backbone's BN affine) and {len(buffers)} buffers unchanged; train step "
        f"at batch 1: median {med:.2f} ms on CUDA events ({', '.join(f'{t:.2f}' for t in times)}), host clock "
        f"median {statistics.median(host) * 1e3:.2f} ms, {1e3 / med:.3f} samples/s; peak memory {peak:.3f} GiB "
        f"[{card}]")
    step_dev_ms, step_kernels = profile(torch, one_step, card, iters=2, unit="step", inference=False)
    log(f"  device busy without the profiler: {100 * step_dev_ms / med:.1f}% of the median step "
        f"({step_dev_ms:.3f} ms of device time in {med:.2f} ms) [{card}]")
    check_reproducible(torch, cfg, step_fn, initial, train_batches[0], phase=9)
    del state, model
    torch.cuda.empty_cache()

    # one fp32 step with K4 against the same step on its plain version: the
    # backbone's output reaches no loss, so the two must agree bit for bit
    log("phase 9: one fp32 step with K4 against the same step on its plain version")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(mc, compute_dtype="float32"))
    grad_fn = make_grad_fn(cfg32)
    model32 = create_train_state(cfg32, SEED, 1000, device="cuda").model
    r50_random_weights(torch, cfg32, model32)

    def grads_of(plain=False):
        if plain:
            resnet.modulated_deform_conv = dcn.modulated_deform_conv_plain
        try:
            return grad_fn(model32, train_batches[1], torch.Generator().manual_seed(SEED + 7))
        finally:
            resnet.modulated_deform_conv = dcn.modulated_deform_conv

    dcn.LAUNCHES = dcn.LAUNCHES_FP32 = 0
    with_kernel = grads_of()
    fp32_launches = (dcn.LAUNCHES_FP32, dcn.LAUNCHES)
    plain = grads_of(plain=True)
    differ = [n for n in plain[2] if not torch.equal(with_kernel[2][n], plain[2][n])]
    log(f"  fp32 step: K4 fp32 launches {fp32_launches[0]}, bf16 {fp32_launches[1]} (expected 9 and 0); loss "
        f"{with_kernel[0].item():.9g} vs {plain[0].item():.9g}; {len(differ)} of {len(plain[2])} gradients differ "
        f"(must be 0)")
    assert fp32_launches == (9, 0), fp32_launches
    assert dcn.LAUNCHES_FP32 == 9, "the plain route launched K4"
    assert torch.equal(with_kernel[0], plain[0]) and not differ, differ[:3]
    del model32
    torch.cuda.empty_cache()
    return launches, train_launches, {
        "depthr_depth_map_share": share, "depthr_forward_ms": fwd_ms, "depthr_forward_device_ms": dev_ms,
        "depthr_backbone_device_ms": backbone_dev, "depthr_k4_device_ms_per_forward": per_kernel.get("K4"),
        "depthr_eval_peak_gib": eval_peak, "depthr_step_ms": times, "depthr_step_device_ms": step_dev_ms,
        "depthr_step_peak_gib": peak, "depthr_k4_device_ms_per_step": step_kernels.get("K4")}


# The synthetic-scene evaluation of phase 10: scenes rendered at the
# flagship's nuScenes source size (900x1600) by the port's renderer, seed
# SEED; 4 scenes of 3 frames, 2 held out (6 val and 6 train samples, each
# with a warm-up sweep), 6 objects each, scored over the 3 classes present.
EVAL_SCENES = dict(n_scenes=4, frames_per_scene=3, n_objects=6, val_scenes=2, seed=SEED)
EVAL_CLASSES = "car,bus,pedestrian"
# The flagship's metrics on the K1 route against the plain route, each
# metric within this: the outputs differ by one bf16 step here and there
# (MODEL_*), which can flip one centre-distance match of the 36 GT boxes;
# one match moves a class's AP at one threshold by up to 1/12, its AP by a
# quarter of that, mAP by a third again (0.007), a TP error mean by more.
METRIC_ROUTE_TOL = 2e-2
# A streaming frame's decoded scores against the 12-view eval step's,
# sorted: the bound ROUTE_TOL's (0.3, 3e-2) on a logit puts on its score
# through the sigmoid, whose slope is at most 1/4 and at most e^-|x| (0.09
# at |x| = 1.7, less elsewhere).
STREAM_SCORE_TOL = 0.1
# The CLI's submission (one process) against the phase's (another), the
# same weights and inputs on the same card: each token's sorted scores.
SUBMISSION_TOL = 1e-6


@contextlib.contextmanager
def torch_defaults(torch):
    """TF32 and cuDNN's algorithm flags at torch's defaults, which cli.test's
    own process runs with (phase 1 turned TF32 off), then as they were."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    torch.backends.cudnn.deterministic = torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags


_SHARED = {}


def shared_dir() -> str:
    """A directory for the inputs that several phases read (the rendered
    scenes, the int8 scales), made on first use and removed at exit."""
    import tempfile

    if "tmp" not in _SHARED:
        _SHARED["tmp"] = tempfile.TemporaryDirectory()
    return _SHARED["tmp"].name


def eval_scenes(H, W):
    """EVAL_SCENES rendered at HxW, once per run (phases 10, 13 and 14 read
    them; each renders them when it runs first) -> (splits, directory,
    seconds this call spent rendering)."""
    from petr_tpu_torch.data import generate_synthetic_scenes

    key = ("scenes", H, W)
    t0 = time.perf_counter()
    if key not in _SHARED:
        out = f"{shared_dir()}/synth_{H}x{W}"
        _SHARED[key] = generate_synthetic_scenes(out, image_hw=(H, W), **EVAL_SCENES), out
    return (*_SHARED[key], time.perf_counter() - t0)


def run_main(module, args, label):
    """``module.main(args)`` in this process (a CLI's entry point without a
    process start), its standard output captured and echoed: (the output, wall s)."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        module.main(list(args))
    wall = time.perf_counter() - t0
    log(f"  {label}: {module.__name__}.main({' '.join(args)[:300]}) in {wall:.1f} s")
    for line in buf.getvalue().splitlines()[-8:]:
        log(f"    | {line[:400]}")
    return buf.getvalue(), wall


def synthetic_scales():
    """``cli.quantize --synthetic`` of the flagship (random weights, seed 0,
    2 batches) in this process, once per run (phases 13 and 14 read it) ->
    (the scales file, seconds this call spent)."""
    import os

    from petr_tpu_torch.cli import quantize

    path = f"{shared_dir()}/scales.npz"
    if os.path.exists(path):
        return path, 0.0
    _, wall = run_main(quantize, ["--config", FLAGSHIP, "--synthetic", "--num-batches", "2", "--out", path],
                       "cli.quantize")
    return path, wall


def run_cli(args, label):
    """``python -m petr_tpu_torch.cli.test ARGS`` from this script's directory
    in a process of its own: it must exit 0. Returns (stdout, wall s)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "petr_tpu_torch.cli.test", *args], cwd=root,
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    log(f"  {label}: python -m petr_tpu_torch.cli.test {' '.join(args)} -> exit {proc.returncode} in {wall:.1f} s")
    for line in proc.stdout.splitlines():
        log(f"    | {line}")
    assert proc.returncode == 0, f"cli.test exited {proc.returncode}:\n{proc.stderr[-4000:]}"
    return proc.stdout, wall


def printed_metrics(stdout):
    """The CLI's metric lines ``name: value`` -> {name: value as printed}."""
    lines = [line.split(": ", 1) for line in stdout.splitlines() if ": " in line
             and not line.startswith(("inference:", "streaming:"))]
    return dict(lines)


def loader_cost(torch, cfg, model, ds, card):
    """The host's data cost beside the card's on the test-mode dataset
    ``ds``: each sample's loader time (``get`` and collation, batch 1), the
    eval step (copy in, forward, decode) on CUDA events, and an eval pass
    through ``Loader`` (4 threads) with the card's wait on it -> dict."""
    import numpy as np

    from petr_tpu_torch.data import Loader, collate_batch
    from petr_tpu_torch.data.transforms import sample_ida_params
    from petr_tpu_torch.train import make_eval_step

    H, W = cfg.data.src_hw
    ida = sample_ida_params(np.random.default_rng(0), (H, W), cfg.data.final_dim, cfg.data.resize_lim,
                            cfg.data.bot_pct_lim, cfg.data.rot_lim, cfg.data.rand_flip, False)
    host = []
    for i in range(len(ds)):
        t0 = time.perf_counter()
        batch = collate_batch([ds.get(i, seed=i)])
        host.append((time.perf_counter() - t0) * 1e3)
    eval_step = make_eval_step(cfg)
    dev_ms = cuda_time_ms(lambda: eval_step(model, batch), warmup=3, iters=10)
    wait = 0.0
    t_all = time.perf_counter()
    it = iter(Loader(ds, 1, shuffle=False, drop_last=False).epoch(0))
    n = 0
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        wait += time.perf_counter() - t0
        if batch is None:
            break
        {k: v.cpu() for k, v in eval_step(model, batch).items()}
        n += 1
    wall = time.perf_counter() - t_all
    log(f"  the loader's host time per batch of 1 (6 views of {H}x{W}: JPEG decode, bicubic resize to "
        f"{ida.resize_dims[0]}x{ida.resize_dims[1]}, crop {ida.crop}, normalisation, collation): median "
        f"{statistics.median(host):.3f} ms (" + ", ".join(f"{t:.3f}" for t in host) + ")")
    log(f"  the eval step (copy in, forward, decode) on CUDA events: median {dev_ms:.3f} ms per batch of 1")
    log(f"  an eval pass through Loader (4 threads) and the eval step: {n} samples in {wall:.4f} s, "
        f"{n / wall:.4f} samples/s; the card waited on the loader {100 * wait / wall:.2f}% of it [{card}]")
    return {"loader_ms_per_batch": host, "eval_step_ms": dev_ms, "eval_wall_s": wall,
            "loader_wait_share": wait / wall, "eval_samples_per_s": n / wall}


def check_eval(torch, ca, card):
    """Phase 10: the port's data, metrics, evaluation, checkpoints and
    evaluation CLI on synthetic scenes rendered at 900x1600: a bf16 train
    step, a checkpoint and a resume bit for bit; the flagship scored
    through ``evaluate_model`` and through ``cli.test`` on that checkpoint
    (K1 6 times per batch), against K1's plain route; the host's data cost;
    PETRv2 streamed through ``cli.test --streaming`` and held frame by
    frame to its 12-view eval step."""
    import os
    import pickle
    import tempfile

    import numpy as np

    from petr_tpu_torch.cli.test import run_streaming_inference
    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.data import Loader, NuScenesDataset, collate_batch
    from petr_tpu_torch.metrics.nuscenes import evaluate_detections, ground_truth_from_infos
    from petr_tpu_torch.metrics.submission import build_submission
    from petr_tpu_torch.models import layers
    from petr_tpu_torch.serve import build_detector, decode_last_layer
    from petr_tpu_torch.train import checkpoint, create_train_state, evaluate, make_eval_step, make_train_step

    cfg = get_config(FLAGSHIP)
    L, hc = cfg.model.head.num_layers, cfg.model.head
    H, W = cfg.data.src_hw
    classes = tuple(EVAL_CLASSES.split(","))
    times = {}
    with torch_defaults(torch), tempfile.TemporaryDirectory() as tmp:
        splits, synth, times["render_s"] = eval_scenes(H, W)
        val, train = splits["val"], splits["train"]
        n_jpeg = sum(name.endswith(".jpg") for name in os.listdir(synth))
        log(f"phase 10: rendered {EVAL_SCENES['n_scenes']} scenes of {EVAL_SCENES['frames_per_scene']} frames "
            f"(seed {SEED}, {EVAL_SCENES['n_objects']} objects, {EVAL_SCENES['val_scenes']} held out) at {H}x{W}: "
            f"{len(val)} val and {len(train)} train samples, {n_jpeg} JPEGs with the warm-up sweeps, in "
            f"{times['render_s']:.3f} s")
        assert (len(val), len(train), n_jpeg) == (6, 6, 4 * 4 * 6)
        val_pkl = f"{synth}/synth_infos_val.pkl"
        with open(val_pkl, "rb") as f:
            assert [i["token"] for i in pickle.load(f)["infos"]] == [i["token"] for i in val]

        # -- a train step, a checkpoint, and the resume --------------------
        log(f"phase 10: {FLAGSHIP} {cfg.model.compute_dtype} train step on a train-split loader batch (training IDA from {H}x{W}, "
            f"GridMask {cfg.model.use_grid_mask}, dropout {hc.dropout_rate}), save, restore into a fresh state, "
            "step 2 from both")
        try:
            train_ds = NuScenesDataset(train, cfg.data, training=True)
            b1, b2 = list(Loader(train_ds, 1, seed=SEED).epoch(0))[:2]
            assert b1["images"].shape == (1, 6, *cfg.data.image_size, 3)
            step_fn = make_train_step(cfg)
            state = create_train_state(cfg, SEED, total_steps=1000, device="cuda")
            gen = torch.Generator().manual_seed(SEED)
            _, m1 = step_fn(state, b1, gen)
            assert m1["skipped"] == 0 and torch.isfinite(m1["loss"]), m1
            ckpt = checkpoint.save_checkpoint(f"{tmp}/ckpts", state.step, state, meta={"config": FLAGSHIP})
            fresh = create_train_state(cfg, SEED + 1, total_steps=1000, device="cuda")
            checkpoint.restore_checkpoint(ckpt, fresh)
            gen_b = torch.Generator()
            gen_b.set_state(gen.get_state())
            _, m_a = step_fn(state, b2, gen)
            _, m_b = step_fn(fresh, b2, gen_b)
            ta = dict(state.model.state_dict())
            tb = dict(fresh.model.state_dict())
            for name, opt in (("a", state.optimizer), ("b", fresh.optimizer)):
                for i, s in opt.state_dict()["state"].items():
                    (ta if name == "a" else tb).update({f"adam.{i}.{k}": v for k, v in s.items()})
            differ = [k for k in ta if not torch.equal(ta[k], tb[k].to(ta[k].device))]
            n_moments = sum(k.startswith("adam.") for k in ta)
            log(f"  step 2 uninterrupted / restored: loss {m_a['loss'].item():.9g} / {m_b['loss'].item():.9g}, "
                f"grad_norm {m_a['grad_norm'].item():.9g} / {m_b['grad_norm'].item():.9g}; {len(differ)} of "
                f"{len(ta)} tensors (weights, buffers, {n_moments} AdamW moments and step counts) differ bit for "
                f"bit" + (f" (first: {differ[:3]})" if differ else "") + f"; step {state.step} / {fresh.step}")
            assert torch.equal(m_a["loss"], m_b["loss"]), "the restored step gave another loss"
            assert torch.equal(m_a["grad_norm"], m_b["grad_norm"]), "the restored step gave another grad_norm"
            assert not differ, f"the restored step left {len(differ)} tensors different: {differ[:5]}"
            assert state.step == fresh.step == 2
            del state, fresh, ta, tb
            torch.cuda.empty_cache()
        finally:  # create_train_state pinned cuDNN's deterministic algorithms; the CLI runs without
            torch.backends.cudnn.deterministic = torch.backends.cudnn.benchmark = False

        # -- evaluate_model on the checkpoint, K1 against the plain route ----
        log(f"phase 10: {FLAGSHIP} evaluated on the checkpoint of step 1 ({ckpt}): test-mode IDA {H}x{W} -> "
            f"{cfg.data.final_dim}, batch 1, scored over {EVAL_CLASSES}")
        model = build_detector(cfg, seed=SEED + 1, device="cuda")  # other weights until the checkpoint's load
        checkpoint.load_params(ckpt, model)
        ds = NuScenesDataset(val, cfg.data, training=False)
        ca.LAUNCHES = ca.LAUNCHES_FP32 = 0
        metrics = evaluate.evaluate_model(cfg, model, ds, classes=classes)
        launches = {"K1": ca.LAUNCHES, "K1 fp32": ca.LAUNCHES_FP32}
        log(f"  evaluate_model: {', '.join(f'{k} {v:.6f}' for k, v in metrics.items())}")
        log(f"  K1 launches over {len(val)} eval batches: {launches} (expected {L} bf16 per batch, 0 fp32)")
        assert launches == {"K1": L * len(val), "K1 fp32": 0}, launches
        batches = list(Loader(ds, 1, shuffle=False, drop_last=False).epoch(0))
        tokens, det_k = evaluate._decode_dataset(cfg, model, ds, 1)
        assert tokens == [i["token"] for i in val]
        kept = layers.flash_cross_attention
        layers.flash_cross_attention = ca.flash_cross_attention_plain
        try:
            _, det_p = evaluate._decode_dataset(cfg, model, ds, 1)
            metrics_plain = evaluate.evaluate_model(cfg, model, ds, classes=classes)
            with torch.inference_mode():
                out_p = [model(*[torch.as_tensor(b[k]).cuda() for k in ("images", "img2lidar", "img_hw")])
                         for b in batches]
        finally:
            layers.flash_cross_attention = kept
        with torch.inference_mode():
            out_k = [model(*[torch.as_tensor(b[k]).cuda() for k in ("images", "img2lidar", "img_hw")])
                     for b in batches]
        # Two bf16 routes that round P at other points: the raw outputs under
        # ROUTE_TOL, the decode under phase 4's MODEL_* limits below. On the
        # card a bbox code of every rendered scene moved by 0.0999 m: one
        # bf16 step (2^-8) of a centre logit near 0 times the sigmoid's slope
        # 1/4 times the 102.4 m range, past MODEL_ATOL + MODEL_RTOL x |code|
        # for a centre within 5 m of the car
        for i, (a, b) in enumerate(zip(out_k, out_p)):
            compare_outputs(torch, f"eval batch {i}: K1 vs its plain version", a, b, ROUTE_TOL, ROUTE_MEAN,
                            (L, 1, hc.num_query))
        s_k, s_p = np.sort(det_k["scores"], -1), np.sort(det_p["scores"], -1)
        err = np.abs(s_k - s_p)
        log(f"  decoded scores (sorted), K1 vs plain route: max abs err {err.max():.4e}, mean {err.mean():.4e} "
            f"(MODEL_ATOL {MODEL_ATOL}, MODEL_MEAN {MODEL_MEAN})")
        assert err.max() <= MODEL_ATOL and err.mean() <= MODEL_MEAN, "decoded scores: K1 vs plain route disagree"
        for i in range(len(tokens)):  # labels and boxes where no near-tie can swap ranks
            sk, order_k = det_k["scores"][i], np.argsort(-det_k["scores"][i], kind="stable")
            order_p = np.argsort(-det_p["scores"][i], kind="stable")
            gap = -np.diff(sk[order_k])
            apart = np.ones(len(sk), bool)
            apart[1:] &= gap > 2 * MODEL_ATOL
            apart[:-1] &= gap > 2 * MODEL_ATOL
            np.testing.assert_array_equal(det_k["labels"][i][order_k][apart], det_p["labels"][i][order_p][apart])
            np.testing.assert_allclose(det_k["boxes"][i][order_k][apart], det_p["boxes"][i][order_p][apart],
                                       rtol=0, atol=0.5)
        worst = max(abs(metrics[k] - metrics_plain[k]) for k in metrics)
        log(f"  metrics, K1 vs plain route: largest difference {worst:.6f} (METRIC_ROUTE_TOL {METRIC_ROUTE_TOL}); "
            f"plain: {', '.join(f'{k} {v:.6f}' for k, v in metrics_plain.items())}")
        assert list(metrics) == list(metrics_plain) and worst <= METRIC_ROUTE_TOL, "metrics: K1 vs plain disagree"

        # -- the evaluation CLI on the same checkpoint -----------------------
        sub_path = f"{tmp}/submission.json"
        out, cli_wall = run_cli(["--config", FLAGSHIP, "--infos", val_pkl, "--ckpt", ckpt, "--classes",
                                 EVAL_CLASSES, "--out", sub_path], "the CLI")
        printed = printed_metrics(out)
        want = {k: f"{v:.4f}" for k, v in metrics.items()}
        assert printed == want, f"the CLI printed {printed}, evaluate_model gave {want}"
        line = next(s for s in out.splitlines() if s.startswith("inference:"))
        times["cli_samples_per_s"] = float(line.split("(")[1].split()[0])
        times["cli_wall_s"] = cli_wall
        with open(sub_path) as f:
            sub = json.load(f)
        info_by_token = {i["token"]: i for i in val}
        mine = build_submission(evaluate._preds_from_det(tokens, det_k, info_by_token), val)
        assert sorted(sub["results"]) == sorted(tokens), sorted(sub["results"])
        sub_err = 0.0
        for tok in tokens:
            a = np.sort([d["detection_score"] for d in sub["results"][tok]])
            b = np.sort([d["detection_score"] for d in mine["results"][tok]])
            assert a.shape == b.shape, (tok, a.shape, b.shape)
            sub_err = max(sub_err, float(np.abs(a - b).max()) if len(a) else 0.0)
        log(f"  the CLI's metrics equal evaluate_model's as printed; its submission holds {len(sub['results'])} "
            f"tokens (one per val sample), {sum(len(v) for v in sub['results'].values())} boxes in range, each "
            f"token's sorted scores within {sub_err:.3e} of this process's (SUBMISSION_TOL {SUBMISSION_TOL})")
        assert sub_err <= SUBMISSION_TOL, "the CLI's detections differ from evaluate_model's"

        # -- the host's data cost beside the card's --------------------------
        times.update(loader_cost(torch, cfg, model, ds, card))
        log(f"  the CLI: {times['cli_samples_per_s']} samples/s, {cli_wall:.3f} s with its start [{card}]")
        del model
        torch.cuda.empty_cache()

        # -- PETRv2 streamed through the CLI -------------------------------
        v2 = get_config(PETRV2)
        L2 = v2.model.head.num_layers
        log(f"phase 10: {PETRV2} streamed over the same val scenes (random weights, seed {SEED}, as cli.test builds "
            "without --ckpt)")
        out, v2_wall = run_cli(["--streaming", "--config", PETRV2, "--infos", val_pkl, "--classes", EVAL_CLASSES],
                               "the CLI, streaming")
        assert "streaming: 4/6 frames served from the feature cache" in out, out
        model = build_detector(v2, seed=SEED, device="cuda")
        ds2 = NuScenesDataset(val, v2.data, training=False)
        frames = []
        head = model.forward_head

        def recording_head(*args, **kwargs):
            result = head(*args, **kwargs)
            frames.append(result)
            return result

        model.forward_head = recording_head
        ca.LAUNCHES = ca.LAUNCHES_FP32 = 0
        try:
            preds, n_frames, stream_wall = run_streaming_inference(v2, model, ds2, device="cuda")
        finally:
            del model.forward_head
        stream_launches = {"K1": ca.LAUNCHES, "K1 fp32": ca.LAUNCHES_FP32}
        log(f"  this process: {n_frames} frames in {stream_wall:.4f} s; K1 launches {stream_launches} (expected "
            f"{L2} bf16 per frame at L = {LV2}, 0 fp32)")
        assert stream_launches == {"K1": L2 * n_frames, "K1 fp32": 0}, stream_launches
        stream_metrics = evaluate_detections(ground_truth_from_infos(val), preds, classes=classes)
        assert printed_metrics(out) == {k: f"{v:.4f}" for k, v in stream_metrics.items()}, (
            printed_metrics(out), stream_metrics)
        eval2 = make_eval_step(v2)
        index = {i["token"]: k for k, i in enumerate(val)}
        for tok, got in zip(preds, frames):
            b = collate_batch([ds2.get(index[tok], seed=index[tok])])
            with torch.inference_mode():
                full = model(*[torch.as_tensor(b[k]).cuda() for k in ("images", "img2lidar", "img_hw")],
                             timestamp=torch.as_tensor(b["timestamp"]).cuda())
            compare_outputs(torch, f"{tok}: streaming frame vs the 12-view forward", got, full, ROUTE_TOL,
                            ROUTE_MEAN, (L2, 1, v2.model.head.num_query))
            det = {k: v.cpu().numpy() for k, v in eval2(model, b).items()}
            mine = decode_last_layer(v2, got)
            a, c = np.sort(mine["scores"][0].cpu().numpy()), np.sort(det["scores"][0])
            err = np.abs(a - c).max()
            assert err <= STREAM_SCORE_TOL, f"{tok}: the streamed decode's scores are {err} from the eval step's"
        log(f"  every frame's outputs held to the 12-view eval forward of the same sample under ROUTE_TOL, its "
            f"decoded scores to make_eval_step's within STREAM_SCORE_TOL {STREAM_SCORE_TOL}; metrics as the CLI "
            f"printed: {', '.join(f'{k} {v:.6f}' for k, v in stream_metrics.items())}")
        times.update({"stream_frames_per_s": n_frames / stream_wall, "stream_cli_wall_s": v2_wall})
        del model
        torch.cuda.empty_cache()
    return launches["K1"] // len(val), stream_launches["K1"] // n_frames, times


# Phase 11: training from the command line on synthetic scenes rendered by
# the port at the recipes' 128x320, seed SEED: 6 scenes of 4 frames, 6
# objects each, 1 held out (20 train and 4 val samples). The learning runs
# themselves (4,000 and 8,000 steps) are single commands of their own
# (PERF.md §6); this phase drives their entry points briefly and projects
# their wall time.
SYNTH_SCENES = dict(n_scenes=6, frames_per_scene=4, n_objects=6, val_scenes=1, seed=SEED)
SYNTH_HW = (128, 320)
SYNTH_VOV, SYNTH_R50 = "synth_small", "synth_small_r50dcn"
HARNESS_STEPS = 30  # the harness's run: its JSON line, a loss that fell, the warm-up's BN statistics
# the learning runs' steps, held-out val samples and intermediate evals
RECIPES = {SYNTH_VOV: dict(steps=4000, val_samples=24, evals=1),
           SYNTH_R50: dict(steps=8000, val_samples=24, evals=4)}
# phase 11's CLI runs: batch 2, so an epoch of the 20 train samples is 10 steps
CLI_BATCH = 2


def read_log(work):
    """``<work>/train_log.jsonl`` -> its records."""
    with open(f"{work}/train_log.jsonl") as f:
        return [json.loads(line) for line in f]


def check_batch_bn_remat(torch, cfg, batch):
    """One fp32 step of ``cfg`` with bn_mode="batch" from the same weights,
    remat on and off: the BN running statistics after it must be equal,
    and equal to one EMA of the step's batch moments (a BN that updated its
    statistics in the forward would fold them in again when a checkpointed
    block is recomputed)."""
    import dataclasses

    from petr_tpu_torch.train import create_train_state, make_grad_fn, make_train_step, step_generator

    bb = dataclasses.replace(cfg.model.backbone, bn_mode="batch")
    buffers = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb, remat=remat))
        state = create_train_state(c, SEED, 100, "cuda")
        make_train_step(c)(state, batch, step_generator(SEED, 0))
        buffers[remat] = dict(state.model.named_buffers())
    fresh = create_train_state(c, SEED, 100, "cuda")
    initial = {k: v.clone() for k, v in fresh.model.named_buffers()}
    moments = make_grad_fn(c)(fresh.model, batch, step_generator(SEED, 0))[4]
    m = bb.bn_momentum
    worst = {"remat": 0.0, "once": 0.0}
    for key, moment in moments.items():
        once = (1 - m) * initial[key] + m * moment
        worst["remat"] = max(worst["remat"], (buffers[True][key] - buffers[False][key]).abs().max().item())
        worst["once"] = max(worst["once"], ((buffers[True][key] - once).abs() / once.abs().clamp_min(1e-6)).max().item())
    log(f"  batch BN, {len(moments) // 2} layers: remat on vs off, max abs difference of the running "
        f"statistics {worst['remat']:.3e} (must be 0); against one EMA of the step's moments, max relative "
        f"error {worst['once']:.3e} (tol 1e-5)")
    assert worst["remat"] == 0.0, "batch BN: remat on and off give other running statistics"
    assert worst["once"] <= 1e-5, "batch BN: the running statistics are not one EMA of the batch moments"


def time_recipe(torch, name, train, val, card):
    """The harness's config of ``name`` at its batch of 4 on the rendered
    train samples: 3 epochs of 5 steps through the loader as the harness
    runs them (the first 3 steps not timed), each step between CUDA events;
    the loader's wait share; one profiler pass; an eval pass; the
    projected wall time of the learning run."""
    from petr_tpu_torch.data import Loader, NuScenesDataset
    from petr_tpu_torch.data.synthetic import SYNTH_CLASSES
    from petr_tpu_torch.tools.synth_train_eval import recipe_config
    from petr_tpu_torch.train import create_train_state, make_train_step, step_generator
    from petr_tpu_torch.train.evaluate import evaluate_model

    cfg = recipe_config(name, SYNTH_HW)
    loader = Loader(NuScenesDataset(train, cfg.data, training=True, src_hw=SYNTH_HW), 4, seed=SEED)
    state = create_train_state(cfg, SEED, RECIPES[name]["steps"], "cuda")
    step = make_train_step(cfg)
    events, waits, walls = [], [], []
    n = 0
    for epoch in range(3):
        batches = iter(loader.epoch(epoch))
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            t1 = time.perf_counter()
            if batch is None:
                break
            batch.pop("tokens")
            last = batch
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = step(state, batch, step_generator(SEED + 1, state.step))
            end.record()
            float(metrics["loss"])
            t2 = time.perf_counter()
            n += 1
            if n > 3:
                events.append((start, end))
                waits.append(t1 - t0)
                walls.append(t2 - t0)
    torch.cuda.synchronize()
    event_ms = statistics.median(s.elapsed_time(e) for s, e in events)
    wall_s = sum(walls) / len(walls)
    rows, _ = profiled_kernels(torch, lambda: step(state, last, step_generator(SEED + 1, state.step)), 3)
    dev_ms = sum(r[0] for r in rows)
    state.model.eval()
    t0 = time.perf_counter()
    ds_val = NuScenesDataset(val, cfg.data, training=False, src_hw=SYNTH_HW)
    evaluate_model(cfg, state.model, ds_val, batch_size=4, classes=SYNTH_CLASSES)
    eval_s_per_sample = (time.perf_counter() - t0) / len(val)
    recipe = RECIPES[name]
    projected = (recipe["steps"] * wall_s + recipe["evals"] * recipe["val_samples"] * eval_s_per_sample)
    t = {"step_event_ms": event_ms, "step_device_ms": dev_ms, "step_wall_ms": wall_s * 1e3,
         "busy_share": dev_ms / (wall_s * 1e3), "loader_wait_share": sum(waits) / sum(walls),
         "steps_per_s": 1.0 / wall_s, "eval_s_per_sample": eval_s_per_sample,
         "timed_steps": len(walls), f"projected_{recipe['steps']}_step_wall_s": projected}
    log(f"  {name} ({cfg.model.compute_dtype}, batch 4, {len(walls)} steps timed): step {event_ms:.2f} ms on "
        f"CUDA events, {dev_ms:.3f} ms of device time (one profiler pass, {sum(r[1] for r in rows)} launches), "
        f"{wall_s * 1e3:.2f} ms on the host's clock with the loader, busy {100 * t['busy_share']:.1f}%, "
        f"the loader's wait {100 * t['loader_wait_share']:.1f}%, {t['steps_per_s']:.2f} steps/s; an eval pass "
        f"{eval_s_per_sample * 1e3:.1f} ms per sample; projected wall time of the {recipe['steps']}-step run "
        f"({recipe['evals']} held-out evals of {recipe['val_samples']} samples): {projected:.0f} s [{card}]")
    log(f"    top kernels per step: " + "; ".join(f"{r[2][:60]} {r[0]:.3f} ms x{r[1]}" for r in rows[:6]))
    del state
    torch.cuda.empty_cache()
    return t


def check_learning(torch, ca, dcn, card):
    """Phase 11: training from the command line. Renders the synthetic set;
    holds batch BN's running statistics to one EMA with remat on and off;
    runs ``python -m petr_tpu_torch.cli.train`` on synth_small_r50dcn
    (bf16) in a process of its own with ``--eval-infos``, sends it SIGTERM
    after a logged step of its second epoch (exit 0 and a checkpoint at
    the step boundary), resumes it with ``--resume`` to that epoch's end;
    runs it again here for 3 steps, which must log the same losses and
    gradient norms bit for bit, counting K1, K2 and K4 launches per step
    (bf16 variants only), and synth_small (fp32 variants only); times both
    recipes; runs the harness (``tools.synth_train_eval``'s entry point, in
    this process) for HARNESS_STEPS steps with the BN warm-up."""
    import os
    import signal
    import tempfile

    import numpy as np

    from petr_tpu_torch.cli import train as cli_train
    from petr_tpu_torch.data import Loader, NuScenesDataset, generate_synthetic_scenes
    from petr_tpu_torch.models import resnet
    from petr_tpu_torch.tools import synth_train_eval
    from petr_tpu_torch.tools.synth_train_eval import recipe_config
    from petr_tpu_torch.train.checkpoint import latest_checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        splits = generate_synthetic_scenes(f"{tmp}/synth", image_hw=SYNTH_HW, **SYNTH_SCENES)
        times["render_s"] = time.perf_counter() - t0
        train, val = splits["train"], splits["val"]
        spe = len(train) // CLI_BATCH
        log(f"phase 11: rendered {SYNTH_SCENES['n_scenes']} scenes of {SYNTH_SCENES['frames_per_scene']} frames "
            f"at {SYNTH_HW[0]}x{SYNTH_HW[1]} (seed {SEED}, {SYNTH_SCENES['val_scenes']} held out): {len(train)} "
            f"train and {len(val)} val samples in {times['render_s']:.1f} s")
        assert len(train) == 20 and len(val) == 4, (len(train), len(val))

        log("phase 11: batch-moments BN (bn_mode=batch), one synth_small fp32 step with remat on and off")
        cfg = recipe_config(SYNTH_VOV, SYNTH_HW)
        batch = next(iter(Loader(NuScenesDataset(train, cfg.data, training=True, src_hw=SYNTH_HW), 4,
                                 seed=SEED).epoch(0)))
        batch.pop("tokens")
        check_batch_bn_remat(torch, cfg, batch)

        def train_args(work, config, *extra):
            return ["--config", config, "--infos", f"{tmp}/synth/synth_infos_train.pkl", "--work-dir", work,
                    "--batch-size", str(CLI_BATCH), "--epochs", "2", "--log-every", "1", "--seed", str(SEED),
                    *extra]

        work = f"{tmp}/run"
        args = train_args(work, SYNTH_R50, "--eval-infos", f"{tmp}/synth/synth_infos_val.pkl")
        log(f"phase 11: python -m petr_tpu_torch.cli.train {' '.join(args)}, SIGTERM once step {spe + 2} "
            f"(of {2 * spe}) is logged")
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "petr_tpu_torch.cli.train", *args], cwd=root,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        lines = []
        try:
            for line in proc.stdout:
                lines.append(line)
                if line.startswith('{"epoch"') and json.loads(line).get("step", 0) >= spe + 2:
                    proc.send_signal(signal.SIGTERM)
                    break
            out, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        lines.append(out)
        times["preempted_run_s"] = time.perf_counter() - t0
        for line in "".join(lines).splitlines():
            if not line.startswith('{"config"'):
                log(f"    | {line[:240]}")
        assert proc.returncode == 0, f"cli.train exited {proc.returncode} on SIGTERM:\n{err[-4000:]}"
        logged = read_log(work)
        stopped = max(r["step"] for r in logged if "loss" in r)
        assert f"checkpoint saved at step {stopped}; exiting on signal {int(signal.SIGTERM)}" in "".join(lines)
        assert spe < stopped < 2 * spe, stopped
        assert latest_checkpoint(f"{work}/ckpts").endswith(f"step_{stopped:08d}")
        val_first = [r for r in logged if "val/mAP" in r]
        assert len(val_first) == 1 and val_first[0]["step"] == spe
        log(f"  exit 0 after SIGTERM, checkpoint at step {stopped}, in {times['preempted_run_s']:.1f} s; the "
            f"first epoch's eval: mAP {val_first[0]['val/mAP']}, NDS {val_first[0]['val/NDS']}")

        log(f"phase 11: the same command with --resume, to the end of the interrupted epoch")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "petr_tpu_torch.cli.train", *args, "--resume"], cwd=root,
                              capture_output=True, text=True, timeout=600)
        times["resumed_run_s"] = time.perf_counter() - t0
        assert proc.returncode == 0, f"cli.train --resume exited {proc.returncode}:\n{proc.stderr[-4000:]}"
        resumed_line = [line for line in proc.stdout.splitlines() if line.startswith("resumed from")]
        log(f"    | {resumed_line[0] if resumed_line else 'no resumed-from line'}")
        assert resumed_line == [f"resumed from {work}/ckpts/step_{stopped:08d} at step {stopped}"], resumed_line
        logged = read_log(work)
        steps = [r["step"] for r in logged if "loss" in r]
        resumed = steps[steps.index(stopped) + 1:]
        # petr_tpu's semantics: the interrupted epoch is replayed from its start, the step count going on
        assert resumed == list(range(stopped + 1, stopped + 1 + spe)), resumed
        assert latest_checkpoint(f"{work}/ckpts").endswith(f"step_{stopped + spe:08d}")
        val_last = [r for r in logged if "val/mAP" in r][-1]
        assert val_last["step"] == stopped + spe and all(np.isfinite(v) for v in val_last.values())
        losses = [r["loss"] for r in logged if "loss" in r]
        assert all(np.isfinite(losses)), losses
        log(f"  resumed at step {stopped}, steps {resumed[0]}-{resumed[-1]} logged, checkpoint at step "
            f"{stopped + spe}, in {times['resumed_run_s']:.1f} s; loss {losses[0]:.4f} at step 1, "
            f"{losses[-1]:.4f} at step {resumed[-1]}; eval: mAP {val_last['val/mAP']}, NDS {val_last['val/NDS']}")
        times["cli_r50_steps_per_s"] = 1.0 / statistics.median(
            r["time_per_iter"] for r in logged if "loss" in r and 1 < r["step"] <= stopped)

        log("phase 11: cli.train again in this process, 3 steps: the same losses bit for bit; launches per step")
        shapes = []
        kept = resnet.modulated_deform_conv

        def recording(x, *a, **k):  # which DCN shape each launch takes
            shapes.append(tuple(x.shape))
            return kept(x, *a, **k)

        counters = ("LAUNCHES", "LAUNCHES_FP32", "DKDV_LAUNCHES", "DQ_LAUNCHES", "DKDV_LAUNCHES_FP32",
                    "DQ_LAUNCHES_FP32")
        launches = {}
        for name, n_steps in ((SYNTH_R50, 3), (SYNTH_VOV, 6)):
            rerun = f"{tmp}/rerun_{name}"
            resnet.modulated_deform_conv = recording
            for c in counters:
                setattr(ca, c, 0)
            dcn.LAUNCHES = dcn.LAUNCHES_FP32 = 0
            try:
                with torch_defaults(torch):  # as in a process of its own
                    cli_train.main(train_args(rerun, name, "--max-steps", str(n_steps)))
            finally:
                resnet.modulated_deform_conv = kept
            got = {c: getattr(ca, c) // n_steps for c in counters}
            got |= {"K4": dcn.LAUNCHES // n_steps, "K4_FP32": dcn.LAUNCHES_FP32 // n_steps}
            launches[name] = got
            log(f"  {name}: per step {json.dumps(got)}; DCN input shapes {sorted(set(shapes))}")
            again = read_log(rerun)
            if name == SYNTH_R50:
                first = {r["step"]: (r["loss"], r["grad_norm"]) for r in read_log(work) if "loss" in r}
                for r in again:
                    assert (r["loss"], r["grad_norm"]) == first[r["step"]], (
                        f"step {r['step']}: loss and grad_norm {r['loss']!r}, {r['grad_norm']!r} here, "
                        f"{first[r['step']]} in the first run")
                log(f"  steps 1-3 here and in the first run: the same loss and grad_norm bit for bit "
                    f"({', '.join(repr(r['loss']) for r in again)})")
                assert got == {"LAUNCHES": 6, "LAUNCHES_FP32": 0, "DKDV_LAUNCHES": 3, "DQ_LAUNCHES": 3,
                               "DKDV_LAUNCHES_FP32": 0, "DQ_LAUNCHES_FP32": 0, "K4": 18, "K4_FP32": 0}, got
                per_shape = {s: shapes.count(s) // n_steps for s in set(shapes)}
                launches["K4_by_shape"] = per_shape
                assert sorted(per_shape.values()) == [6, 12], per_shape
            else:
                assert got == {"LAUNCHES": 0, "LAUNCHES_FP32": 6, "DKDV_LAUNCHES": 0, "DQ_LAUNCHES": 0,
                               "DKDV_LAUNCHES_FP32": 3, "DQ_LAUNCHES_FP32": 3, "K4": 0, "K4_FP32": 0}, got
                times["cli_vov_steps_per_s"] = 1.0 / statistics.median(
                    r["time_per_iter"] for r in again if r["step"] > 1)
            shapes.clear()
        log(f"  the CLI at batch {CLI_BATCH}: {times['cli_r50_steps_per_s']:.2f} steps/s ({SYNTH_R50}), "
            f"{times['cli_vov_steps_per_s']:.2f} steps/s ({SYNTH_VOV}) [{card}]")

        log("phase 11: the learning recipes' step, timed at their batch of 4 (TF32 and cuDNN flags at torch's "
            "defaults, as in the runs' own processes)")
        for name in (SYNTH_VOV, SYNTH_R50):
            with torch_defaults(torch):
                times[name] = time_recipe(torch, name, train, val, card)

        args = ["--config", SYNTH_VOV, "--steps", str(HARNESS_STEPS), "--bn-warmup", "4", "--eval-every",
                str(HARNESS_STEPS // 2), "--floor", "0",
                "--scenes", str(SYNTH_SCENES["n_scenes"]), "--val-scenes", str(SYNTH_SCENES["val_scenes"]),
                "--out-dir", f"{tmp}/harness", "--save-ckpt", f"{tmp}/harness_ckpt"]
        log(f"phase 11: petr_tpu_torch.tools.synth_train_eval {' '.join(args)}, in this process")
        with torch_defaults(torch):  # as in the harness's own process
            stdout, times["harness_s"] = run_main(synth_train_eval, args, "the harness")
        rec = json.loads([line for line in stdout.splitlines() if line.startswith('{"steps"')][-1])
        metric_keys = {"mAP", "NDS", "mATE", "mASE", "mAOE", "mAVE", "mAAE", "AP_car", "AP_bus", "AP_pedestrian"}
        assert set(rec) == {"steps", "train_loss_first", "train_loss_last", "wall_s"} | {
            f"val/{k}" for k in metric_keys}, sorted(rec)
        assert all(np.isfinite(v) for v in rec.values()), rec
        assert rec["train_loss_last"] < rec["train_loss_first"], rec
        assert "bn-warmup: estimated BN stats from 4 batches" in stdout
        state = torch.load(f"{latest_checkpoint(f'{tmp}/harness_ckpt')}/state.pt", map_location="cpu",
                           weights_only=True)["model"]
        stats = {k: v for k, v in state.items() if k.endswith(("running_mean", "running_var"))}
        unchanged = [k for k, v in stats.items()
                     if torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else torch.ones_like(v))]
        log(f"  exit 0 in {times['harness_s']:.1f} s; loss {rec['train_loss_first']} -> {rec['train_loss_last']}; "
            f"{len(stats) - len(unchanged)} of {len(stats)} BN statistics moved off 0 / 1 by the warm-up "
            f"(frozen BN keeps them through training)")
        assert not unchanged, unchanged[:3]
    times["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 11: {times['phase_s']:.1f} s [{card}]")
    return launches, times


# Phase 12: parallel training over torch.distributed. Several ranks share the
# one card through Gloo (NCCL refuses two ranks on one device); NCCL runs at
# world size 1. PAR_SCENES renders an odd val split for the eval hook.
PAR_SCENES = dict(n_scenes=5, frames_per_scene=3, n_objects=6, val_scenes=1, seed=SEED)
PAR_GLOBAL_BATCH = 2
LAYOUTS = ((2, 1), (1, 2))  # (data, model): batch split, tokens split
# The 2-rank fp32 step against the 1-rank step on the same global batch: the
# same sums in another order (a shard's lse combine, the gradient mean), so
# phase 5's tolerances for kernels against plain versions hold.
PAR_LOSS_RTOL, PAR_NORM_RTOL = STEP_LOSS_RTOL, 1e-3
# The bf16 2-rank step against the 1-rank step: the ranks round other sums
# to bf16 (a batch of 1 takes other cuDNN algorithms; a key shard rounds its
# own output before the combine), and one bf16 step of a logit carries
# through 6 layers and can flip an assignment of the matcher: loss within
# 5e-2, grad_norm within 0.2 (relative); the parameters after AdamW's first
# step move by about lr each, so their mean difference is reported in lr.
PAR_BF16_LOSS, PAR_BF16_NORM, PAR_BF16_PARAM_LR = 5e-2, 0.2, 0.5
PAR_EVAL_TOL = 1e-6


def flagship_cfg(dtype):
    import dataclasses

    from petr_tpu_torch.configs import get_config

    cfg = get_config(FLAGSHIP)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype))


def par_batch(cfg):
    """The global batch of 2 of the flagship's parallel steps."""
    import numpy as np

    batches = [make_train_batch(cfg, SEED + 20 + i) for i in range(PAR_GLOBAL_BATCH)]
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def forwards(torch, cfg, model, batch):
    """(eval-mode outputs, train-mode outputs with step 0's noise) of
    ``model`` on ``batch``, without gradient, as CPU fp32 tensors."""
    from petr_tpu_torch.models import draw_train_noise
    from petr_tpu_torch.train import step_generator

    b = {k: torch.as_tensor(v).to(next(model.parameters()).device) for k, v in batch.items()}
    outs = []
    with torch.no_grad():
        for train in (False, True):
            model.train(train)
            noise = draw_train_noise(cfg.model, b["images"].shape[2], step_generator(SEED, 0)) if train else None
            out = model(b["images"], b["img2lidar"], b["img_hw"], noise=noise)
            outs.append({k: out[k].float().cpu() for k in ("cls_logits", "bbox_codes")})
    model.train()
    return outs


def reset_state(state, cfg, initial):
    """``state`` back at its initial weights with a fresh AdamW at step 0."""
    from petr_tpu_torch.train.optim import build_optimizer

    state.model.load_state_dict(initial)
    state.model.train()
    state.optimizer = build_optimizer(cfg.train.optim, state.model,
                                      freeze_backbone_bn_affine=not cfg.model.backbone.train_bn_affine)
    state.step = 0
    return state


def par_reference(torch, path, card):
    """The 1-rank references of the flagship's parallel steps, saved to
    ``path``: per dtype the forwards, the step's loss, grad_norm and
    parameters after it, and (fp32) the gradients; and the 1-rank bf16
    step's time."""
    from petr_tpu_torch.train import create_train_state, make_grad_fn, make_train_step, step_generator

    ref = {}
    for dtype in ("bfloat16", "float32"):
        cfg = flagship_cfg(dtype)
        batch = par_batch(cfg)
        state = create_train_state(cfg, SEED, 1000, "cuda")
        initial = {k: v.clone() for k, v in state.model.state_dict().items()}
        r = {}
        r["eval_out"], r["train_out"] = forwards(torch, cfg, state.model, batch)
        if dtype == "float32":
            total, _, grads, idx, _ = make_grad_fn(cfg)(state.model, batch, step_generator(SEED, 0))
            r.update(total=total.item(), grads={n: g.cpu() for n, g in grads.items()}, assignment=idx)
        reset_state(state, cfg, initial)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        _, m = make_train_step(cfg)(state, batch, step_generator(SEED, 0))
        end.record()
        end.synchronize()
        r.update(loss=m["loss"].item(), grad_norm=m["grad_norm"].item(), step_ms=start.elapsed_time(end),
                 step_host_ms=(time.perf_counter() - h0) * 1e3, lr=state.lr_schedule(0),
                 params={n: p.detach().cpu() for n, p in state.model.named_parameters()})
        log(f"  1-rank {dtype} step on the global batch of {PAR_GLOBAL_BATCH}: loss {r['loss']:.6f}, grad_norm "
            f"{r['grad_norm']:.4f}, {r['step_ms']:.2f} ms on CUDA events (host {r['step_host_ms']:.2f} ms, "
            f"first step) [{card}]")
        ref[dtype] = r
        del state, initial
        torch.cuda.empty_cache()
    torch.save(ref, path)


def _compare_out(name, got, want, dtype):
    """Forward outputs of a rank against the 1-rank rows: per output atol +
    rtol x |ref| and a limit on the mean (FP32_ROUTE_* in fp32, ROUTE_* in
    bf16) -> (max abs err, mean abs err) per output."""
    tol, mean_tol = (FP32_ROUTE_TOL, FP32_ROUTE_MEAN) if dtype == "float32" else (ROUTE_TOL, ROUTE_MEAN)
    errs = {}
    for k in ("cls_logits", "bbox_codes"):
        err = (got[k] - want[k]).abs()
        atol, rtol = tol[k]
        bad = int((err > atol + rtol * want[k].abs()).sum())
        errs[k] = (err.max().item(), err.mean().item())
        assert bad == 0 and errs[k][1] <= mean_tol, (
            f"{name} {k}: {bad} outputs out of tolerance, max {errs[k][0]:.3e}, mean {errs[k][1]:.3e}")
    return errs


class CollectiveClock:
    """Host time inside ``torch.distributed.all_reduce``, the card
    synchronised before and after each call (the share of a step spent in
    collectives; the synchronisations make the step itself slower)."""

    def __init__(self, torch):
        self.torch, self.ms, self.calls, self.kept = torch, 0.0, 0, None

    def __enter__(self):
        dist = self.torch.distributed
        self.kept = dist.all_reduce

        def timed(*a, **k):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.kept(*a, **k)
            self.torch.cuda.synchronize()
            self.ms += (time.perf_counter() - t0) * 1e3
            self.calls += 1
            return out

        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self.torch.distributed.all_reduce = self.kept


def par_flagship_rank(rank, world, device, ref_path):
    """One rank of the flagship's parallel steps (``chip_smoke.py`` phase
    12b, c): per dtype and layout, the step from the initial weights on
    this rank's share of the global batch, held to the 1-rank references."""
    import torch

    from petr_tpu_torch.ops import cross_attention as ca
    from petr_tpu_torch.parallel.mesh import make_mesh, shard_batch, use_mesh
    from petr_tpu_torch.train import create_train_state, make_grad_fn, make_train_step, step_generator
    from petr_tpu_torch.train.train_step import data_mean_grads

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    # the lse combine's shift: an all-reduce (MAX) of CUDA tensors, which Gloo stages through the host
    got = torch.tensor([float(rank), -float(rank), 1e30 if rank else -1e30], device=device)
    torch.distributed.all_reduce(got, op=torch.distributed.ReduceOp.MAX)
    want = torch.tensor([float(world - 1), 0.0, 1e30], device=device)
    assert torch.equal(got, want), f"rank {rank}: all-reduce MAX on {device} gave {got.tolist()}"
    ref = torch.load(ref_path, weights_only=False)
    counters = ("LAUNCHES", "DKDV_LAUNCHES", "DQ_LAUNCHES", "LAUNCHES_FP32", "DKDV_LAUNCHES_FP32",
                "DQ_LAUNCHES_FP32")
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = flagship_cfg(dtype)
        batch = par_batch(cfg)
        r = ref[dtype]
        state = create_train_state(cfg, SEED, 1000, device)
        initial = {k: v.clone() for k, v in state.model.state_dict().items()}
        for data, model in LAYOUTS:
            mesh = make_mesh(world, data=data, model=model)
            local = shard_batch(batch, mesh)
            b0 = mesh.batch_rows(PAR_GLOBAL_BATCH // data)[1]
            b1 = b0 + PAR_GLOBAL_BATCH // data
            rec = {}
            with use_mesh(mesh):
                got = forwards(torch, cfg, state.model, local)
            for what, g, w in zip(("eval", "train"), got, (r["eval_out"], r["train_out"])):
                rec[f"{what}_forward"] = _compare_out(f"rank {rank} ({data}, {model}) {dtype} {what} forward", g,
                                                      {k: v[:, b0:b1] for k, v in w.items()}, dtype)
            if dtype == "float32":
                total, _, grads, idx, _ = make_grad_fn(cfg, mesh)(state.model, local, step_generator(SEED, 0))
                grads = data_mean_grads(grads, mesh)
                assert (idx == r["assignment"][:, b0:b1]).all(), f"rank {rank}: the assignment differs"
                top = max(g.abs().max().item() for g in r["grads"].values())
                rel = {}
                for n, g in grads.items():
                    w = r["grads"][n].to(device)
                    rel[n] = (g - w).abs().max().item() / max(w.abs().max().item(), STEP_GRAD_FLOOR * top)
                worst = max(rel.items(), key=lambda kv: kv[1])
                rec["grads"] = {"median": statistics.median(rel.values()), "worst": worst}
                assert worst[1] <= STEP_GRAD_RTOL, f"rank {rank} ({data}, {model}) fp32: gradient {worst}"
                reset_state(state, cfg, initial)
            for c in counters:
                setattr(ca, c, 0)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            start.record()
            _, m = make_train_step(cfg, mesh)(state, local, step_generator(SEED, 0))
            end.record()
            end.synchronize()
            rec["step_ms"], rec["step_host_ms"] = start.elapsed_time(end), (time.perf_counter() - h0) * 1e3
            rec["launches"] = {c: getattr(ca, c) for c in counters}
            rec["loss"], rec["grad_norm"] = m["loss"].item(), m["grad_norm"].item()
            rec["loss_err"] = abs(rec["loss"] - r["loss"]) / abs(r["loss"])
            rec["norm_err"] = abs(rec["grad_norm"] - r["grad_norm"]) / r["grad_norm"]
            diffs = [(p.detach().cpu() - r["params"][n]).abs() for n, p in state.model.named_parameters()]
            rec["param_max_lr"] = max(d.max().item() for d in diffs) / r["lr"]
            rec["param_mean_lr"] = sum(d.sum().item() for d in diffs) / sum(d.numel() for d in diffs) / r["lr"]
            if dtype == "bfloat16":  # two more steps: the step's time and its share in collectives
                times = []
                with CollectiveClock(torch) as clock:
                    for i in (1, 2):
                        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        h0 = time.perf_counter()
                        s.record()
                        make_train_step(cfg, mesh)(state, local, step_generator(SEED, i))
                        e.record()
                        e.synchronize()
                        times.append(((time.perf_counter() - h0) * 1e3, s.elapsed_time(e)))
                rec["timed_host_ms"] = [t[0] for t in times]
                rec["timed_event_ms"] = [t[1] for t in times]
                rec["collective_ms"], rec["collective_calls"] = clock.ms / 2, clock.calls // 2
            out[(dtype, data, model)] = rec
            reset_state(state, cfg, initial)
        del state, initial
        torch.cuda.empty_cache()
    return out


def check_k3_shard(torch, ca, sm_clock_hz, card):
    """K3 at the token-sharded flagship's shard shapes: H=8, Q=900, the
    second of two shards of L = 6,000 (L = 3,000 with its key offset and a
    padded tail), dropout 0.1 and a non-zero lse cotangent; B=2, the rows
    each rank holds in phase 12c (the bf16 forward on the 64-row plan where
    the card has at most 15 * 16 SMs), and B=1 (the 32-row plan). The
    kernels against the plain route through the same Function, fp32 and
    bf16; the bf16 forward and backward timed beside the plain route and
    SDPA. The record's numbers are B=2's, the shape whose launches it
    reports; B=1's are under ``b1``."""
    import torch.nn.functional as F

    H, Q, L, D = 8, 900, 6000, 32
    Ls = L // 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    shapes = {}
    for B in (PAR_GLOBAL_BATCH, 1):
        plan = ca.attention_plan(B * H, Q, sms)
        log(f"phase 12: K3 (flash_cross_attention_with_lse) at the shard shape B={B} H={H} Q={Q} L={Ls} D={D}, "
            f"key offset {Ls}, dropout {DROPOUT}, lse cotangent N(0, 1); bf16 forward on the {16 * plan}-row "
            f"plan (query_warps {plan}, {sms} SMs)")
        errs, fn_ms = {}, {"query_warps": plan}
        for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            q, k, v, m = attention_inputs(torch, gen, B, dtype, H, Q, L, D)
            k, v, m = k[:, :, Ls:], v[:, :, Ls:], m[:, Ls:]
            gout = torch.randn(B, H, Q, D, generator=gen, device="cuda").to(dtype)
            glse = torch.randn(B, H, Q, generator=gen, device="cuda")

            def run(fn):
                qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
                out, lse = fn(qs, ks, vs, m, DROPOUT, DROP_SEED, (0, Ls))
                loss = (out.float() * gout.float()).sum() + (torch.where(lse < 1e29, lse, 0.0) * glse).sum()
                return (out, lse, *torch.autograd.grad(loss, (qs, ks, vs)))

            def plain_route(*a):
                return ca.flash_cross_attention_plain(*a[:6], lse_grad=True, dropout_offsets=a[6])

            kern = run(ca.flash_cross_attention_with_lse)
            plain = run(plain_route)
            (ok, ol, *kg), (po, pl, *pg) = kern, plain
            atol, rtol = K1_FP32_TOL if tag == "fp32" else K1_BF16_TOL
            err = (ok.float() - po.float()).abs()
            assert (err <= atol + rtol * po.float().abs()).all(), f"K3 B={B} {tag} out: max err {err.max().item():.3e}"
            lse_err = (ol - pl).abs().max().item()
            assert lse_err <= 1e-3, f"K3 B={B} {tag} lse: {lse_err:.3e}"
            errs[tag] = {"out": err.max().item(), "lse": lse_err}
            for g_name, g, w in zip(("dq", "dk", "dv"), kg, pg):
                g, w = g.float(), w.float()
                atol, rtol = BWD_TOL[tag]
                e = (g - w).abs()
                assert (e <= atol * w.abs().max() + rtol * w.abs()).all(), (
                    f"K3 B={B} {tag} {g_name}: max err {e.max().item():.3e}")
                errs[tag][g_name] = e.max().item()
            log(f"  {tag}: max abs err against the plain route: "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs[tag].items()))
            if tag == "bf16":
                def k3():
                    run(ca.flash_cross_attention_with_lse)
                fn_ms["ms"] = cuda_time_ms(k3)
                fn_ms["device_ms"] = device_ms(torch, k3)
                fn_ms["plain_ms"] = cuda_time_ms(lambda: run(plain_route), warmup=2, iters=10)
                qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))

                def sdpa():
                    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=~m[:, None, None, :])
                    torch.autograd.grad(out, (qs, ks, vs), gout)
                fn_ms["library_ms"] = cuda_time_ms(sdpa)
                fn_ms["library_device_ms"] = device_ms(torch, sdpa)
                pairs = H * Q * int((~m).sum())
                e = 2
                nbytes = (e * B * H * D * (2 * Q + 2 * Ls) + 4 * B * H * Q + B * Ls  # forward
                          + e * B * H * D * (3 * Q + 4 * Ls) + 8 * B * H * Q + B * Ls)  # backward
                # 14 D flops per pair (q.k and p.v forward; s, dp, dv, dq, dk backward), 2 exps per pair
                fn_ms["bound_ms"], fn_ms["bound_by"], parts = bound_ms(2 * pairs, 7.0 * D, nbytes, sms, sm_clock_hz)
                log(f"  bf16 forward + backward: {fn_ms['ms']:.4f} ms on CUDA events, {fn_ms['device_ms']:.4f} ms "
                    f"of device time; plain route {fn_ms['plain_ms']:.4f}; SDPA forward + backward (no lse: no "
                    f"public PyTorch call returns a differentiable lse) {fn_ms['library_ms']:.4f} "
                    f"({fn_ms['library_device_ms']:.4f} device); bound_ms {fn_ms['bound_ms']:.4f} "
                    f"({fn_ms['bound_by']}, {json.dumps({k: round(v, 5) for k, v in parts.items()})}) [{card}]")
        shapes[B] = {"shape": {"B": B, "H": H, "Q": Q, "L": Ls, "D": D, "key_offset": Ls},
                     "max_abs_err": max(errs["bf16"].values()), "fp32_max_abs_err": max(errs["fp32"].values()),
                     **fn_ms}
    return {
        "name": "flash_cross_attention_with_lse_shard",
        "route": "cuda",
        "source": "petr_tpu_torch/csrc/flash_cross_attention.cu, petr_tpu_torch/csrc/flash_cross_attention_bwd.cu",
        "replaces": "petr_tpu/ops/pallas/cross_attention.py:402::flash_cross_attention_with_lse",
        "launches": None,  # filled from the token-sharded step (phase 12c), whose ranks hold B=2
        **shapes[PAR_GLOBAL_BATCH],
        "b1": shapes[1],
        "library_note": "SDPA forward and backward without the lse (no public PyTorch call returns it differentiably)",
    }


def run_ranks(root, args, label, env, signal_after=None, timeout=900):
    """``python -m petr_tpu_torch.cli.train ARGS`` as ranks 0..n-1 (one
    argument list per rank) from this script's directory; with
    ``signal_after``, SIGTERM every rank once rank 0 logged that step.
    Every rank must exit 0. Returns each rank's stdout."""
    import signal

    procs = [subprocess.Popen([sys.executable, "-m", "petr_tpu_torch.cli.train", *a], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for a in args]
    outs = []
    try:
        if signal_after is not None:
            lines = []
            for line in procs[0].stdout:
                lines.append(line)
                if line.startswith('{"epoch"') and json.loads(line).get("step", 0) >= signal_after:
                    for p in procs:
                        p.send_signal(signal.SIGTERM)
                    break
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(("".join(lines) if (i == 0 and signal_after is not None) else "") + out)
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if not line.startswith('{"config"'):
                log(f"    {label} rank {i} | {line[:240]}")
        assert p.returncode == 0, f"{label}: rank {i} exited {p.returncode}"
    return outs


def check_parallel(torch, ca, sm_clock_hz, card):
    """Phase 12: parallel training and evaluation over torch.distributed."""
    import os
    import tempfile

    import numpy as np

    from petr_tpu_torch.data import NuScenesDataset, generate_synthetic_scenes
    from petr_tpu_torch.models import PETRDetector
    from petr_tpu_torch.parallel.distributed import free_port, spawn
    from petr_tpu_torch.parallel.dryrun import dryrun_multichip
    from petr_tpu_torch.train.checkpoint import latest_checkpoint
    from petr_tpu_torch.train.evaluate import evaluate_model

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    t_phase = time.perf_counter()
    times = {}
    k3 = check_k3_shard(torch, ca, sm_clock_hz, card)
    with tempfile.TemporaryDirectory() as tmp:
        log(f"phase 12b, c: {FLAGSHIP} at full width, global batch {PAR_GLOBAL_BATCH}, dropout {DROPOUT}, GridMask, "
            f"remat, bf16 and fp32: the 1-rank references")
        ref_path = f"{tmp}/par_ref.pt"
        t0 = time.perf_counter()
        par_reference(torch, ref_path, card)
        ref = torch.load(ref_path, weights_only=False)
        times["reference_s"] = time.perf_counter() - t0
        log(f"phase 12b, c: 2 ranks on the card (gloo), layouts (data, model) {LAYOUTS}: each rank's step from "
            f"the same weights on its share, every count reset just before the step")
        t0 = time.perf_counter()
        ranks = spawn(par_flagship_rank, 2, "gloo", "cuda", args=(ref_path,))
        times["ranks_s"] = time.perf_counter() - t0
        L = flagship_cfg("bfloat16").model.head.num_layers
        want = {"bfloat16": {"LAUNCHES": 2 * L, "DKDV_LAUNCHES": L, "DQ_LAUNCHES": L, "LAUNCHES_FP32": 0,
                             "DKDV_LAUNCHES_FP32": 0, "DQ_LAUNCHES_FP32": 0},
                "float32": {"LAUNCHES": 0, "DKDV_LAUNCHES": 0, "DQ_LAUNCHES": 0, "LAUNCHES_FP32": 2 * L,
                            "DKDV_LAUNCHES_FP32": L, "DQ_LAUNCHES_FP32": L}}
        layout_times = {}
        for (dtype, data, model), _ in sorted(ranks[0].items()):
            name = f"{dtype} data {data} x model {model}"
            r = ref[dtype]
            for rank, recs in enumerate(ranks):
                rec = recs[(dtype, data, model)]
                log(f"  {name}, rank {rank}: launches {rec['launches']}; loss {rec['loss']:.6f} (1-rank "
                    f"{r['loss']:.6f}, rel err {rec['loss_err']:.2e}), grad_norm {rec['grad_norm']:.4f} (1-rank "
                    f"{r['grad_norm']:.4f}, rel err {rec['norm_err']:.2e}); parameters after the step: mean "
                    f"|diff| {rec['param_mean_lr']:.4f} lr, max {rec['param_max_lr']:.4f} lr")
                for what in ("eval", "train"):
                    log(f"    {what} forward against the 1-rank rows: " + ", ".join(
                        f"{k} max {a:.3e} mean {b:.3e}" for k, (a, b) in rec[f"{what}_forward"].items()))
                if "grads" in rec:
                    log(f"    fp32 gradients (mean over the data group) against the 1-rank step: median "
                        f"{rec['grads']['median']:.2e}, worst {rec['grads']['worst'][0]} {rec['grads']['worst'][1]:.2e} "
                        f"(tol {STEP_GRAD_RTOL})")
                assert rec["launches"] == want[dtype], (name, rank, rec["launches"])
                if dtype == "float32":
                    assert rec["loss_err"] <= PAR_LOSS_RTOL and rec["norm_err"] <= PAR_NORM_RTOL, (name, rank)
                else:
                    assert rec["loss_err"] <= PAR_BF16_LOSS and rec["norm_err"] <= PAR_BF16_NORM, (name, rank)
                    assert rec["param_mean_lr"] <= PAR_BF16_PARAM_LR, (name, rank, rec["param_mean_lr"])
                    share = rec["collective_ms"] / statistics.median(rec["timed_host_ms"])
                    log(f"    step time, ranks sharing one card: first step {rec['step_ms']:.2f} ms on CUDA events "
                        f"({rec['step_host_ms']:.2f} host); then {', '.join(f'{t:.2f}' for t in rec['timed_event_ms'])} "
                        f"ms on events, {', '.join(f'{t:.2f}' for t in rec['timed_host_ms'])} host, with "
                        f"{rec['collective_ms']:.2f} ms in {rec['collective_calls']} all-reduces per step "
                        f"({100 * share:.1f}% of the host step; synchronised around each) [{card}]")
                    layout_times.setdefault(f"data{data}_model{model}", []).append(
                        {"first_ms": rec["step_ms"], "events_ms": rec["timed_event_ms"],
                         "host_ms": rec["timed_host_ms"], "collective_ms": rec["collective_ms"],
                         "collective_share": share})
            assert ranks[0][(dtype, data, model)]["loss"] == ranks[1][(dtype, data, model)]["loss"], name
        times["layouts"] = layout_times
        times["one_rank_step_ms"] = ref["bfloat16"]["step_ms"]
        k3["launches"] = ranks[0][("bfloat16", 1, 2)]["launches"]["LAUNCHES"]
        k3["launches_per_rank"] = [recs[("bfloat16", 1, 2)]["launches"] for recs in ranks]
        k3["launches_note"] = "per rank per bf16 step of the token-sharded flagship (data 1 x model 2): K1 + K2 as K3"
        del ref

        log("phase 12d: dryrun_multichip(4): 4 ranks on the card (gloo), data 2 x model 2, tiny shapes")
        t0 = time.perf_counter()
        rec = dryrun_multichip(4, device="cuda", backend="gloo", model=2)
        times["dryrun_s"] = time.perf_counter() - t0
        assert tuple(rec["mesh"]) == (2, 2) and np.isfinite(rec["loss"]), rec
        log(f"  mesh {rec['mesh']}, loss {rec['loss']:.4f}, grad_norm {rec['grad_norm']:.4f} in {times['dryrun_s']:.1f} s")

        splits = generate_synthetic_scenes(f"{tmp}/synth", image_hw=SYNTH_HW, **PAR_SCENES)
        n_train, n_val = len(splits["train"]), len(splits["val"])
        assert n_val % 2 == 1, n_val
        infos = f"{tmp}/synth/synth_infos_train.pkl"
        val = f"{tmp}/synth/synth_infos_val.pkl"

        def cli_args(work, port, n, rank, backend, *extra):
            return ["--config", SYNTH_VOV, "--infos", infos, "--work-dir", work, "--log-every", "1",
                    "--seed", str(SEED), "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
                    "--process-id", str(rank), "--dist-backend", backend, *extra]

        log(f"phase 12a: cli.train over NCCL at world size 1 ({SYNTH_VOV}, {n_train} train samples at "
            f"{SYNTH_HW[0]}x{SYNTH_HW[1]}, 2 steps)")
        work = f"{tmp}/nccl"
        out = run_ranks(root, [cli_args(work, free_port(), 1, 0, "nccl", "--batch-size", "2", "--max-steps", "2")],
                        "nccl", env)[0]
        envline = json.loads([x for x in out.splitlines() if x.startswith('{"env"')][0])["env"]
        assert envline["backend"] == "nccl" and envline["processes"] == 1, envline
        assert [r["step"] for r in read_log(work) if "loss" in r] == [1, 2]
        assert latest_checkpoint(f"{work}/ckpts").endswith("step_00000002")

        spe = n_train // 2 // 2
        log(f"phase 12e: cli.train over 2 gloo ranks on the card, global batch 4, 3 epochs, eval hook on the "
            f"{n_val} val samples (odd: the ranks decode 2 and 1), both ranks sent SIGTERM once rank 0 logged step "
            f"{spe + 1}, the first of the second epoch")
        work = f"{tmp}/two"
        port = free_port()
        t0 = time.perf_counter()
        outs = run_ranks(root, [cli_args(work, port, 2, r, "gloo", "--batch-size", "4", "--epochs", "3",
                                         "--eval-infos", val) for r in range(2)], "2 ranks", env,
                         signal_after=spe + 1)
        times["cli_2rank_s"] = time.perf_counter() - t0
        assert "epoch 0 done; checkpoint saved" in outs[0] and "checkpoint saved" not in outs[1]
        assert '{"env"' in outs[0] and '{"env"' not in outs[1] and '{"epoch"' not in outs[1]
        logged = read_log(work)
        stopped = max(r["step"] for r in logged if "loss" in r)
        assert spe < stopped < 3 * spe, (stopped, spe)
        assert [r["step"] for r in logged if "loss" in r] == list(range(1, stopped + 1)), logged
        vals = [r for r in logged if "val/mAP" in r]
        assert len(vals) == 1 and vals[0]["step"] == spe, vals
        ckpt = f"{work}/ckpts/step_{spe:08d}"
        assert os.path.isdir(ckpt), os.listdir(f"{work}/ckpts")
        from petr_tpu_torch.configs import get_config

        cfg = get_config(SYNTH_VOV)
        model = PETRDetector(cfg.model)
        model.load_state_dict(torch.load(f"{ckpt}/state.pt", map_location="cpu", weights_only=True)["model"])
        with torch_defaults(torch):
            torch.backends.cudnn.deterministic = True  # as create_train_state leaves the CLI's processes
            single = evaluate_model(cfg, model.cuda().eval(), NuScenesDataset.from_pkl(val, cfg.data, training=False))
        diff = max(abs(vals[0][f"val/{k}"] - v) for k, v in single.items() if np.isfinite(v))
        log(f"  2-rank eval hook against evaluate_model of {ckpt} in this process: max |diff| {diff:.3e} over "
            f"{len(single)} metrics (tol {PAR_EVAL_TOL}); mAP {single['mAP']:.4f}, NDS {single['NDS']:.4f}")
        assert diff <= PAR_EVAL_TOL, diff
        assert all((np.isfinite(vals[0][f"val/{k}"]) == np.isfinite(v)) for k, v in single.items())
        assert f"checkpoint saved at step {stopped}; exiting on signal" in outs[0], outs[0][-2000:]
        assert f"rank 1: stopping at step {stopped}" in outs[1], outs[1][-2000:]
        assert latest_checkpoint(f"{work}/ckpts").endswith(f"step_{stopped:08d}")
        log(f"  both ranks exit 0 at step {stopped} (of {3 * spe}); rank 0 checkpointed there")
    times["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12: {times['phase_s']:.1f} s (the 1-rank references {times['reference_s']:.1f} s, the ranks' steps "
        f"{times['ranks_s']:.1f} s, the dryrun {times['dryrun_s']:.1f} s, the 2-rank CLI {times['cli_2rank_s']:.1f} s) "
        f"[{card}]")
    return k3, times


# Phase 13: the deployment path. K6 (the int8 conv with int32 sums) at every
# conv shape of the flagship's V-99 backbone (6 views at 320x800: input
# planes below), then the int8 flagship end to end, cli.test's new options,
# the AOT artifacts and PETRv2's streaming pair.
PEAK_INT8_OPS = 1979e12
INT8_SHAPES = {  # label: ((Cin, H, W, Co, kernel, stride) of the conv's input, launches per flagship forward)
    "stem1": ((3, 320, 800, 64, 3, 2), 1),
    "stem2": ((64, 160, 400, 64, 3, 1), 1),
    "stem3": ((64, 160, 400, 128, 3, 2), 1),
    "s2": ((128, 80, 200, 128, 3, 1), 5),
    "s2 concat": ((768, 80, 200, 256, 1, 1), 1),
    "s3 in256": ((256, 40, 100, 160, 3, 1), 1),
    "s3 in512": ((512, 40, 100, 160, 3, 1), 2),
    "s3": ((160, 40, 100, 160, 3, 1), 12),
    "s3 concat1056": ((1056, 40, 100, 512, 1, 1), 1),
    "s3 concat1312": ((1312, 40, 100, 512, 1, 1), 2),
    "s4 in512": ((512, 20, 50, 192, 3, 1), 1),
    "s4 in768": ((768, 20, 50, 192, 3, 1), 8),
    "s4": ((192, 20, 50, 192, 3, 1), 36),
    "s4 concat1472": ((1472, 20, 50, 768, 1, 1), 1),
    "s4 concat1728": ((1728, 20, 50, 768, 1, 1), 8),
    "s5 in768": ((768, 10, 25, 224, 3, 1), 1),
    "s5 in1024": ((1024, 10, 25, 224, 3, 1), 2),
    "s5": ((224, 10, 25, 224, 3, 1), 12),
    "s5 concat1888": ((1888, 10, 25, 1024, 1, 1), 1),
    "s5 concat2144": ((2144, 10, 25, 1024, 1, 1), 2),
}
INT8_PER_FORWARD = 99  # V-99: the stem's 3 convs and 6 in each of its 16 OSA blocks
INT8_ROUNDS = 3  # interleaved timing rounds per shape (their spread)
# petr_tpu's bound on the int8 model's relative L2 error against the float one
# (tests/test_quant.py::test_detector_int8_e2e, at tiny_debug)
INT8_REL_ERR = 0.05
R50 = "petr_r50_p4_1408x512"
CLI_SAMPLES = 3  # cli.test's new options: a run each in this process, a few samples


def int8_inputs(torch, gen, C, H, W, Co, k, ties=False):
    """bf16 x (6 views), an He-scaled fp32 weight, a BN mul and add, and an
    amax at 0.9 of max |x| (the largest inputs saturate at +-127). With
    ``ties`` x lies on half-integers and amax is 127 (sa = 1): every x / sa
    is a tie, which rounding half to even and half away from zero split."""
    if ties:
        x = (torch.randint(-100, 100, (CONV_VIEWS, C, H, W), generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        amax = torch.tensor(127.0, device="cuda")
    else:
        x = torch.randn(CONV_VIEWS, C, H, W, generator=gen, device="cuda").to(torch.bfloat16)
        amax = x.abs().amax().float() * 0.9
    w = torch.randn(Co, C, k, k, generator=gen, device="cuda") * (2.0 / (k * k * C)) ** 0.5
    mul = torch.rand(Co, generator=gen, device="cuda") + 0.5
    add = torch.randn(Co, generator=gen, device="cuda") * 0.3
    return x, w, mul, add, amax


def im2col_int8(torch, xi, k, s):
    """int8 NCHW -> the (B * Ho * Wo, k * k * C) patches, tap-major, K padded
    with zeros to a multiple of 8 (torch._int_mm's)."""
    import torch.nn.functional as F

    xh = xi.permute(0, 2, 3, 1)
    if k == 3:
        xh = F.pad(xh, (0, 0, 1, 1, 1, 1))
    win = xh.unfold(1, k, s).unfold(2, k, s)  # (B, Ho, Wo, C, k, k)
    a = win.permute(0, 1, 2, 4, 5, 3).reshape(-1, k * k * xi.shape[1])
    pad = -a.shape[1] % 8
    return F.pad(a, (0, pad)).contiguous() if pad else a.contiguous()


def graph_timer(torch, fn, n=20):
    """``fn`` captured ``n`` times into a CUDA graph -> ``ms(reps=5)``: the
    mean ms per call of ``reps`` replays between two CUDA events, the
    device's time per call without the host's (a ctypes launch from Python
    takes tens of microseconds, more than a small conv's kernels)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def ms(reps=5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (n * reps)

    return ms


def graph_ms(torch, fn, n=20, reps=5):
    """Mean ms per call of ``fn`` replayed from a CUDA graph (``graph_timer``)."""
    return graph_timer(torch, fn, n)(reps)


def check_conv_int8(torch, c8, card):
    """K6 against its plain version at every conv shape of the flagship's
    V-99 at 6 views: the int32 sums bit for bit, the bf16 outputs within
    KERNEL_TOL (one rounding of the same fp32 epilogue), and a case whose
    every activation is a rounding tie; then each shape timed back to back:
    the op on operands prepared once (as the model calls it), its conv
    kernel and its quantisation pass launched alone, beside cuDNN's bf16
    F.conv2d (the dense floor) and torch._int_mm on the im2col patches (the
    library's int8 GEMM, the same int32 sums). Each from a CUDA graph of 20
    calls (``graph_timer``: the device's time, no host gaps; the
    ``*_graph_ms`` keys), in INT8_ROUNDS interleaved rounds: the medians
    are the records', each round's sums per forward their spread. Bounds
    (``roofline`` at the int8 peak, bytes read and written once): the op's
    reads x in its dtype and writes the output; the conv's alone reads the
    int8 activation (B C H W bytes, no padding); the quantisation's reads x
    and writes B C H W bytes. One call between CUDA events (``*_ms``) only
    at the record's shape (s4)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    log(f"phase 13: conv_int8_bn_act (K6) against its plain version at the {len(INT8_SHAPES)} conv shapes of "
        f"{FLAGSHIP}'s V-99 ({INT8_PER_FORWARD} convs per forward, {CONV_VIEWS} views, bf16 in and out)")
    assert sum(n for _, n in INT8_SHAPES.values()) == INT8_PER_FORWARD
    errs, shapes = {}, []
    timed = ("graph_ms", "conv_graph_ms", "quant_graph_ms", "cudnn_bf16_graph_ms", "int_mm_graph_ms")
    sums = dict.fromkeys(timed + ("bound_ms", "conv_bound_ms", "quant_bound_ms", "gop"), 0.0)
    rounds = {key: [0.0] * INT8_ROUNDS for key in timed}
    for label, ((C, H, W, Co, k, s), per_forward) in INT8_SHAPES.items():
        plan = c8.conv_plan(CONV_VIEWS, C, H, W, Co, k, s)
        for ties in ((False, True) if label == "s2" else (False,)):
            x, w, mul, add, amax = int8_inputs(torch, gen, C, H, W, Co, k, ties)
            wi, sw = c8.quantize_weight(w, mul)
            sa = c8.act_scale(amax)
            acc = c8.conv_int8_accumulate(x, wi, sa, s)
            want_acc = c8.conv_int8_accumulate_reference(c8.quantize_activation(x, sa), wi, s)
            wq, sa, scale, addf = c8.prepare_operands(w, mul, add, amax)
            wt = c8.tile_weight(wq, plan.bn)
            before = (c8.LAUNCHES, c8.QUANT_LAUNCHES)
            out = c8.conv_int8_bn_act_tiled(x, wt, sa, scale, addf, s, True)
            torch.cuda.synchronize()
            assert (c8.LAUNCHES, c8.QUANT_LAUNCHES) == (before[0] + 1, before[1] + 1), "K6 did not count its launch"
            want = c8.conv_int8_bn_act_plain(x, w, mul, add, amax, s, True)
            differ = int((acc != want_acc).sum())
            log(f"  {label}{' (every x / sa a tie)' if ties else ''}: int32 sums {acc.shape[1:]} x {acc.shape[0]}: "
                f"{differ} differ from the plain version's (max |sum| {want_acc.abs().max().item()}); outputs equal "
                f"bit for bit: {torch.equal(out, want)}; plan: {plan.tiles_m} x {plan.tiles_n} tiles of 128 x "
                f"{plan.bn}, K in {plan.splits} split(s) of {plan.per_split} of {plan.slices} slices, "
                f"{plan.blocks} blocks")
            assert differ == 0, f"{label}: K6's int32 sums differ from the plain version's at {differ} outputs"
            errs[(label, ties)] = kernel_compare(torch, f"{label} outputs", out, want, "bf16")
        xi = c8.quantize_activation(x, sa)
        Ho, Wo = out.shape[2:]
        M = CONV_VIEWS * Ho * Wo
        ops = 2.0 * M * Co * k * k * C
        rest = wi.numel() + 8 * Co + out.element_size() * out.numel()  # the weight, scale and add, the output
        b_ms, b_by, _ = roofline(ops, x.element_size() * x.numel() + rest, PEAK_INT8_OPS)
        cb_ms, cb_by, _ = roofline(ops, x.numel() + rest, PEAK_INT8_OPS)
        q_ms, _, _ = roofline(0.0, x.element_size() * x.numel() + x.numel(), PEAK_INT8_OPS)

        def call():
            c8.conv_int8_bn_act_tiled(x, wt, sa, scale, addf, s, True)

        # the op's two kernels launched alone on its prepared operands
        rows = c8.quantize_rows(x, sa, plan)
        quant_only = lambda: c8.quantize_rows(x, sa, plan)  # noqa: E731
        conv_only = lambda: c8.conv_rows(rows, wt, scale, addf, plan, torch.bfloat16, True)  # noqa: E731
        assert torch.equal(conv_only(), out), f"{label}: the conv kernel launched alone differs from the op"
        wb = w.to(torch.bfloat16)
        cudnn = lambda: F.conv2d(x, wb, stride=s, padding=k // 2)  # noqa: E731
        a = im2col_int8(torch, xi, k, s)
        b = F.pad(wi.permute(0, 2, 3, 1).reshape(Co, -1), (0, a.shape[1] - k * k * C)).t()
        try:
            torch._int_mm(a, b)
        except RuntimeError:  # a build of torch that takes the right operand row-major only
            b = b.contiguous()
        assert torch.equal(torch._int_mm(a, b), want_acc.permute(0, 2, 3, 1).reshape(M, Co)), (
            f"{label}: torch._int_mm on the patches differs from the plain version's sums")
        timers = dict(zip(timed, (graph_timer(torch, f) for f in (call, conv_only, quant_only, cudnn,
                                                                   lambda: torch._int_mm(a, b)))))
        per_round = {key: [] for key in timed}
        for r in range(INT8_ROUNDS):
            for key, timer in timers.items():
                per_round[key].append(timer())
                rounds[key][r] += per_forward * per_round[key][-1]
        del timers
        median = {key: sorted(v)[len(v) // 2] for key, v in per_round.items()}
        conv_graph = median["conv_graph_ms"]
        rec = {"label": label, "cin": C, "h": H, "w": W, "co": Co, "kernel": k, "stride": s,
               "launches_per_forward": per_forward, "bn": plan.bn, "tiles": plan.tiles_m * plan.tiles_n,
               "splits": plan.splits, "blocks": plan.blocks, **median,
               "rounds": per_round, "bound_ms": b_ms, "bound_by": b_by, "conv_bound_ms": cb_ms,
               "conv_bound_by": cb_by, "quant_bound_ms": q_ms, "gop": ops / 1e9,
               "conv_tops": ops / conv_graph / 1e9, "conv_share_of_bound": cb_ms / conv_graph,
               "op_share_of_bound": b_ms / median["graph_ms"]}
        if label == "s4":  # the record's shape: one call between CUDA events too
            rec.update(kernel_ms=cuda_time_ms(call), cudnn_bf16_ms=cuda_time_ms(cudnn),
                       int_mm_ms=cuda_time_ms(lambda: torch._int_mm(a, b)))
        shapes.append(rec)
        for key in sums:
            sums[key] += per_forward * rec[key]
        log(f"  {label}: {C} -> {Co}, {k}x{k}/{s} at {H}x{W}, x{per_forward} per forward, from CUDA graphs "
            f"(median of {INT8_ROUNDS}): the op {median['graph_ms']:.4f} ms (bound {b_ms:.4f}, {b_by}); launched "
            f"alone, the conv {conv_graph:.4f} ({ops / conv_graph / 1e9:.1f} TOPS; bound {cb_ms:.4f}, {cb_by}: "
            f"{100 * cb_ms / conv_graph:.1f}%), the activation quantisation {median['quant_graph_ms']:.4f} (bound "
            f"{q_ms:.4f}); cuDNN bf16 F.conv2d {median['cudnn_bf16_graph_ms']:.4f}; torch._int_mm on the patches "
            f"{median['int_mm_graph_ms']:.4f}; {ops / 1e9:.2f} GOP [{card}]")
    log(f"  per flagship forward ({INT8_PER_FORWARD} convs), from CUDA graphs (sums of the medians): the op "
        f"{sums['graph_ms']:.3f} ms (bound {sums['bound_ms']:.3f}, {sums['graph_ms'] / sums['bound_ms']:.2f}x); "
        f"launched alone, the convs {sums['conv_graph_ms']:.3f} ({sums['gop'] / sums['conv_graph_ms']:.1f} TOPS; "
        f"bound {sums['conv_bound_ms']:.3f}, {100 * sums['conv_bound_ms'] / sums['conv_graph_ms']:.1f}%), the "
        f"quantisation {sums['quant_graph_ms']:.3f} (bound {sums['quant_bound_ms']:.3f}, "
        f"{sums['quant_graph_ms'] / sums['quant_bound_ms']:.2f}x); cuDNN bf16 {sums['cudnn_bf16_graph_ms']:.3f}; "
        f"torch._int_mm {sums['int_mm_graph_ms']:.3f} [{card}]")
    for r in range(INT8_ROUNDS):
        log(f"    round {r + 1}: the convs {rounds['conv_graph_ms'][r]:.3f} ms, torch._int_mm "
            f"{rounds['int_mm_graph_ms'][r]:.3f}, the op {rounds['graph_ms'][r]:.3f}, the quantisation "
            f"{rounds['quant_graph_ms'][r]:.3f}, cuDNN bf16 {rounds['cudnn_bf16_graph_ms'][r]:.3f}")
    sums["rounds"] = rounds
    (C, H, W, Co, k, s), _ = INT8_SHAPES["s4"]
    x, w, mul, add, amax = int8_inputs(torch, gen, C, H, W, Co, k)
    wi, sw = c8.quantize_weight(w, mul)
    sa = c8.act_scale(amax)
    plain_ms = cuda_time_ms(lambda: c8.conv_int8_bn_act_reference(x, wi, sa, sa * sw, add, s, True), warmup=1,
                            iters=5)
    quant_plain_ms = cuda_time_ms(
        lambda: c8.quantize_activation(x, sa).permute(0, 2, 3, 1).contiguous(), warmup=2, iters=10)
    s4 = next(r for r in shapes if r["label"] == "s4")
    plan = c8.conv_plan(CONV_VIEWS, C, H, W, Co, k, s)
    quant_ms = cuda_time_ms(lambda: c8.quantize_rows(x, sa, plan))
    xi, zeros = c8.unpack_rows(c8.quantize_rows(x, sa, plan), plan)
    assert torch.equal(xi, c8.quantize_activation(x, sa)) and not zeros.any()
    log(f"  the record's shape (s4): the op {s4['kernel_ms']:.4f} ms one call between CUDA events, cuDNN bf16 "
        f"{s4['cudnn_bf16_ms']:.4f}, torch._int_mm {s4['int_mm_ms']:.4f}; plain_ms {plain_ms:.4f} (float64 "
        f"sums); the quantisation pass alone {quant_ms:.4f} ms, its plain version {quant_plain_ms:.4f}, bound "
        f"{s4['quant_bound_ms']:.4f} (bytes) [{card}]")
    conv_rec = {
        "name": "conv_int8_bn_act",
        "route": "cuda",
        "source": "petr_tpu_torch/csrc/conv_int8.cu",
        "replaces": "petr_tpu/models/layers.py:202::ConvBNReLU._int8_forward (XLA's int8 conv, no Pallas)",
        "launches": None,  # filled from the int8 flagship's forward
        "max_abs_err": max(errs.values()),
        "ms": s4["kernel_ms"],  # stage 4, 192 -> 192: 36 of the 99 launches of a forward
        "plain_ms": plain_ms,
        "bound_ms": s4["bound_ms"],  # the op's: bf16 x read, the output written
        "bound_by": s4["bound_by"],
        "conv_bound_ms": s4["conv_bound_ms"],  # the conv kernel's alone: int8 x read
        "library_ms": s4["int_mm_ms"],  # torch._int_mm on the im2col patches (the GEMM alone)
        "graph_ms": s4["graph_ms"],
        "conv_graph_ms": s4["conv_graph_ms"],
        "library_graph_ms": s4["int_mm_graph_ms"],
        "cudnn_bf16_ms": s4["cudnn_bf16_ms"],
        "cudnn_bf16_graph_ms": s4["cudnn_bf16_graph_ms"],
        "shapes": shapes,
        "per_forward": sums,
    }
    quant_rec = {
        "name": "quantize_act",
        "route": "cuda",
        "source": "petr_tpu_torch/csrc/conv_int8.cu",
        "replaces": "petr_tpu/models/layers.py:214 (XLA's clip(round(x / sa)) before the int8 conv, no Pallas)",
        "launches": None,
        "max_abs_err": 0.0,  # equal through every sum above
        "ms": quant_ms,  # the pass alone, one call between CUDA events
        "plain_ms": quant_plain_ms,
        "bound_ms": s4["quant_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no PyTorch call rounds half to even into a symmetric int8 NHWC copy
        "graph_ms": s4["quant_graph_ms"],
        "per_forward_graph_ms": sums["quant_graph_ms"],
        "per_forward_bound_ms": sums["quant_bound_ms"],
    }
    return conv_rec, quant_rec


def replay_code(paths, inputs, out_dir):
    """The script a fresh process runs to replay artifacts: the runtime and
    the op library only (it asserts that no model module is loaded), each
    artifact's launches of K1, K4 and K6 counted per call."""
    return f"""
import sys, json, numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import petr_tpu_torch.runtime as runtime
from petr_tpu_torch.ops import conv_int8 as c8, cross_attention as ca, dcn
counts = {{}}
for name, path in {paths!r}.items():
    fn, meta = runtime.load_artifact(path)
    d = np.load({inputs!r}[name])
    args = [d[f"arr_{{i}}"] for i in range(len(d.files))]
    fn(*args)
    torch.cuda.synchronize()
    c8.LAUNCHES = c8.QUANT_LAUNCHES = ca.LAUNCHES = ca.LAUNCHES_FP32 = dcn.LAUNCHES = dcn.LAUNCHES_FP32 = 0
    out = fn(*args)
    torch.cuda.synchronize()
    counts[name] = {{"K1": ca.LAUNCHES, "K1_FP32": ca.LAUNCHES_FP32, "K4": dcn.LAUNCHES, "K4_FP32": dcn.LAUNCHES_FP32,
                    "K6": c8.LAUNCHES, "K6_QUANT": c8.QUANT_LAUNCHES, "ops": meta["op_names"]}}
    np.savez({out_dir!r} + f"/{{name}}_out.npz", **{{k: v.cpu().numpy() for k, v in out.items()}})
models = sorted(m for m in sys.modules if m.startswith(("petr_tpu_torch.models", "petr_tpu_torch.serve")))
assert not models, models
print(json.dumps(counts))
"""


def run_module(args, label, timeout=900):
    """``python -m ARGS`` from this script's directory in a process of its
    own: it must exit 0. Returns its stdout."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=root, capture_output=True, text=True, timeout=timeout)
    log(f"  {label}: python {' '.join(args)[:300]} -> exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    for line in proc.stdout.splitlines()[-8:]:
        log(f"    | {line[:300]}")
    assert proc.returncode == 0, f"{label} exited {proc.returncode}:\n{proc.stderr[-4000:]}"
    return proc.stdout


def check_deployment(torch, ca, c8, dcn, card):
    """Phase 13 after K6's own check: the flagship calibrated by ``cli.quantize
    --synthetic`` and served int8 through ``InferenceServer`` (K6 99 and K1 6
    launches per forward; against K6's plain version; its error against the
    bf16 model); ``cli.test --fuse-conv-bn`` and ``--tta hflip``; the serving
    artifacts of the flagship (bf16 and int8) and of petr_r50_p4_1408x512
    replayed in a fresh process without model modules, launching the
    kernels themselves; PETRv2's streaming pair over 3 frames."""
    import os
    import tempfile

    import numpy as np

    from petr_tpu_torch.cli import test as cli_test
    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.models import layers, resnet
    from petr_tpu_torch.quant import load_scales, quant_convs, set_quant
    from petr_tpu_torch.serve import (StreamingArtifactRunner, StreamingPETRv2, build_detector, export_serving,
                                      export_streaming, make_serving_fn, save_artifact, save_streaming_artifact,
                                      serving_input_spec)

    cfg = get_config(FLAGSHIP)
    hc = cfg.model.head
    L = hc.num_layers
    t_phase = time.perf_counter()
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        # -- the int8 flagship: calibrate, serve, check ----------------------
        log(f"phase 13: {FLAGSHIP} int8: cli.quantize --synthetic (random weights, seed {SEED}), then served int8")
        scales_path, times["cli_quantize_s"] = synthetic_scales()
        scales = load_scales(scales_path)
        model = build_detector(cfg, seed=SEED, device="cuda")
        fn = make_serving_fn(cfg, model, device="cuda", quant_scales=scales)  # switches the backbone to int8
        convs = quant_convs(model)
        assert len(convs) == INT8_PER_FORWARD and all(c.quant == "int8" for c in convs.values()), len(convs)
        seen, kept, kept_prepare, prepared = [], layers.conv_int8_bn_act_tiled, layers.prepare_operands, []

        def recording(x, wt, sa, scale, add, stride=1, relu=True):
            k = round((wt.shape[1] * c8.CHANNEL_STEP // c8.padded_channels(x.shape[1])) ** 0.5)
            seen.append((tuple(x.shape[1:]), scale.shape[0], k, stride))
            return kept(x, wt, sa, scale, add, stride, relu)

        def counted_prepare(weight, mul, add, amax):
            prepared.append(tuple(weight.shape))
            return kept_prepare(weight, mul, add, amax)

        requests = make_requests(cfg, 1)
        one = [torch.as_tensor(np.stack([requests[0][k]])).cuda() for k in serving_input_spec(cfg)]
        layers.conv_int8_bn_act_tiled, layers.prepare_operands = recording, counted_prepare
        try:
            with torch.inference_mode():
                forward(model, one)
                first = len(prepared)
                forward(model, one)
                forward(model, one)
        finally:
            layers.conv_int8_bn_act_tiled, layers.prepare_operands = kept, kept_prepare
        want_shapes = sorted(((C, H, W), Co, k, s) for (C, H, W, Co, k, s), n in INT8_SHAPES.values() for _ in range(n))
        assert sorted(seen[:INT8_PER_FORWARD]) == want_shapes, f"the int8 convs differ from INT8_SHAPES: {sorted(seen)}"
        log(f"  the model's {INT8_PER_FORWARD} int8 convs are INT8_SHAPES' (phase 13's kernel check); the weights "
            f"prepared (quantised and packed) {first} times in the first forward, {len(prepared) - first} in the two "
            "after it")
        assert first <= INT8_PER_FORWARD and len(prepared) == first, "the int8 weights were prepared again per call"
        int8_tol = {"cls_logits": (MODEL_ATOL, MODEL_RTOL), "bbox_codes": (MODEL_ATOL, MODEL_RTOL)}
        launches, args, _, results = serve_and_check(
            torch, cfg, model,
            {"K6": (c8, "LAUNCHES"), "K6 quant": (c8, "QUANT_LAUNCHES"), "K1": (ca, "LAUNCHES"),
             "K1 fp32": (ca, "LAUNCHES_FP32")},
            {"K6": INT8_PER_FORWARD, "K6 quant": INT8_PER_FORWARD, "K1": L, "K1 fp32": 0},
            [(layers, "conv_int8_bn_act_tiled", c8.conv_int8_bn_act_tiled_plain)], int8_tol, MODEL_MEAN, card)
        with torch.inference_mode():
            out_q = forward(model, args)
            set_quant(model, "none")
            out_bf16 = forward(model, args)
            fwd = {}
            for mode in ("int8", "none", "int8", "none"):  # alternated pairs on CUDA events
                set_quant(model, mode)
                fwd.setdefault(mode, []).append(cuda_time_ms(lambda: forward(model, one), warmup=1, iters=5))
            set_quant(model, "int8")
            dev_q, per_kernel_q = profile(torch, lambda: forward(model, one), card)
            set_quant(model, "none")
            dev_f, _ = profile(torch, lambda: forward(model, one), card)
            set_quant(model, "int8")
        rel = {}
        for k in ("cls_logits", "bbox_codes"):
            q, r = out_q[k].float(), out_bf16[k].float()
            assert torch.isfinite(q).all(), k
            rel[k] = ((q - r).norm() / r.norm()).item()
        log(f"  int8 against bf16, the same weights and padded request: relative L2 error cls_logits "
            f"{rel['cls_logits']:.4f}, bbox_codes {rel['bbox_codes']:.4f} (petr_tpu's bound {INT8_REL_ERR})")
        assert max(rel.values()) < INT8_REL_ERR, rel
        host_share = {mode: 1.0 - dev / min(fwd[mode]) for mode, dev in (("int8", dev_q), ("none", dev_f))}
        times.update(int8_rel_err=rel, int8_forward_ms=fwd["int8"], bf16_forward_ms=fwd["none"],
                     int8_forward_device_ms=dev_q, bf16_forward_device_ms=dev_f,
                     int8_forward_host_share=host_share["int8"], bf16_forward_host_share=host_share["none"],
                     k6_device_ms_per_forward=per_kernel_q.get("K6", 0.0),
                     k6_quant_device_ms_per_forward=per_kernel_q.get("K6 quant", 0.0))
        log(f"  B=1 forward on CUDA events, int8 {', '.join(f'{t:.2f}' for t in fwd['int8'])} ms, bf16 "
            f"{', '.join(f'{t:.2f}' for t in fwd['none'])} ms; device time int8 {dev_q:.3f} ms, bf16 {dev_f:.3f} ms; "
            f"the host's share of the fastest forward (1 - device / events) int8 {100 * host_share['int8']:.1f}%, "
            f"bf16 {100 * host_share['none']:.1f}% [{card}]")

        # -- cli.test's new options on the synthetic scenes ---------------
        H, W = cfg.data.src_hw
        splits, synth, _ = eval_scenes(H, W)
        val_pkl = f"{synth}/synth_infos_val.pkl"
        log(f"phase 13: cli.test --fuse-conv-bn and --tta hflip on {CLI_SAMPLES} of the {len(splits['val'])} val "
            f"samples of phase 10's synthetic scenes ({H}x{W}; random weights, seed {SEED}), in this process")
        for extra in (["--fuse-conv-bn"], ["--tta", "hflip"]):
            with torch_defaults(torch):  # as in the CLI's own process
                out, wall = run_main(cli_test, ["--config", FLAGSHIP, "--infos", val_pkl, "--classes", EVAL_CLASSES,
                                                "--max-samples", str(CLI_SAMPLES), *extra], " ".join(extra))
            metrics = printed_metrics(out)
            assert {"mAP", "NDS"} <= set(metrics) and all(np.isfinite(float(v)) for v in metrics.values()), metrics
            assert f"inference: {CLI_SAMPLES} samples" in out, out
            times["cli_" + extra[0].strip("-").replace("-", "_") + "_s"] = wall

        # -- the serving artifacts, replayed without the model code ---------
        log("phase 13: serving artifacts (torch.export, weights embedded): the flagship bf16 and int8, "
            f"{R50} at B=1; replayed in a fresh process that imports the runtime and the op library only")
        batch2 = [np.stack([requests[0][k]] * 2) for k in serving_input_spec(cfg)]
        paths, inputs, wants, expect = {}, {}, {}, {}
        for name, mode in (("flagship_bf16", "none"), ("flagship_int8", "int8")):
            set_quant(model, mode)
            wants[name] = make_serving_fn(cfg, model, device="cuda")(*batch2)
            t0 = time.perf_counter()
            exported = export_serving(cfg, model, batch_size=2, embed_params=True)
            times[f"export_{name}_s"] = time.perf_counter() - t0
            calls = [n for n in exported.graph.nodes if n.op == "call_function" and "conv_int8" in str(n.target)]
            assert len(calls) == (INT8_PER_FORWARD if mode == "int8" else 0), len(calls)
            assert all(a.op == "placeholder" for n in calls for a in n.args[1:5]), (
                "the artifact prepares an int8 weight in the program, on every call")
            paths[name], inputs[name] = f"{tmp}/{name}.petrx", f"{tmp}/{name}_in.npz"
            meta = save_artifact(paths[name], exported, cfg, model, batch_size=2, embed_params=True)
            np.savez(inputs[name], *batch2)
            expect[name] = {"K1": L, "K4": 0, "K6": INT8_PER_FORWARD if mode == "int8" else 0}
            log(f"  {name}: exported in {times[f'export_{name}_s']:.1f} s, {os.path.getsize(paths[name]) / 1e6:.1f} MB, "
                f"quant {meta['quant']}, ops {meta['op_names']}" + (
                    f"; its {len(calls)} int8 convs read their weight tiles, sa, scale and add as the program's "
                    "constants (prepared once, at export)" if calls else ""))
        del exported
        r50_cfg = get_config(R50)
        r50 = build_detector(r50_cfg, seed=SEED, device="cuda")
        resnet.redraw_offset_convs(r50, SEED + 1)
        r50_in = [np.stack([make_requests(r50_cfg, 1)[0][k]]) for k in serving_input_spec(r50_cfg)]
        wants["r50"] = make_serving_fn(r50_cfg, r50, device="cuda")(*r50_in)
        t0 = time.perf_counter()
        meta = save_artifact(f"{tmp}/r50.petrx", export_serving(r50_cfg, r50, batch_size=1, embed_params=True),
                             r50_cfg, r50, batch_size=1, embed_params=True)
        times["export_r50_s"] = time.perf_counter() - t0
        paths["r50"], inputs["r50"] = f"{tmp}/r50.petrx", f"{tmp}/r50_in.npz"
        np.savez(inputs["r50"], *r50_in)
        expect["r50"] = {"K1": L, "K4": 9, "K6": 0}
        log(f"  r50: exported in {times['export_r50_s']:.1f} s, ops {meta['op_names']}")
        del r50
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = run_module(["-c", replay_code(paths, inputs, tmp)], "the replay")
        times["replay_process_s"] = time.perf_counter() - t0
        counts = json.loads(out.strip().splitlines()[-1])
        for name, want in expect.items():
            got = counts[name]
            log(f"  {name}: launches per artifact call {got} (expected {want}, no fp32 variant)")
            assert (got["K1"], got["K4"], got["K6"], got["K6_QUANT"]) == (want["K1"], want["K4"], want["K6"], want["K6"])
            assert got["K1_FP32"] == got["K4_FP32"] == 0, got
            replayed = dict(np.load(f"{tmp}/{name}_out.npz"))
            for k, v in wants[name].items():
                same = np.array_equal(replayed[k], v)
                log(f"    {k}: equal to make_serving_fn's bit for bit: {same}"
                    + ("" if same else f" (max abs difference {np.abs(replayed[k].astype(float) - v).max():.3e})"))
                if not same:  # the graph's ops and the eager step's differ somewhere: hold to phase 4's limits
                    assert k in ("boxes", "scores") and np.allclose(replayed[k], v, rtol=MODEL_RTOL, atol=MODEL_ATOL), k
        times["replay_launches"] = counts

        # -- PETRv2's streaming pair ------------------------------------------
        v2 = get_config(PETRV2)
        log(f"phase 13: {PETRV2} streaming pair (torch.export, weights embedded), 3 frames through "
            "StreamingArtifactRunner against StreamingPETRv2.step")
        vmodel = build_detector(v2, seed=SEED, device="cuda")
        t0 = time.perf_counter()
        save_streaming_artifact(f"{tmp}/v2.petrx", export_streaming(v2, vmodel, embed_params=True), v2, vmodel,
                                batch_size=1, embed_params=True)
        times["export_streaming_s"] = time.perf_counter() - t0
        runner = StreamingArtifactRunner(f"{tmp}/v2.petrx")
        stream = StreamingPETRv2(v2, vmodel, device="cuda")
        rng = np.random.RandomState(SEED)
        reqs = make_requests(v2, 3)
        for frame, req in enumerate(reqs):
            images = req["images"][None, :6]
            ts = frame_timestamps(rng)
            ca.LAUNCHES = 0
            got = runner.step(images, req["img2lidar"][None], req["img_hw"][None], ts)
            torch.cuda.synchronize()
            k1 = ca.LAUNCHES
            want = stream.step(images, req["img2lidar"][None], req["img_hw"][None], ts)
            same = {k: torch.equal(got[k], want[k]) for k in want}
            log(f"  frame {frame}: K1 {k1} launches in the replayed step (expected {L}); equal to "
                f"StreamingPETRv2.step bit for bit: {same}")
            assert k1 == L
            for k in want:
                if not same[k]:
                    assert k in ("boxes", "scores") and torch.allclose(got[k].float(), want[k].float(),
                                                                       rtol=MODEL_RTOL, atol=MODEL_ATOL), k
        del vmodel, model
        torch.cuda.empty_cache()
    times["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13: {times['phase_s']:.1f} s [{card}]")
    return launches, times


# Phase 14: the measurement tools, the native loader and the remaining CLIs
# at the flagship's full width. cli.benchmark's timed iterations per mode,
# after its 5 warm-up ones and before the one its FLOP count runs.
BENCH_ITERS = {"inference": 20, "train": 5, "int8": 20}
BENCH_WARMUP = 5
# The native loader against the PIL path, per pixel of a normalised view:
# petr_tpu's limits (tests/test_native_dataload.py), its bicubic in fp32
# against PIL's fixed-point intermediate.
NATIVE_MEDIAN_ERR, NATIVE_PIXEL_ERR, NATIVE_PIXEL_SHARE = 0.05, 0.25, 0.99


def check_tools(torch, ca, c8, card):
    """Phase 14: ``cli.benchmark`` in this process on the flagship at B=1
    (inference, ``--train`` and int8 with the scales of ``cli.quantize
    --synthetic``), each JSON line printed and its launches counted (K1 6
    per forward; K1 12, K2 6 + 6 per step; K6 99 per int8 forward);
    ``utils.mfu.count_flops`` of the bf16 forward and the train step equal
    on the kernel route and with every kernel routed to its plain version,
    and ``cli.flops``' line (that count, the parameters, the forward's peak
    memory); the native loader built from ``csrc/dataload.cpp`` (or a line saying the
    machine has no libjpeg headers) and held to the PIL path on phase 10's
    scenes at 900x1600, then the loader's time per batch and the eval pass's
    wait on it on each branch; ``cli.convert`` of a reference-shaped
    ``.pth`` (the model's random weights under legacy keys, wrapped as mmcv
    saves them), the converted model's forward equal bit for bit to the
    source's, and ``cli.publish`` of its checkpoint round-tripped through
    ``load_published``."""
    import hashlib
    import os
    import re
    import tempfile

    import numpy as np

    from petr_tpu_torch.cli import benchmark
    from petr_tpu_torch.cli import convert as convert_cli
    from petr_tpu_torch.cli import flops as flops_cli
    from petr_tpu_torch.cli import publish as publish_cli
    from petr_tpu_torch.configs import get_config
    from petr_tpu_torch.configs.config import NUSCENES_CLASSES
    from petr_tpu_torch.data import NuScenesDataset, native
    from petr_tpu_torch.serve import build_detector
    from petr_tpu_torch.train import create_train_state, make_train_step, step_generator
    from petr_tpu_torch.train.checkpoint import load_params
    from petr_tpu_torch.utils import mfu
    from petr_tpu_torch.utils.publish import load_published
    from petr_tpu_torch.utils.torch_convert import LEGACY_MAP

    cfg = get_config(FLAGSHIP)
    L = cfg.model.head.num_layers
    t_phase = time.perf_counter()
    out = {"benchmark": {}, "launches_per_iter": {}}
    counters = {"K1": (ca, "LAUNCHES"), "K1 fp32": (ca, "LAUNCHES_FP32"), "K2 dK/dV": (ca, "DKDV_LAUNCHES"),
                "K2 dQ": (ca, "DQ_LAUNCHES"), "K6": (c8, "LAUNCHES"), "K6 quant": (c8, "QUANT_LAUNCHES")}

    def zero():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def counts():
        return {label: getattr(mod, attr) for label, (mod, attr) in counters.items()}

    # -- cli.benchmark: inference, --train, int8 -------------------------
    scales, _ = synthetic_scales()
    per_iter = {"inference": {"K1": L}, "train": {"K1": 2 * L, "K2 dK/dV": L, "K2 dQ": L},
                "int8": {"K1": L, "K6": INT8_PER_FORWARD, "K6 quant": INT8_PER_FORWARD}}
    extra = {"inference": [], "train": ["--train"], "int8": ["--quant-scales", scales]}
    for mode, n in BENCH_ITERS.items():
        argv = ["--config", FLAGSHIP, "--batch-size", "1", "--iters", str(n), "--warmup", str(BENCH_WARMUP),
                *extra[mode]]
        log(f"phase 14: cli.benchmark {' '.join(argv)} (random weights, seed {SEED}), in this process")
        zero()
        with torch_defaults(torch):  # as in the CLI's own process
            stdout, _ = run_main(benchmark, argv, mode)
        launches = counts()
        iters = BENCH_WARMUP + n + 1  # the warm-up, the timed loop, the FLOP count's iteration
        want = {label: per_iter[mode].get(label, 0) * iters for label in counters}
        rec = json.loads(stdout.strip().splitlines()[-1])
        log(json.dumps(rec))
        log(f"  launches over {iters} iterations {launches} (expected {want})")
        assert launches == want, (mode, launches, want)
        assert set(rec) == {"metric", "value", "unit", "ms_per_iter", "model_gflops", "achieved_tflops",
                            "mfu_pct", "device"}, sorted(rec)
        assert rec["device"] == card and rec["value"] > 0 and 0 < rec["mfu_pct"] < 100, rec
        out["benchmark"][mode] = rec
        out["launches_per_iter"][mode] = {label: v // iters for label, v in launches.items() if v}

    # -- the FLOP count on both routes -----------------------------------
    log(f"phase 14: utils.mfu.count_flops of the {cfg.model.compute_dtype} forward and the train step at B=1, "
        "on the kernel route and with every kernel routed to its plain version")
    batch = benchmark.benchmark_batch(cfg, 1, seed=SEED)
    model = build_detector(cfg, seed=SEED, device="cuda")
    args, kwargs = benchmark.forward_inputs(cfg, batch, "cuda")
    flops = {}
    zero()
    with torch.inference_mode():
        flops["forward"] = mfu.count_flops(model, *args, **kwargs)
        fwd_launches = counts()
        with mfu.plain_kernels():
            flops["forward_plain"] = mfu.count_flops(model, *args, **kwargs)
    assert counts() == fwd_launches and fwd_launches["K1"] == L, (fwd_launches, counts())
    del model
    state = create_train_state(cfg, SEED, 10, device="cuda")
    step = make_train_step(cfg)
    zero()
    backward_flops = ca.BACKWARD_FLOPS
    flops["step"] = mfu.count_flops(step, state, batch, step_generator(SEED, 0))
    step_launches = counts()
    flops["step_k2_formula"] = ca.BACKWARD_FLOPS - backward_flops
    with mfu.plain_kernels():
        flops["step_plain"] = mfu.count_flops(step, state, batch, step_generator(SEED, 1))
    assert counts() == step_launches, (step_launches, counts())
    assert (step_launches["K1"], step_launches["K2 dK/dV"], step_launches["K2 dQ"]) == (2 * L, L, L), step_launches
    del state, step
    torch.cuda.empty_cache()
    log(f"  forward {flops['forward']} FLOPs on the kernel route (K1 {fwd_launches['K1']} launches, by its "
        f"op's formula), {flops['forward_plain']} on the plain route; train step {flops['step']} (K1 "
        f"{step_launches['K1']}, K2 {step_launches['K2 dK/dV']} + {step_launches['K2 dQ']}, of which "
        f"{flops['step_k2_formula']} by K2's formula), {flops['step_plain']} on the plain route")
    assert flops["forward"] == flops["forward_plain"], flops
    assert flops["step"] == flops["step_plain"], flops
    assert out["benchmark"]["inference"]["model_gflops"] == round(flops["forward"] / 1e9, 1), flops
    assert out["benchmark"]["train"]["model_gflops"] == round(flops["step"] / 1e9, 1), flops
    out["flops"] = flops
    stdout, _ = run_main(flops_cli, ["--config", FLAGSHIP], "cli.flops")
    rec = json.loads(stdout.strip().splitlines()[-1])
    log(json.dumps(rec))
    assert rec == {"config": FLAGSHIP, "params_m": round(flops_cli.param_count(cfg) / 1e6, 2),
                   "forward_gflops": round(flops["forward"] / 1e9, 1), "input": "6x320x800",
                   "peak_memory_mb": rec["peak_memory_mb"]} and rec["peak_memory_mb"] > 0, rec
    out["flops_cli"] = rec

    # -- the native loader against PIL, and the host's data cost -----------
    H, W = cfg.data.src_hw
    splits, synth, _ = eval_scenes(H, W)
    log(f"phase 14: the native loader (csrc/dataload.cpp, g++ and libjpeg) on the {len(splits['val'])} val "
        f"samples of phase 10's scenes at {H}x{W}")
    try:
        t0 = time.perf_counter()
        lib = native.build()
        log(f"  built {os.path.relpath(lib)} in {time.perf_counter() - t0:.1f} s")
        branches = ("native", "pil")
    except RuntimeError as e:
        if "jpeglib.h" not in str(e):
            raise
        log("  this machine has no jpeglib.h (libjpeg's headers): the native loader cannot be built here, and "
            "the loader stays on PIL")
        branches = ("pil",)
    out["native_built"] = branches[0] == "native"
    ds = NuScenesDataset(splits["val"], cfg.data, training=False)
    available = native.available
    try:
        if out["native_built"]:
            errs = []
            for i in range(len(ds)):
                got = ds.get(i, seed=i)["images"]
                native.available = lambda: False
                want = ds.get(i, seed=i)["images"]
                native.available = available
                errs.append(np.abs(got - want))
            err = np.concatenate([e.ravel() for e in errs])
            share = float((err < NATIVE_PIXEL_ERR).mean())
            log(f"  native against PIL over {len(ds)} samples: median error {np.median(err):.4e} (limit "
                f"{NATIVE_MEDIAN_ERR}), {100 * share:.3f}% of values within {NATIVE_PIXEL_ERR} (limit "
                f"{100 * NATIVE_PIXEL_SHARE}%), max {err.max():.4f}")
            assert err.max() > 0 and np.median(err) < NATIVE_MEDIAN_ERR and share > NATIVE_PIXEL_SHARE
        model = build_detector(cfg, seed=SEED, device="cuda")
        for branch in branches:
            native.available = available if branch == "native" else (lambda: False)
            log(f"  the {branch} branch:")
            out[f"loader_{branch}"] = loader_cost(torch, cfg, model, ds, card)
    finally:
        native.available = available
    del model

    # -- a reference checkpoint converted, served, published ----------------
    with tempfile.TemporaryDirectory() as tmp:
        source = build_detector(cfg, seed=SEED + 2, device="cuda")
        back = {new: old for old, new in LEGACY_MAP.items()}

        def legacy(key):
            for new, old in back.items():
                key = key.replace(new, old)
            return key

        sd = {legacy(k): v.detach().cpu() for k, v in source.state_dict().items()}
        assert any(".self_attn." in k for k in sd) and any(".decoder.norm." in k for k in sd)
        pth = f"{tmp}/petr_vov_reference.pth"
        torch.save({"meta": {"epoch": 24, "CLASSES": list(NUSCENES_CLASSES)}, "state_dict": sd}, pth)
        log(f"phase 14: cli.convert of a reference-shaped .pth ({os.path.getsize(pth) / 1e6:.1f} MB: the flagship's "
            f"random weights, seed {SEED + 2}, under legacy keys, in mmcv's wrapper), in this process")
        stdout, out["convert_s"] = run_main(convert_cli, ["--config", FLAGSHIP, "--torch-ckpt", pth, "--out",
                                                          f"{tmp}/imported"], "cli.convert")
        assert "skipped 0 reference keys; 0 target leaves unfilled" in stdout, stdout
        model = load_params(f"{tmp}/imported", build_detector(cfg, seed=SEED + 3, device="cuda"))
        args, kwargs = benchmark.forward_inputs(cfg, benchmark.benchmark_batch(cfg, 1, seed=SEED + 4), "cuda")
        with torch.inference_mode():
            a, b = source(*args, **kwargs), model(*args, **kwargs)
        same = {k: torch.equal(a[k], b[k]) for k in ("cls_logits", "bbox_codes")}
        log(f"  the converted model's forward against the source model's, bit for bit: {same}")
        assert all(same.values()), same
        stdout, _ = run_main(publish_cli, ["--ckpt", f"{tmp}/imported", "--out", f"{tmp}/petr_vov.pt"],
                             "cli.publish")
        final = stdout.strip().split("published ")[-1]
        tag = re.fullmatch(r"petr_vov-([0-9a-f]{8})\.pt", os.path.basename(final))
        with open(final, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        weights = load_published(final)
        want = source.state_dict()
        differ = [k for k in want if not torch.equal(weights[k], want[k].cpu())]
        log(f"  published {os.path.basename(final)} ({os.path.getsize(final) / 1e6:.1f} MB, sha256 {digest[:16]}...); "
            f"load_published: {len(weights)} tensors, {len(differ)} differ from the source model's")
        assert tag and digest.startswith(tag.group(1)) and list(weights) == list(want) and not differ
        del source, model
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 14: {out['phase_s']:.1f} s [{card}]")
    return out


ALL_PHASES = {3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14}


def training_phase(torch, fn, *args):
    """``fn(*args)``, then cuDNN's algorithm flags as they were before:
    ``create_train_state`` pins cuDNN's deterministic algorithms for the
    process, and the serving phases run with the defaults."""
    kept = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        return fn(*args)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = kept


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    phases = ALL_PHASES
    if len(sys.argv) == 3 and sys.argv[1] == "--phases":
        phases = {int(p) for p in sys.argv[2].split(",")}
    elif len(sys.argv) != 1:
        print("usage: chip_smoke.py [--phases 3,8]", file=sys.stderr)
        return 2
    try:
        from petr_tpu_torch.ops import build
        from petr_tpu_torch.ops import conv3x3 as conv
        from petr_tpu_torch.ops import conv_int8 as c8
        from petr_tpu_torch.ops import cross_attention as ca
        from petr_tpu_torch.ops import dcn
        from petr_tpu_torch.utils.mfu import device_peak_tflops
    except ImportError as e:
        print(f"chip_smoke: the petr_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 1

    stamps = []

    def stamp(n):
        """Mark the start of phase ``n`` (None: the end of the last)."""
        if n is None or n < 3 or n in phases:
            stamps.append((n, time.perf_counter()))

    stamp(1)
    log("phase 1: device")
    card = nvidia_smi("name,power.limit")
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}")
    sm_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    log(f"  max SM clock {sm_clock_hz / 1e6:.0f} MHz")
    global PEAK_BF16_FLOPS
    peak = device_peak_tflops()
    PEAK_BF16_FLOPS = peak * 1e12 if peak else PEAK_BF16_FLOPS
    log(f"  bf16 dense peak {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, from utils.mfu's table"
        + ("" if peak else ", which has no entry for this card: the H100 SXM's"))
    try:  # the data layer decodes, resamples and renders through Pillow
        import PIL

        log(f"  Pillow {PIL.__version__}")
    except ImportError:
        log("  Pillow: absent")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    stamp(2)
    log("phase 2: build")
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    sources = ("flash_cross_attention", "flash_cross_attention_bwd", "deform_conv", "conv3x3_bn_relu", "conv_int8")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        libs = list(pool.map(build.build, sources))
    log(f"  built {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        report = lib.with_name(lib.name + ".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if any(w in line for w in ("registers", "spill", "Compiling", "Performance Loss")):
                    log("  ptxas:", line.strip())

    records = []
    stamp(3)
    if 3 in phases:
        k1, k1_fp32, k1_v2 = check_flash_attention(torch, ca, sm_clock_hz, card)
        k2 = check_flash_backward(torch, ca, sm_clock_hz, card)
        k4, k4_fp32 = check_dcn(torch, dcn, card)
        k5, k5_fp32 = check_conv3x3(torch, conv, card)
        synth = {r["name"]: r for r in check_synth_shapes(torch, ca, dcn, sm_clock_hz, card)}
        records = [k1, k1_fp32, k1_v2, *k2, k4, k4_fp32, k5, k5_fp32, *synth.values()]
    stamp(4)
    if 4 in phases:
        k1_launches, k5_launches, k5_fp32_launches, k5_times = check_serving(torch, ca, conv, card)
        if records:
            k1["launches"], k5["launches"], k5_fp32["launches"] = k1_launches, k5_launches, k5_fp32_launches
            k5_fp32["launches_note"] = "the flagship's fp32 twin, one forward on the route"
            k5.update(k5_times)
    stamp(5)
    if 5 in phases:
        train_launches, fp32_launches = training_phase(torch, check_training, torch, ca, card)
        if records:
            k1["launches_train"] = train_launches["K1"]
            k2[0]["launches"] = train_launches["K2 dK/dV"]
            k2[1]["launches"] = train_launches["K2 dQ"]
            k1_fp32["launches"], k2[2]["launches"], k2[3]["launches"] = fp32_launches
            for r in (k1_fp32, *k2[2:4]):
                r["launches_note"] = "the flagship's fp32 train step"
    stamp(6)
    if 6 in phases:
        r50_launches, r50_fwd_ms, c5_times = check_r50_serving(torch, ca, dcn, card)
        if records:
            k4["launches"] = r50_launches["K4"]
            k4["r50_forward_ms"] = r50_fwd_ms
            k1["launches_r50"] = r50_launches["K1"]
            k4.update(c5_times)
    stamp(7)
    if 7 in phases:
        r50_train, k4_fp32_launches = training_phase(torch, check_r50_training, torch, ca, dcn, card)
        if records:
            k4["launches_train"] = r50_train["K4"]
            k4_fp32["launches"] = k4_fp32_launches
            k4_fp32["launches_note"] = "the r50dcn fp32 train step"
    stamp(8)
    if 8 in phases:
        v2_serve, v2_train, v2_times = training_phase(torch, check_petrv2, torch, ca, card)
        if records:
            k1_v2["launches"] = v2_serve["K1"]
            k1_v2["launches_train"] = v2_train["K1"]
            k1_v2.update({f"petrv2_{k}": v for k, v in v2_times.items()})
            k2[4]["launches"], k2[5]["launches"] = v2_train["K2 dK/dV"], v2_train["K2 dQ"]

    stamp(9)
    if 9 in phases:
        d_eval, d_train, d_times = training_phase(torch, check_depthr, torch, ca, dcn, card)
        if records:
            k4["launches_depthr"] = d_eval["K4"] // 3
            k4["launches_depthr_train"] = d_train["K4"] // 3
            k4.update(d_times)

    stamp(10)
    if 10 in phases:
        eval_per_batch, stream_per_frame, eval_times = check_eval(torch, ca, card)
        if records:
            k1["launches_eval"] = eval_per_batch
            k1["eval"] = eval_times
            k1_v2["launches_stream_eval"] = stream_per_frame

    stamp(11)
    if 11 in phases:
        learn, learn_times = training_phase(torch, check_learning, torch, ca, dcn, card)
        if records:
            per_step = {SYNTH_R50: ("LAUNCHES", "DKDV_LAUNCHES", "DQ_LAUNCHES"),
                        SYNTH_VOV: ("LAUNCHES_FP32", "DKDV_LAUNCHES_FP32", "DQ_LAUNCHES_FP32")}
            for preset, suffix in ((SYNTH_R50, ""), (SYNTH_VOV, "_fp32")):
                for counter, name in zip(per_step[preset], ("flash_cross_attention_fwd", "flash_cross_attention_bwd_dkdv",
                                                            "flash_cross_attention_bwd_dq")):
                    synth[f"{name}{suffix}_synth"]["launches"] = learn[preset][counter]
                    synth[f"{name}{suffix}_synth"]["launches_note"] = f"per {preset} train step (cli.train)"
            by_channels = {shape[1]: n for shape, n in learn["K4_by_shape"].items()}
            for label, (_, cin, *_rest) in SYNTH_DCN.items():
                synth[f"deform_conv_fwd_synth_{label}"]["launches"] = by_channels[cin]
                synth[f"deform_conv_fwd_synth_{label}"]["launches_note"] = (
                    f"per {SYNTH_R50} train step (cli.train), forward and remat recompute")
            synth["flash_cross_attention_fwd_synth"]["learning"] = learn_times

    stamp(12)
    if 12 in phases:
        k3, par_times = training_phase(torch, check_parallel, torch, ca, sm_clock_hz, card)
        k3["parallel"] = par_times
        records.append(k3)

    stamp(13)
    if 13 in phases:
        k6, k6_quant = check_conv_int8(torch, c8, card)
        k6_launches, deploy = check_deployment(torch, ca, c8, dcn, card)
        k6["launches"], k6_quant["launches"] = k6_launches["K6"], k6_launches["K6 quant"]
        for r in (k6, k6_quant):
            r["launches_note"] = (f"the int8 flagship's 2 batched forwards through InferenceServer ({INT8_PER_FORWARD} "
                                  "per forward); an artifact call's in deployment.replay_launches")
        k6["deployment"] = deploy
        k6["device_ms_per_forward"] = deploy["k6_device_ms_per_forward"]
        k6_quant["device_ms_per_forward"] = deploy["k6_quant_device_ms_per_forward"]
        replay = deploy["replay_launches"]
        if records:
            k1["launches_artifact"] = replay["flagship_bf16"]["K1"]
            k4["launches_artifact"] = replay["r50"]["K4"]
        records += [k6, k6_quant]

    stamp(14)
    if 14 in phases:
        tools = training_phase(torch, check_tools, torch, ca, c8, card)
        per = tools["launches_per_iter"]
        if 3 in phases:
            k1["launches_benchmark"], k1["launches_benchmark_train"] = per["inference"]["K1"], per["train"]["K1"]
            k2[0]["launches_benchmark_train"], k2[1]["launches_benchmark_train"] = (per["train"]["K2 dK/dV"],
                                                                                    per["train"]["K2 dQ"])
            k1["tools"] = tools
        if 13 in phases:
            k6["launches_benchmark_int8"], k6_quant["launches_benchmark_int8"] = per["int8"]["K6"], per["int8"]["K6 quant"]
    stamp(None)

    seconds = {n: round(stamps[i + 1][1] - t, 1) for i, (n, t) in enumerate(stamps[:-1])}
    log(f"seconds per phase: {json.dumps(seconds)}; the script {time.perf_counter() - t_start:.1f} s")
    if phases != ALL_PHASES:
        log(f"only phases {sorted(phases)} ran: no kernels record and no result line")
        return 1
    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
