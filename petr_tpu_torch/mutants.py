#!/usr/bin/env python3
"""Mutation check of the port on one CUDA card: its bf16 tensor-core
kernels, the r50dcn step's reproducibility, PETRv2's with_time, the
Depthr decoder's key/value rebinding, the checkpoint's resume, the
evaluation's route through K1, batch BN's running statistics, the
training CLI's resume, and parallel training's collectives, dropout draws
and hash offsets.

    python3 -m petr_tpu_torch.mutants [--out DIR] [NAME ...]

For each mutant (every one, or those NAMEd) it copies ``petr_tpu_torch/``
and ``chip_smoke.py`` into a temporary directory, makes one change to one
source there (never in the checkout; a mutant may change several places
of that source), and runs ``chip_smoke.py --phases P``
in the copy with the mutant's phases, which must fail one of its checks:
exit 1 with an AssertionError (a subset of phases exits 1 even when it
passes). Each run's output goes to ``DIR/<mutant>.log`` (default
``build/mutants``); a line per mutant says its exit code and the first
failed check. Exits 0 when every mutant run was caught, 1 otherwise.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> (source under petr_tpu_torch, text, its replacement, the phases that must catch it); text and
# replacement may be tuples of as many changes to the one source
MUTANTS = {
    "k5_tap_shift": (
        "csrc/conv3x3_bn_relu.cu",
        "const uint32_t aj = a + j * 16 + (j / 3) * step3;",
        "const uint32_t aj = a + j * 16 + (j / 3) * step3 + (j == 1) * 16;",  # tap (0, 1) reads column kw = 2
        "3",
    ),
    "k2_hash_row_col_swapped": (
        "csrc/flash_cross_attention_bwd.cu",
        "dropout_keep(mix, qi, key, thresh)",  # dK/dV: the fragment's (key, query) fed as (row, column)
        "dropout_keep(mix, key, qi, thresh)",
        "3",
    ),
    "k1_hash_query_key_swapped": (
        "csrc/flash_cross_attention.cu",
        "dropout_keep(mix, qrow, key, thresh)",  # the bf16 forward: (key, query) fed as (row, column)
        "dropout_keep(mix, key, qrow, thresh)",
        "3",
    ),
    "k4_corner_weight_fy_swapped": (
        "csrc/deform_conv.cu",
        "__fmul_rn(__fmul_rn(cur[i].at(2, e + u), wx0), wy1)",  # the bf16 kernel: corner (y0 + 1, x0) weighted by 1 - fy
        "__fmul_rn(__fmul_rn(cur[i].at(2, e + u), wx0), wy0)",
        "3",
    ),
    "k6_round_half_away": (
        "csrc/conv_int8.cu",
        "const float r = rintf(q);",  # the activation quantisation rounds ties away from zero
        "const float r = roundf(q);",
        "13",
    ),
    "k6_split_partial_dropped": (
        "csrc/conv_int8.cu",
        "bulk_reduce_add(w, part, BM * BN * 4);",  # a split K's first split never reaches the sums
        "if (blockIdx.z != 0) bulk_reduce_add(w, part, BM * BN * 4);",
        "13",
    ),
    "gather_backward_with_atomics": (
        "ops/sampling.py",
        "        v = gather_rows(flat, idx)\n",  # the fix reverted: torch.gather's backward, a scatter_add
        "        v = torch.gather(flat, 1, idx[..., None].expand(B, idx.shape[1], C))\n",
        "7",
    ),
    "depthr_view_attends_memory": (
        "models/depthr_head.py",
        "kv = memory if self.attend_memory else depth",  # cross_view_attn reads the image features
        "kv = memory",
        "9",
    ),
    "v2_dt_sign_swapped": (
        "models/petrv2_head.py",
        "dt = (ts[:, 1] - ts[:, 0]).mean(-1)",  # with_time: the previous frame's step negated
        "dt = (ts[:, 0] - ts[:, 1]).mean(-1)",
        "8",
    ),
    "checkpoint_drops_optimizer_state": (
        "train/checkpoint.py",
        '    state.optimizer.load_state_dict(payload["optimizer"])\n',  # the AdamW moments stay fresh
        "",
        "10",
    ),
    "eval_skips_k1": (
        "train/evaluate.py",
        "        det = eval_step(model, batch)\n",  # every attention on its plain (non-flash) branch
        '        [setattr(m, "use_flash", False) for m in model.modules() if hasattr(m, "use_flash")]\n'
        "        det = eval_step(model, batch)\n",
        "10",
    ),
    "bn_ema_inside_forward": (
        "models/layers.py",
        "            sinks = _moment_sinks()\n",  # the EMA in the module: a recomputed forward applies it again
        "            with torch.no_grad():\n"
        "                self.running_mean.mul_(0.9).add_(0.1 * mean)\n"
        "                self.running_var.mul_(0.9).add_(0.1 * var)\n"
        "            sinks = _moment_sinks()\n",
        "11",
    ),
    "cli_resume_ignores_checkpoint": (
        "cli/train.py",
        "            state = restore_checkpoint(latest, state)\n",  # found, not read: the fresh state trains
        "            pass\n",
        "11",
    ),
    "sharded_combine_backward_all_reduced": (
        "parallel/sharded_attention.py",
        "        return g, None\n",  # the combine's backward all-reduces its cotangent: gradients x group size
        "        return _all_reduce(g, ctx.group), None\n",
        "12",
    ),
    "flash_hash_ignores_key_offset": (
        "csrc/flash_cross_attention.cu",
        # both K1 kernels hash a shard's local key index: every shard draws the first shard's mask
        ("const uint32_t mix = dropout_mix(seed, (uint32_t)bh + bh_offset, key_offset);\n\n  // logits",
         "const uint32_t mix = dropout_mix(seed, (uint32_t)bh + bh_offset, key_offset);\n  const float sl2"),
        ("const uint32_t mix = dropout_mix(seed, (uint32_t)bh + bh_offset, 0u);\n\n  // logits",
         "const uint32_t mix = dropout_mix(seed, (uint32_t)bh + bh_offset, 0u);\n  const float sl2"),
        "12",
    ),
    "dp_noise_drawn_local": (
        "models/layers.py",
        # each rank draws a dropout mask of its local shape: every rank drops as global row 0
        "        keep = torch.rand((B, *x.shape[1:]), generator=generator, device=x.device)[b0:b0 + x.shape[0]] >= rate\n",
        "        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate\n",
        "12",
    ),
}


def run(name: str, source: str, text: str, replacement: str, phases: str, out: Path) -> bool:
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        shutil.copytree(ROOT / "petr_tpu_torch", work / "petr_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", work / "chip_smoke.py")
        path = work / "petr_tpu_torch" / source
        code = path.read_text()
        texts, replacements = (text, replacement) if isinstance(text, tuple) else ((text,), (replacement,))
        for t, r in zip(texts, replacements):
            if code.count(t) != 1:
                print(f"mutant {name}: the text to change occurs {code.count(t)} times in {source}")
                return False
            code = code.replace(t, r)
        path.write_text(code)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases", phases], cwd=work,
                              capture_output=True, text=True)
        elapsed = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    (out / f"{name}.log").write_text(log)
    failed = [line for line in log.splitlines() if line.startswith("AssertionError")]
    last_check = [line for line in proc.stdout.splitlines() if "max abs err" in line or "bit for bit" in line
                  or "relative error" in line][-1:]
    caught = proc.returncode == 1 and bool(failed)
    print(f"mutant {name} ({source}, phases {phases}): exit {proc.returncode} after {elapsed:.1f} s, "
          f"{'caught' if caught else 'NOT caught'}: {failed[0] if failed else 'no assertion failed'}"
          + (f"; last comparison: {last_check[0].strip()}" if last_check else ""), flush=True)
    return caught


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "mutants")
    parser.add_argument("names", nargs="*", help=f"the mutants to run, of {', '.join(MUTANTS)} (default: all)")
    args = parser.parse_args()
    unknown = sorted(set(args.names) - set(MUTANTS))
    if unknown:
        parser.error(f"unknown mutants {unknown}")
    args.out.mkdir(parents=True, exist_ok=True)
    results = [run(name, *MUTANTS[name], args.out) for name in (args.names or MUTANTS)]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
