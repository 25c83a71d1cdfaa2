"""Where the bf16 K4 kernel's time goes, from clock64() stamps.

    python -m petr_tpu_torch.tools.k4_clock_split [--source PATH] [--calls N]

Card only. Builds a ``deform_conv.cu`` (by default this checkout's) into
``build/k4_clock_split/`` with its ``K4_STAMP`` hooks defined (a forced
include: ``clock64()`` stamps that each warp's lane 0 adds up by phase),
runs it ``--calls`` times at r50dcn's two DCN stages (6 views of 512x1408)
and prints one JSON line: each phase's share of the warps' clocks, by role.
The stamps cost a few registers and instructions, so the instrumented
kernel is slower than the real one; the shares are what it measures.

The mma.sync design that the wgmma kernel replaced (the source before the
hooks, in the repository's history: check it out and pass its path) has no
hooks; its stamps are put in at fixed lines of that source.

Phases of the wgmma design: the samplers' prologue (the corner table), load
(the next chunk's corners issued), wait_empty (a free stage), sum_store
(the samples summed, rounded, stored, fenced, arrived: this waits for the
loads); the consumers' wait_full (a filled stage), products (wgmma issued
and waited for, the stage released), epilogue. Phases of the mma.sync
design (every warp gathers and multiplies): prologue (the corners, the
first weights, the first sync), gather (the corner loads issued, then the
samples summed and stored, which waits for the loads), wait (cp.async's
wait and the block's sync a chunk), weights (the next chunk's cp.async
issued), products (ldmatrix and mma.sync issued), epilogue.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

STAMPS = """
__device__ unsigned long long k4_clock_sums[8];
#define K4_START unsigned clk[8] = {0, 0, 0, 0, 0, 0, 0, 0}; long long t_ = clock64();
#define K4_STAMP(i) { const long long n_ = clock64(); clk[i] += (unsigned)(n_ - t_); t_ = n_; }
#define K4_FLUSH if ((threadIdx.x & 31) == 0) for (int i_ = 0; i_ < 8; ++i_) \\
    if (clk[i_]) atomicAdd(&k4_clock_sums[i_], (unsigned long long)clk[i_]);
extern "C" int petr_k4_clocks(unsigned long long* host, int zero) {
  cudaError_t e = cudaMemcpyFromSymbol(host, k4_clock_sums, sizeof(k4_clock_sums));
  if (e == cudaSuccess && zero) {
    unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    e = cudaMemcpyToSymbol(k4_clock_sums, z, sizeof(z));
  }
  return (int)e;
}
"""

# the mma.sync source's stamps: (anchor, replacement) pairs, each anchor once in it
MMA_SYNC = [
    ("  const int n0 = blockIdx.y * BN;\n  const int P = Ho * Wo;\n",
     "  const int n0 = blockIdx.y * BN;\n  const int P = Ho * Wo;\n  K4_START\n"),
    ("  __syncthreads();  // the corners are in shared memory\n  gather_load(0, cv);\n  gather_store(0, cv, 0);\n",
     "  __syncthreads();  // the corners are in shared memory\n  K4_STAMP(0)\n  gather_load(0, cv);\n"
     "  gather_store(0, cv, 0);\n  K4_STAMP(1)\n"),
    ("    __syncthreads();  // chunk ch's weights and samples are in; every warp is done with chunk ch - 1\n",
     "    __syncthreads();  // chunk ch's weights and samples are in; every warp is done with chunk ch - 1\n"
     "    K4_STAMP(2)\n"),
    ("    if (more) gather_load(ch + 1, cv);  // in flight during the products\n",
     "    K4_STAMP(3)\n    if (more) gather_load(ch + 1, cv);  // in flight during the products\n    K4_STAMP(1)\n"),
    ("    if (more) gather_store(ch + 1, cv, s ^ 1);\n  }\n",
     "    K4_STAMP(4)\n    if (more) gather_store(ch + 1, cv, s ^ 1);\n    K4_STAMP(1)\n  }\n"),
    ("      for (int u = 0; u < 8 && px + u < P; ++u) dst[u] = src[u];\n    }\n  }\n}\n",
     "      for (int u = 0; u < 8 && px + u < P; ++u) dst[u] = src[u];\n    }\n  }\n  K4_STAMP(5)\n  K4_FLUSH\n}\n"),
]
MMA_SYNC_PHASES = {"all warps": {"prologue": 0, "gather": 1, "wait": 2, "weights": 3, "products": 4, "epilogue": 5}}

WGMMA_PHASES = {"samplers": {"prologue": 0, "load": 1, "wait_empty": 2, "sum_store": 3},
                "consumers": {"wait_full": 4, "products": 5, "epilogue": 6}}
SHAPES = {"stage3": (6, 256, 32, 88, 256), "stage4": (6, 512, 16, 44, 512)}


def instrument(text: str):
    """(the source with its stamps, its phases, its design's name)."""
    if "K4_STAMP(" in text:
        return text, WGMMA_PHASES, "wgmma"
    if "mma_bf16(" not in text:
        raise ValueError("neither the wgmma source with its K4_STAMP hooks nor the mma.sync source")
    for old, new in MMA_SYNC:
        if text.count(old) != 1:
            raise ValueError(f"the mma.sync source does not hold this anchor once: {old[:70]!r}")
        text = text.replace(old, new)
    return text, MMA_SYNC_PHASES, "mma_sync"


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    from petr_tpu_torch.ops import build, dcn

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=str(build.CSRC_DIR / "deform_conv.cu"))
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_clock_split needs a CUDA card", file=sys.stderr)
        return 1
    source = Path(args.source).resolve()
    text, phases, design = instrument(source.read_text())
    work = build.BUILD_DIR / "k4_clock_split"
    work.mkdir(parents=True, exist_ok=True)
    cu, so, stamps = work / f"{design}.cu", work / f"{design}.so", work / "stamps.cuh"
    cu.write_text(text)
    stamps.write_text(STAMPS)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(source.parent), "-include", str(stamps),
                           "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fwd = lib.petr_deform_conv_tc_fwd
    fwd.restype = I_
    fwd.argtypes = ([P_] * 5 if design == "mma_sync" else [P_, P_, P_, I_, P_, P_]) + [I_] * 10 + [P_]
    lib.petr_k4_clocks.argtypes, lib.petr_k4_clocks.restype = [P_, I_], I_
    sums = (ctypes.c_ulonglong * 8)()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"design": design, "source": str(source), "device": torch.cuda.get_device_name(0),
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                  capture_output=True, text=True).stdout.strip(),
           "registers": [line.strip() for line in (proc.stdout + proc.stderr).splitlines() if "registers" in line]}
    for label, (B, Cin, H, W, Cout) in SHAPES.items():
        x = torch.randn(B, Cin, H, W, generator=gen, device="cuda").bfloat16()
        om = torch.cat([torch.randn(B, 18, H, W, generator=gen, device="cuda") * 3.0,
                        torch.randn(B, 9, H, W, generator=gen, device="cuda") * 1.5], 1)
        w = torch.randn(Cout, Cin, 3, 3, generator=gen, device="cuda") * (2.0 / (9 * Cin)) ** 0.5
        Cp = dcn.padded_channels(Cin)
        xs = dcn.channels_last(x, Cp)
        res = torch.empty((B, Cout, H, W), dtype=torch.bfloat16, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        if design == "mma_sync":  # its operands: the sigmoid and the weight repacked to (Cout, 3, 3, Cp)
            mod = torch.sigmoid(om[:, 18:]).contiguous()
            wr = F.pad(w.permute(0, 2, 3, 1), (0, Cp - Cin)).bfloat16().contiguous()
            ptrs = [xs.data_ptr(), om.data_ptr(), mod.data_ptr(), wr.data_ptr(), res.data_ptr()]
        else:  # x and its channels-last copy (made by the call), the weight image
            wimg = dcn.weight_image(w)
            ptrs = [x.data_ptr(), xs.data_ptr(), om.data_ptr(), 0, wimg.data_ptr(), res.data_ptr()]
        dims = [B, Cin, Cp, H, W, Cout, H, W, 1, 1]
        assert fwd(*ptrs, *dims, stream) == 0  # a warm-up launch, then zero the sums
        torch.cuda.synchronize()
        assert lib.petr_k4_clocks(sums, 1) == 0
        for _ in range(args.calls):
            assert fwd(*ptrs, *dims, stream) == 0
        torch.cuda.synchronize()
        assert lib.petr_k4_clocks(sums, 1) == 0
        floor = dcn.modulated_deform_conv_reference(x, om, w, operand_dtype=torch.bfloat16).float()
        err = (res.float() - floor).abs().max().item()
        split = {}
        for role, slots in phases.items():
            total = sum(sums[i] for i in slots.values())
            split[role] = {name: sums[i] / total for name, i in slots.items()}
            split[role]["clocks_per_call"] = total / args.calls
        out[label] = {"split": split, "max_abs_err_vs_floor": err}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
