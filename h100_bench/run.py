"""The benchmark's command: one run of one cell, one JSON line.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. Prints the result as the last line of standard output, and each number
that decides ``correct`` beside its limit as the last lines of standard
error. Exits 2 without a result where CUDA is missing or the cell asks for
more cards than there are, and 3 where JAX or petr_tpu was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # kernel caches at fixed paths inside the checkout (the port's nvcc
    # builds go to its build/ there already)
    cache = CHECKOUT / "build" / "h100_bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))

    import torch

    from h100_bench.harness import forbidden_modules, load_cell, run_cell

    chips = load_cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100_bench: the cell {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start=T0)
    bad = forbidden_modules()
    if bad:
        print(f"h100_bench: modules loaded in this process that the port must not load: {bad}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
