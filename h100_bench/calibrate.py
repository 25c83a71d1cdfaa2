"""Readings for the limits of ``correct``: the program, the control and the
faults, over many seeds in one process (the benchmark's runs do not run it).

    python3 -m h100_bench.calibrate --workload <cell> --seeds 11,12,13 --seconds 5 [--control] [--faults]

For each seed: one run of the cell as the benchmark makes it (a short
window) and its compared numbers; with ``--control`` the reference in the
program's place with its products' operands rounded to e4m3; with
``--faults`` each fault of the timed path the cell can have (a train step
on half of the batch; answers exchanged between requests, an error in the
boxes alone, one in the labels alone). The control and each fault are held to the cell's limits by
the benchmark's own ``judge``, and their ``correct`` printed beside their
numbers. One JSON line per seed.
"""

import argparse
import json
import sys
import time

import torch

from h100_bench.harness import free, run_cell
from h100_bench.judge import judge


def worst_leaves(lv, k):
    """The k leaves with the largest gaps of the first gradient and of the
    change, each with (program, reference, reference's raw gradient), and
    the median leaf's numbers."""
    import statistics

    out = {"losses": [lv["program_losses"], lv["reference_losses"]]}
    for what in ("grad", "change"):
        p, r = lv[f"program_{what}"], lv[f"reference_{what}"]
        med = statistics.median(r.values())
        gaps = sorted(((abs(p.get(n, 0.0) - r[n]) / max(r[n], med), n) for n in r), reverse=True)
        out[what] = {"median": med, "share_over_0.1": sum(g > 0.1 for g, _ in gaps) / len(gaps),
                     "worst": [[n, g, p.get(n, 0.0), r[n], lv["reference_raw"][n]] for g, n in gaps[:k]],
                     "quantiles": [gaps[int(q * (len(gaps) - 1))][0] for q in (0.1, 0.25, 0.5, 0.75, 0.9)]}
    return out


def held(program, numbers, limits):
    """``numbers`` (the control's or a fault's) in the program's place, the
    run's other numbers kept, judged as a run is: (correct, numbers)."""
    correct, _ = judge(dict(program, **numbers), limits)
    return dict(numbers, correct=correct)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--leaves", type=int, default=0, help="print the worst leaves of a train cell")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        keep = {}
        t0 = time.perf_counter()
        res = run_cell(args.workload, seed, args.seconds, False, "cuda", keep=keep)
        program = {k: v["value"] for k, v in res["checks"].items()}
        line = {"seed": seed, "correct": res["correct"], "program": program,
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "memory_peak_bytes": res["device"].get("memory_peak_bytes"), "run_s": time.perf_counter() - t0}
        driver = keep["driver"]
        limits = driver.run.cell.limits
        if args.leaves and hasattr(driver, "leaves"):
            line["leaves"] = worst_leaves(driver.leaves, args.leaves)
        if args.control:
            t1 = time.perf_counter()
            line["control"] = held(program, driver.control(), limits)
            line["control_s"] = time.perf_counter() - t1
        if args.faults:
            line["faults"] = {k: held(program, v, limits) for k, v in driver.faults().items()}
        print(json.dumps(line), flush=True)
        del keep, driver
        free("cuda")
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
