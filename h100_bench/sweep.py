"""The serving cell's rate sweep: latency against offered load, in one process.

    python3 -m h100_bench.sweep --workload vov800_serve_b8_poisson --rates 16,24,32 --repeats 3 --seconds 20 --seed 7

Builds the cell once, then offers each rate for ``seconds`` (the mix's
arrival law at that rate), the rates in turn and the whole round
``repeats`` times, and prints, per window, the p50 and p95 latency, the
completed share, the calls and their mean time, and the garbage
collector's passes in the window. The capacity is the highest rate below
the first one whose p95 lies above the low-load p95 in every round; the
cell's mix offers a fixed four fifths of it.
"""

import argparse
import json
import statistics
import sys
import time

from h100_bench.harness import DRIVERS, Run, collector_pauses, load_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--repeats", type=int, default=1)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    run = Run(cell, args.seed, "cuda", time.perf_counter())
    drv = DRIVERS["serve"](run)
    drv.setup()
    for repeat in range(args.repeats):
        for rate in (float(r) for r in args.rates.split(",")):
            run.mix = dict(cell.mix, rate_per_s=rate)
            drv.calls.clear()
            with collector_pauses() as pauses:
                drv.window(args.seconds, False)
            lat = sorted(run.ctx["latencies_ms"])
            calls = list(drv.calls)
            print(json.dumps({
                "repeat": repeat, "rate": rate, "requests": run.attempted, "failed": run.failed,
                "p50_ms": lat[len(lat) // 2], "p95_ms": run.e2e["serve_p95_ms"], "drain_s": run.ctx["drain_s"],
                "calls": len(calls), "fill": run.attempted / max(len(calls) * drv.B, 1),
                "call_ms_mean": 1e3 * statistics.mean(t1 - t0 for t0, t1 in calls) if calls else None,
                "generator_late_ms_p95": run.ctx["generator_late_ms_p95"], "gc": pauses}), flush=True)
            drv.open_server()
    drv.server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
