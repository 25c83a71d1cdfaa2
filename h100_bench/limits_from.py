"""A cell's limits for ``correct`` from its calibration readings.

    python3 -m h100_bench.limits_from --workload <cell> readings.jsonl [more.jsonl ...] [--write]

Reads ``calibrate``'s JSON lines of one cell. For each compared number: the lower reading is the largest the program gave
over its seeds; the upper reading the smallest the control gave and, in a
training cell, the smallest any fault gave where that fault reads ten times
the lower reading or more. Where the upper reading is three times the lower
or more, the limit lies between them, nearer the lower on a log scale but
with more room above it: lower x (upper / lower) ** 0.4. A number without an
upper reading gets no limit and is printed as such. ``skipped_steps`` and
``failed_requests`` are exact: limit 0, and a sound
run that reads more is printed as such. With ``--write`` the limits and
their readings go to ``h100_bench/limits/<cell>.json``.
"""

import argparse
import json
import sys

from h100_bench.harness import REPO, load_cell

EXACT = ("skipped_steps", "failed_requests")


def limits(lines, train: bool):
    keys = list(lines[0]["program"])
    out, readings = {}, {}
    for k in keys:
        prog = [ln["program"][k] for ln in lines]
        lower = max(prog)
        if k in EXACT:
            out[k] = 0.0
            readings[k] = {"lower": lower, "seeds": len(prog)}
            if lower > 0:
                print(f"{k}: sound runs read up to {lower}, over its exact limit", file=sys.stderr)
            continue
        ctrl = [ln["control"][k] for ln in lines if "control" in ln and k in ln["control"]]
        faults = [f[k] for ln in lines for f in ln.get("faults", {}).values() if k in f] if train else []
        upper_c = min(ctrl) if ctrl else None
        strong = [f for f in faults if f >= 10.0 * lower]
        candidates = ([upper_c] if upper_c is not None and upper_c >= 3.0 * lower else []) + strong
        upper = min(candidates) if candidates else None
        readings[k] = {"lower": lower, "seeds": len(prog), "control_min": upper_c, "control_runs": len(ctrl),
                       "faults_min": min(faults) if faults else None, "upper": upper}
        out[k] = None if upper is None else lower * (upper / lower) ** 0.4
    return out, readings


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("files", nargs="+")
    p.add_argument("--write", action="store_true")
    args = p.parse_args(argv)
    lines = [json.loads(ln) for f in args.files for ln in open(f) if ln.strip().startswith("{")]
    lim, readings = limits(lines, load_cell(args.workload).mix["kind"] == "train")
    out = {"limits": lim, "readings": readings}
    print(json.dumps(out, indent=1))
    if args.write:
        (REPO / "h100_bench" / "limits" / f"{args.workload}.json").write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
