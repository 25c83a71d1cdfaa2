"""Training-log analysis (reference `tools/analysis_tools/analyze_logs.py`).

    python -m petr_tpu_torch.cli.analyze_logs cal_train_time work_dirs/x/train_log.jsonl
    python -m petr_tpu_torch.cli.analyze_logs plot_curve log1.jsonl log2.jsonl \
        --keys loss loss_cls --out curves.png

Counterpart of `petr_tpu/cli/analyze_logs.py`, over the JSON lines that
``cli.train`` writes (``train_log.jsonl``; the same records as petr_tpu's).
``plot_curve`` needs matplotlib, imported inside it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def load(path):
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))
    return recs


def cal_train_time(paths):
    for path in paths:
        recs = load(path)
        times = [r["time_per_iter"] for r in recs if "time_per_iter" in r]
        if not times:
            print(f"{path}: no timing records")
            continue
        t = np.asarray(times[1:] or times)  # drop the first (warm-up)
        print(
            f"{path}: mean {t.mean():.4f}s/iter, std {t.std():.4f}, "
            f"fastest {t.min():.4f}, slowest {t.max():.4f}"
        )


def plot_curve(paths, keys, out):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(keys), figsize=(6 * len(keys), 4))
    if len(keys) == 1:
        axes = [axes]
    for path in paths:
        recs = load(path)
        for ax, key in zip(axes, keys):
            xs = [r["step"] for r in recs if key in r]
            ys = [r[key] for r in recs if key in r]
            ax.plot(xs, ys, label=path)
            ax.set_xlabel("step")
            ax.set_title(key)
            ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"wrote {out}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("task", choices=["cal_train_time", "plot_curve"])
    p.add_argument("logs", nargs="+")
    p.add_argument("--keys", nargs="+", default=["loss"])
    p.add_argument("--out", default="curves.png")
    args = p.parse_args(argv)
    if args.task == "cal_train_time":
        cal_train_time(args.logs)
    else:
        plot_curve(args.logs, args.keys, args.out)


if __name__ == "__main__":
    main()
