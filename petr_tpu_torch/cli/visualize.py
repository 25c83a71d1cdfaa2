"""BEV visualization of predictions vs GT (reference `tools/misc/visualize_results.py`
/ `browse_dataset.py` capability, re-designed as a BEV plot — no open3d GUI).

    python -m petr_tpu_torch.cli.visualize --results results.json --infos val.pkl \
        --out vis/ --num 10 [--score-thr 0.3]

Counterpart of `petr_tpu/cli/visualize.py`, over ``cli.test --out``'s
submission json. A host-only tool: matplotlib is imported inside ``main``
and ``draw_box_bev``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np


def draw_box_bev(ax, box, color, alpha=1.0):
    """box: (cx, cy, cz, w, l, h, yaw[, vx, vy]) — draw BEV rectangle + heading."""
    import matplotlib.transforms as mtransforms
    from matplotlib.patches import Rectangle

    cx, cy, w, l, yaw = box[0], box[1], box[3], box[4], box[6]
    rect = Rectangle(
        (cx - w / 2, cy - l / 2), w, l, fill=False, color=color, alpha=alpha, lw=1.0
    )
    t = mtransforms.Affine2D().rotate_around(cx, cy, yaw) + ax.transData
    rect.set_transform(t)
    ax.add_patch(rect)
    hx = cx + np.cos(yaw + np.pi / 2) * l / 2
    hy = cy + np.sin(yaw + np.pi / 2) * l / 2
    ax.plot([cx, hx], [cy, hy], color=color, alpha=alpha, lw=0.8)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--results", required=True, help="submission-format json")
    p.add_argument("--infos", required=True)
    p.add_argument("--out", default="vis")
    p.add_argument("--num", type=int, default=10)
    p.add_argument("--score-thr", type=float, default=0.3)
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(args.results) as f:
        results = json.load(f)["results"]
    with open(args.infos, "rb") as f:
        data = pickle.load(f)
    infos = data["infos"] if isinstance(data, dict) else data
    by_token = {i["token"]: i for i in infos}

    os.makedirs(args.out, exist_ok=True)
    for n, (tok, dets) in enumerate(results.items()):
        if n >= args.num or tok not in by_token:
            break
        info = by_token[tok]
        fig, ax = plt.subplots(figsize=(8, 8))
        gt = np.asarray(info.get("gt_boxes", np.zeros((0, 7))))
        for b in gt:
            g = b.copy()
            g[2] += g[5] / 2
            draw_box_bev(ax, g, "green")
        for d in dets:
            if d["detection_score"] < args.score_thr:
                continue
            box = [*d["translation"], *d["size"], 2 * np.arctan2(d["rotation"][3], d["rotation"][0])]
            draw_box_bev(ax, box, "red", alpha=min(1.0, d["detection_score"] + 0.2))
        ax.set_xlim(-55, 55)
        ax.set_ylim(-55, 55)
        ax.set_aspect("equal")
        ax.set_title(f"{tok[:12]} (green=GT, red=pred)")
        fig.savefig(os.path.join(args.out, f"{n:03d}_{tok[:8]}.png"), dpi=100)
        plt.close(fig)
    print(f"wrote {min(args.num, len(results))} BEV plots to {args.out}/")


if __name__ == "__main__":
    main()
