"""Visualize pipeline output: augmented camera images with projected GT boxes
(reference `tools/misc/browse_dataset.py` capability).

    python -m petr_tpu_torch.cli.browse_dataset --config petr_vov_p4_800x320 \
        --infos val.pkl --data-root /data/nuscenes --out browse/ --num 3

Counterpart of `petr_tpu/cli/browse_dataset.py`, over the port's loader. A
host-only tool: matplotlib is imported inside ``main``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from petr_tpu_torch.configs import get_config
from petr_tpu_torch.data import NuScenesDataset
from petr_tpu_torch.ops.boxes import box_corners

EDGES = [
    (0, 1), (1, 3), (3, 2), (2, 0), (4, 5), (5, 7), (7, 6), (6, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--infos", required=True)
    p.add_argument("--data-root", default="")
    p.add_argument("--out", default="browse")
    p.add_argument("--num", type=int, default=3)
    p.add_argument("--train", action="store_true", help="apply train-time aug")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cfg = get_config(args.config)
    ds = NuScenesDataset.from_pkl(
        args.infos, cfg.data, training=args.train, data_root=args.data_root
    )
    os.makedirs(args.out, exist_ok=True)

    mean = np.asarray(cfg.data.mean)
    std = np.asarray(cfg.data.std)
    for idx in range(min(args.num, len(ds))):
        s = ds.get(idx, seed=0)
        n_views = min(6, s["images"].shape[0])
        fig, axes = plt.subplots(2, 3, figsize=(15, 6))
        corners = box_corners(torch.as_tensor(s["gt_boxes"][None])).numpy()[0]  # (G, 8, 3)
        for v in range(n_views):
            ax = axes[v // 3][v % 3]
            img = s["images"][v] * std + mean  # un-normalize (BGR)
            ax.imshow(np.clip(img[..., ::-1], 0, 255).astype(np.uint8))
            l2i = s["lidar2img"][v]
            for g in range(len(corners)):
                if not s["gt_valid"][g]:
                    continue
                hom = np.concatenate([corners[g], np.ones((8, 1))], -1)
                uvd = hom @ l2i[:3].T
                if (uvd[:, 2] < 0.1).any():
                    continue
                uv = uvd[:, :2] / uvd[:, 2:3]
                for a, b in EDGES:
                    ax.plot(uv[[a, b], 0], uv[[a, b], 1], "lime", lw=0.6)
            ax.set_xlim(0, img.shape[1])
            ax.set_ylim(img.shape[0], 0)
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(os.path.join(args.out, f"sample_{idx:03d}.png"), dpi=110)
        plt.close(fig)
    print(f"wrote {min(args.num, len(ds))} figures to {args.out}/")


if __name__ == "__main__":
    main()
