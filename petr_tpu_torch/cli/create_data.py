"""Data-prep CLI (reference `tools/create_data.py` capability).

    python -m petr_tpu_torch.cli.create_data --data-root /data/nuscenes \
        --version v1.0-trainval --out-prefix data/nuscenes/petr

Counterpart of `petr_tpu/cli/create_data.py`: builds the train/val info
.pkl files that ``NuScenesDataset`` reads (``data.info``). Requires the
nuscenes-devkit (imported inside ``build_infos``) and the raw dataset.
"""

from __future__ import annotations

import argparse

from petr_tpu_torch.data.info import build_infos, save_infos


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", required=True)
    p.add_argument("--version", default="v1.0-trainval",
                   choices=["v1.0-trainval", "v1.0-mini", "v1.0-test"])
    p.add_argument("--out-prefix", required=True)
    p.add_argument("--max-prev-frames", type=int, default=30)
    args = p.parse_args(argv)

    infos = build_infos(args.data_root, args.version, args.max_prev_frames)
    save_infos(infos, args.out_prefix)
    for split, data in infos.items():
        print(f"{split}: {len(data)} samples")


if __name__ == "__main__":
    main()
