"""Convert a reference (mmdet3d) PETR checkpoint into a port checkpoint.

    python -m petr_tpu_torch.cli.convert --config petr_vov_p4_800x320 \
        --torch-ckpt petr_vovnet_gridmask_p4_800x320.pth --out work_dirs/imported \
        [--verbose] [--allow-partial] [--device cuda]

Counterpart of `petr_tpu/cli/convert.py`: released torch checkpoints ->
the port's detector of ``--config`` (``utils.torch_convert``: the legacy
key map, shared or unshared branches, a strict load), written as a
weights-only checkpoint directory (``train.checkpoint.save_params``) that
``cli.test --ckpt`` and ``cli.train --load-from`` read. It prints
petr_tpu's counts; target leaves that the file does not cover are an
error unless ``--allow-partial`` (a backbone-only import keeps the seed-0
initialisation elsewhere). The model is built on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

from petr_tpu_torch.configs import get_config
from petr_tpu_torch.models import PETRDetector, init_weights
from petr_tpu_torch.serve import resolve_device
from petr_tpu_torch.train.checkpoint import save_params
from petr_tpu_torch.utils.torch_convert import load_reference_weights, load_torch_state_dict


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--torch-ckpt", required=True, help=".pth state dict")
    p.add_argument("--out", required=True, help="output checkpoint dir")
    p.add_argument("--verbose", action="store_true", help="print unmatched keys")
    p.add_argument("--allow-partial", action="store_true",
                   help="accept partial coverage (e.g. backbone-only ckpts)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument(
        "--set", nargs="*", default=[], dest="overrides", metavar="KEY=VAL",
    )
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.config, args.overrides)
    model = init_weights(PETRDetector(cfg.model), 0).to(device)
    stats = load_reference_weights(
        model, load_torch_state_dict(args.torch_ckpt), shared_branches=cfg.model.head.shared_branches,
        verbose=args.verbose, allow_partial=True,
    )
    print(f"matched {stats['matched']} / skipped {stats['skipped']} reference "
          f"keys; {stats['unfilled']} target leaves unfilled")
    if stats["unfilled"] and not args.allow_partial:
        raise SystemExit(
            f"{stats['unfilled']} target leaves not covered by the torch "
            "checkpoint — pass --allow-partial for backbone-only imports"
        )
    out = save_params(os.path.abspath(args.out), model, meta={"config": args.config, "overrides": args.overrides,
                                                                "source": os.path.basename(args.torch_ckpt)})
    print(f"wrote {out}")
    return stats


if __name__ == "__main__":
    main()
