"""Print a resolved experiment config (reference `tools/misc/print_config.py`).

    python -m petr_tpu_torch.cli.print_config --config petr_vov_p4_800x320 [--set KEY=VAL ...]

Counterpart of `petr_tpu/cli/print_config.py`: the port's presets and
overrides, as the same JSON (``--list``, or no ``--config``, names them).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from petr_tpu_torch.configs import get_config, list_configs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None)
    p.add_argument("--list", action="store_true")
    p.add_argument(
        "--set", nargs="*", default=[], dest="overrides", metavar="KEY=VAL",
        help="dotted config overrides, e.g. model.head.num_query=600",
    )
    args = p.parse_args(argv)

    if args.list or not args.config:
        for name in list_configs():
            print(name)
        return
    cfg = get_config(args.config, args.overrides)
    print(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))


if __name__ == "__main__":
    main()
