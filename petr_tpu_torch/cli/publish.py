"""Publish a trained checkpoint: weights only, sha256-tagged filename.

    python -m petr_tpu_torch.cli.publish --ckpt work_dirs/x/ckpts/step_N --out petr_vov.pt

Counterpart of `petr_tpu/cli/publish.py` (reference
`tools/model_converters/publish_model.py:16-27`: strip the optimizer state,
append a sha256 tag to the filename), on a port checkpoint directory.
"""

from __future__ import annotations

import argparse

from petr_tpu_torch.utils.publish import publish_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True, help="a checkpoint directory of train.checkpoint")
    p.add_argument("--out", required=True, help="output path (tag inserted before ext)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    final = publish_checkpoint(args.ckpt, args.out)
    print(f"published {final}")
    return final


if __name__ == "__main__":
    main()
