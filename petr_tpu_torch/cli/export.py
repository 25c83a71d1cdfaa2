"""Export an AOT serving artifact for deployment.

    python -m petr_tpu_torch.cli.export --config petr_vov_p4_800x320 \
        --ckpt work_dirs/petr_vov/ckpts/step_N --out petr_vov.petrx \
        [--batch-size 1] [--embed-params] [--quant-scales scales.npz] \
        [--streaming] [--device cuda]

Counterpart of `petr_tpu/cli/export.py`: the serving step traced with
``torch.export`` and saved beside its ``meta.json`` in one zip, which
``petr_tpu_torch.runtime.load_artifact`` replays with PyTorch and the
port's op library alone (no model code). With ``--embed-params`` the
weights are in the artifact (one self-contained file); otherwise the
server passes the ``state_dict``'s tensors in order at call time.
``--streaming`` exports PETRv2's streaming pair (feature extractor, head +
decode), replayed by ``StreamingArtifactRunner``. The program is traced on
``--device`` (the card unless ``--device cpu``) and runs there. Without
``--ckpt`` the weights are random, from seed 0.
"""

from __future__ import annotations

import argparse
import os

from petr_tpu_torch.configs import get_config
from petr_tpu_torch.quant import load_scales
from petr_tpu_torch.serve import (
    build_detector,
    export_serving,
    export_streaming,
    resolve_device,
    save_artifact,
    save_streaming_artifact,
)
from petr_tpu_torch.train.checkpoint import load_params


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", default=None, help="checkpoint dir (omit: random init, smoke only)")
    p.add_argument("--out", required=True)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--embed-params", action="store_true")
    p.add_argument("--quant-scales", default=None, metavar="NPZ")
    p.add_argument("--streaming", action="store_true",
                   help="export the streaming pair (feature extractor + head+decode) for a 2-frame "
                   "config; replay with petr_tpu_torch.runtime.StreamingArtifactRunner")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--set", nargs="*", default=[], dest="overrides", metavar="KEY=VAL")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.config, args.overrides)
    quant_scales = load_scales(args.quant_scales) if args.quant_scales else None
    model = build_detector(cfg, seed=0, device=device)
    if args.ckpt:
        load_params(args.ckpt, model)
    kw = dict(batch_size=args.batch_size, embed_params=args.embed_params)
    if args.streaming:
        pair = export_streaming(cfg, model, quant_scales=quant_scales, **kw)
        meta = save_streaming_artifact(args.out, pair, cfg, model, **kw)
    else:
        exported = export_serving(cfg, model, quant_scales=quant_scales, **kw)
        meta = save_artifact(args.out, exported, cfg, model, **kw)
    mb = os.path.getsize(args.out) / 1e6
    print(f"exported {cfg.name} (batch {args.batch_size}, device {meta['device']}, quant {meta['quant']}, "
          f"embed_params={args.embed_params}, ops {meta['op_names']}) -> {args.out} ({mb:.1f} MB)")
    return meta


if __name__ == "__main__":
    main()
