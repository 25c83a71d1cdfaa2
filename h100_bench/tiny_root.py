"""A throwaway benchmark root at ``tiny_debug`` size for the CPU tests.

``make_tiny_root(dir)`` writes ``BENCHMARK.json`` and the data files of
three cells (serve, train, infer) of the port's ``tiny_debug`` preset in
fp32 with GridMask on, beside copies of the real per-layer metrics: the
harness runs them from ``dir`` exactly as it runs the real cells, without
any file of the repository's benchmark changed.
"""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from h100_bench.harness import REPO

TINY_OVERRIDES = ["model.use_grid_mask=True"]
TINY_LIMITS = {
    "tiny_serve": {"logit_gap": 1e-4, "box_gap": 1e-4, "failed_requests": 0.0},
    "tiny_infer": {"logit_gap": 1e-4, "box_gap": 1e-4},
    "tiny_train": {"loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 0.1, "skipped_steps": 0.0},
}
TINY_MIXES = {
    "tiny_serve": {"kind": "serve", "batch": 2, "max_delay_ms": 5.0, "arrival": "poisson", "rate_per_s": 8.0,
                   "pool": 4, "check_requests": 3, "trace_seconds": 0.5},
    "tiny_train": {"kind": "train", "batch": 2, "pool_batches": 2, "gt_per_sample": [3, 10], "checked_steps": 3,
                   "total_steps": 100, "trace_seconds": 0.5},
    "tiny_infer": {"kind": "infer", "batch": 2, "pool_batches": 2, "check_samples": 3, "trace_seconds": 0.5},
}


def tiny_config() -> dict:
    from petr_tpu_torch.configs import get_config

    c = get_config("tiny_debug", TINY_OVERRIDES)
    t = copy.deepcopy(json.loads((REPO / "h100_bench" / "configs" / "vov800.json").read_text()))
    hc = c.model.head
    t.update(name="tiny", preset="tiny_debug", overrides=TINY_OVERRIDES, reduced=[])
    t["model"]["backbone"]["spec"] = c.model.backbone.spec
    t["model"]["head"].update(num_query=hc.num_query, embed_dim=hc.embed_dim, num_layers=hc.num_layers,
                              num_heads=hc.num_heads, ffn_dim=hc.ffn_dim, depth_num=hc.depth_num)
    t["model"]["compute_dtype"] = c.model.compute_dtype
    t["data"].update(image_size=list(c.data.image_size), max_gt=c.data.max_gt)
    t["optim"]["warmup_iters"] = c.train.optim.warmup_iters
    return t


def make_tiny_root(root: Path) -> Path:
    root = Path(root)
    data = root / "h100_bench"
    for sub in ("configs", "traffic", "limits"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "h100_bench" / "metrics", data / "metrics", dirs_exist_ok=True)
    (data / "configs" / "tiny.json").write_text(json.dumps(tiny_config(), indent=1))
    for name, mix in TINY_MIXES.items():
        (data / "traffic" / f"{name}.json").write_text(json.dumps(mix))
        (data / "limits" / f"{name}.json").write_text(json.dumps({"limits": TINY_LIMITS[name]}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "tiny_debug", "file": "h100_bench/configs/tiny.json",
                         "reduced": []}]
    bench["workloads"] = [{"name": n, "config": "tiny", "traffic": n, "chips": 1, "why": "CPU rehearsal"}
                          for n in TINY_MIXES]
    kind = {"serve": "tiny_serve", "train": "tiny_train", "infer": "tiny_infer"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({kind[_kind_of(w)] for w in m["workloads"]})
    # the metrics of the training and evaluation kinds, whose readers wait for their cells (PERF.md, Open questions)
    for cell, e2e, names in (
            ("tiny_train", "train_samples_per_s",
             ("mfu_pct.train", "attn_roofline_pct.train", "dcn_bwd_roofline_pct.train", "idle_pct.train")),
            ("tiny_infer", "infer_samples_per_s",
             ("mfu_pct.infer", "dcn_fwd_roofline_pct.infer", "attn_fwd_roofline_pct.infer", "idle_pct.infer"))):
        bench["end_to_end"].append({"name": e2e, "unit": "samples/s", "better": "higher", "bound": 0.05,
                                    "source": "host_clock", "workloads": [cell]})
        for name in names:
            bench["per_layer"].append({"name": name, "unit": "%", "better": "higher", "source": "device_trace",
                                       "layer": "kernels", "moves": e2e, "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def _kind_of(cell: str) -> str:
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    traffic = [w["traffic"] for w in bench["workloads"] if w["name"] == cell][0]
    return json.loads((REPO / "h100_bench" / "traffic" / f"{traffic}.json").read_text())["kind"]
