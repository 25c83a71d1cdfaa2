"""The port stands alone: nothing under petr_tpu_torch/, and not
chip_smoke.py or the parallel tests' rank functions, imports JAX, flax, petr_tpu, the graft entry point or triton,
and importing the package loads no JAX and builds no kernel."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "petr_tpu", "__graft_entry__", "triton")
# the rank functions that spawned ranks of the parallel tests import by name
WORKERS = ROOT / "tests" / "test_torch_port_parallel_workers.py"
PORT_FILES = sorted((ROOT / "petr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", WORKERS]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_nothing_forbidden(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = (
        "import sys\n"
        "import petr_tpu_torch, petr_tpu_torch.configs, petr_tpu_torch.ops, "
        "petr_tpu_torch.models, petr_tpu_torch.serve, petr_tpu_torch.train, petr_tpu_torch.utils, "
        "petr_tpu_torch.data, petr_tpu_torch.metrics, petr_tpu_torch.metrics.submission, "
        "petr_tpu_torch.train.evaluate, petr_tpu_torch.train.checkpoint, petr_tpu_torch.cli.test, "
        "petr_tpu_torch.cli.train, petr_tpu_torch.train.bn_warmup, petr_tpu_torch.train.diagnostics, "
        "petr_tpu_torch.train.forensics, petr_tpu_torch.tools.synth_train_eval, petr_tpu_torch.tools.nan_replay, "
        "petr_tpu_torch.parallel, petr_tpu_torch.parallel.distributed, petr_tpu_torch.parallel.sharded_attention, "
        "petr_tpu_torch.parallel.dryrun, petr_tpu_torch.cli.scaling, tests.test_torch_port_parallel_workers, "
        "petr_tpu_torch.quant, petr_tpu_torch.utils.fuse, petr_tpu_torch.runtime, petr_tpu_torch.cli.quantize, "
        "petr_tpu_torch.cli.export, petr_tpu_torch.utils.mfu, petr_tpu_torch.utils.profiler, "
        "petr_tpu_torch.utils.publish, petr_tpu_torch.utils.torch_convert, petr_tpu_torch.data.native, "
        "petr_tpu_torch.cli.benchmark, petr_tpu_torch.cli.flops, petr_tpu_torch.cli.convert, "
        "petr_tpu_torch.cli.publish, petr_tpu_torch.cli.print_config, petr_tpu_torch.cli.create_data, "
        "petr_tpu_torch.cli.analyze_logs, petr_tpu_torch.cli.browse_dataset, petr_tpu_torch.cli.visualize, "
        "petr_tpu_torch.ops.iou3d, petr_tpu_torch.ops.deformable, petr_tpu_torch.models.detr3d, "
        "petr_tpu_torch.models.dgcnn, petr_tpu_torch.models.positional\n"
        "from petr_tpu_torch.data import native\n"
        "assert not native._TRIED, 'the native loader was looked for on import'\n"
        "from petr_tpu_torch.ops import build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert not build._libs, 'a kernel was loaded on import'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
