"""The harness finds each cell's files by name, and a new cell, mix and
per-layer metric need new files and a ``workloads`` entry only."""

import json
import re
import shutil

import pytest

from h100_bench.harness import REPO, load_cell, load_reader

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = load_cell(cell)
    assert c.mix["kind"] in ("serve", "train", "infer")
    assert c.config["name"] == c.workload["config"]
    assert c.end_to_end() and any(m["name"] == "setup_s" for m in c.end_to_end())
    assert len(c.end_to_end()) >= 2 and c.per_layer()
    for m in c.per_layer():
        read, data = load_reader(REPO, m["name"])
        assert callable(read) and isinstance(data, dict)
        assert m["moves"] in {e["name"] for e in c.end_to_end()}
    assert set(c.limits), "each cell has its limits file"


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    line = re.compile(r"^[^\t\n]{1,200}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and all(line.match(w) for w in BENCH["command"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("h100_bench/")
        assert line.match(c["source"]) and line.match(c["why"]) and len(c["reduced"]) <= 16
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and line.match(w["why"])
        assert w["chips"] in (1, 4) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher") and line.match(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"server", "model step", "kernels", "device"}
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_a_new_cell_mix_and_metric_are_new_files_only(tmp_path):
    root = tmp_path / "root"
    shutil.copytree(REPO / "h100_bench", root / "h100_bench",
                    ignore=shutil.ignore_patterns("*.py", "__pycache__", "reference"))
    shutil.copytree(REPO / "h100_bench" / "metrics", root / "h100_bench" / "metrics", dirs_exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    before = {p.relative_to(root): p.read_bytes() for p in (root / "h100_bench").rglob("*") if p.is_file()}
    # the new files: a bursty mix, a metric with its reader and data, the cell's limits
    (root / "h100_bench" / "traffic" / "bursty_b8.json").write_text(json.dumps(
        {"kind": "serve", "batch": 8, "max_delay_ms": 5.0, "arrival": "onoff", "rate_per_s": 40.0, "on_s": 0.5,
         "off_s": 0.5, "pool": 64, "check_requests": 16, "trace_seconds": 4.0}))
    (root / "h100_bench" / "metrics" / "queue_wait_ms.serve.py").write_text(
        "def read(ctx):\n    return ctx['data']['scale'] * 2.0\n")
    (root / "h100_bench" / "metrics" / "queue_wait_ms.serve.json").write_text(json.dumps({"scale": 1.5}))
    (root / "h100_bench" / "limits" / "vov800_serve_b8_bursty.json").write_text(json.dumps(
        {"limits": {"logit_gap": 1.0, "box_gap": 1.0, "failed_requests": 0.0}}))
    bench["workloads"].append({"name": "vov800_serve_b8_bursty", "config": "vov800", "traffic": "bursty_b8",
                               "chips": 1, "why": "on/off bursts at the same mean rate"})
    bench["end_to_end"][0]["workloads"].append("vov800_serve_b8_bursty")
    bench["per_layer"].append({"name": "queue_wait_ms.serve", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "server", "moves": "serve_p95_ms",
                               "workloads": ["vov800_serve_b8_bursty"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("vov800_serve_b8_bursty", root)
    assert cell.mix["arrival"] == "onoff" and cell.config["preset"] == "petr_vov_p4_800x320"
    assert [m["name"] for m in cell.per_layer()] == ["queue_wait_ms.serve"]
    read, data = load_reader(root, "queue_wait_ms.serve")
    assert read({"data": data}) == 3.0
    after = {p.relative_to(root): p.read_bytes() for p in (root / "h100_bench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items()), "no file that was there changed"
    # the old cells are untouched by the addition
    assert [m["name"] for m in load_cell("vov800_serve_b8_poisson", root).per_layer()] == [
        m["name"] for m in load_cell("vov800_serve_b8_poisson").per_layer()]
