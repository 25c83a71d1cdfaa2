"""The measurement path refuses to run without a card."""

import subprocess
import sys

import pytest
import torch

from h100_bench.harness import REPO


@pytest.mark.skipif(torch.cuda.is_available(), reason="this test checks the refusal on a machine without a card")
def test_run_refuses_without_a_card_and_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload", "vov800_serve_b8_poisson",
                        "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 2, p.stderr
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_refuses_a_checkout_holding_only_the_benchmark(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files the
    port cannot be imported: the run fails and prints no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "h100_bench", tmp_path / "h100_bench", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload", "vov800_serve_b8_poisson",
                        "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_serving_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload", "vov800_serve_b8_poisson",
                        "--seed", str(2**31 + 77), "--seconds", "3", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert '"correct": true' in p.stdout.strip().splitlines()[-1]
