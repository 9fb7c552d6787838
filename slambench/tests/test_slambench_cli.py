"""The command exits non-zero and prints no result without a CUDA device,
and in a directory that holds only BENCHMARK.json and the benchmark."""

import shutil
import subprocess
import sys

import pytest
import torch

from slambench import harness


def _run(cwd):
    return subprocess.run([sys.executable, "slambench/run.py", "--workload",
                           "sift128_tum1.explore", "--seed", str(2 ** 31 + 9), "--seconds", "1"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = _run(harness.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / harness.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
