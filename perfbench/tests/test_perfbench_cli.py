"""A run without the card, or without the program beside the benchmark, exits with a
non-zero code and prints no result."""

import shutil
import subprocess
import sys

from perfbench import harness


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "higgs.fit", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env,
    )


def test_no_card_no_result():
    import os  # noqa: PLC0415

    out = _run(harness.ROOT, {**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
