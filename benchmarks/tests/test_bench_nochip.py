"""A run without the card, or without the program beside the benchmark,
fails and prints no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from bench_small import BENCH_DIR, ROOT

ARGS = ["--workload", "fhvae.timit.k8", "--seed", str(2**31 + 3),
        "--seconds", "10", "--trace", "0"]


def no_result(out: str) -> bool:
    for line in out.strip().splitlines()[-1:]:
        try:
            return not isinstance(json.loads(line), dict)
        except ValueError:
            return True
    return True


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), *ARGS],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 2
    assert no_result(p.stdout)
    assert "CUDA" in p.stderr


def test_benchmark_alone_fails(tmp_path):
    """A checkout of ``BENCHMARK.json`` and ``benchmarks/`` alone: the
    program is missing, so the run fails before any result (the card's
    check is skipped so that the CPU reaches the import)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import sys; sys.path.insert(0, 'benchmarks'); import run; "
            f"sys.exit(run.main({ARGS!r}, device='cpu'))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert no_result(p.stdout)
    assert "pytorch_scalablefhvae_tpu_torch" in p.stderr
