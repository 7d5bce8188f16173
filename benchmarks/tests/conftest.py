"""The benchmark's CPU tests: its folder on the import path, and a copy
of the benchmark with small cells (``bench_small.py``)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[2])]

from bench_small import small_copy  # noqa: E402


@pytest.fixture
def small_root(tmp_path) -> Path:
    """A copy of ``BENCHMARK.json`` and the benchmark's folder with the
    small cells added."""
    return small_copy(tmp_path)
