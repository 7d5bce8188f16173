"""``BENCHMARK.json`` and the files it names, found by name.

A cell (one entry of ``workloads``) resolves to its configuration's file
(the ``file`` of its ``configs`` entry), its traffic mix
(``traffic/<traffic>.json``), the limits of its correctness check
(``limits/<workload>.json``) and the readers of its metrics
(``metrics/<metric>.py``), all under the benchmark's folder. Adding a
configuration, a traffic mix, a cell or a metric adds files and entries;
nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclass
class Cell:
    """One workload with everything it names."""

    workload: dict
    config_entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.workload["name"]


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: dict, workload: str, e2e: list) -> bool:
    """Whether ``workload`` reports ``metric``: it lists the cell, or it
    lists none and (for a per-layer metric) the cell reports the end-to-end
    metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        return any(m["name"] == metric["moves"] for m in e2e)
    return True


def cell(bench: dict, workload: str, root: Path = ROOT,
         bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell named ``workload``; raises ``KeyError`` for an unknown
    name."""
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if reports(m, workload, [])]
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, workload, e2e)]
    return Cell(
        workload=w, config_entry=entry,
        config=json.loads((root / entry["file"]).read_text()),
        traffic=json.loads(
            (bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads(
            (bench_dir / "limits" / f"{workload}.json").read_text()),
        end_to_end=e2e, per_layer=per_layer)


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def problems(bench: dict) -> list:
    """Names and units outside the allowed characters, and names used
    twice."""
    out = []
    groups = {"configs": bench["configs"], "workloads": bench["workloads"],
              "metrics": bench["end_to_end"] + bench["per_layer"]}
    for group, entries in groups.items():
        names = [e["name"] for e in entries]
        out += [f"{group}: {n!r} twice" for n in set(names)
                if names.count(n) > 1]
        out += [f"{group}: bad name {n!r}" for n in names
                if not NAME.fullmatch(n)]
    for w in bench["workloads"]:
        out += [f"workload {w['name']}: bad {k} {w[k]!r}"
                for k in ("config", "traffic") if not NAME.fullmatch(w[k])]
    for c in bench["configs"]:
        out += [f"config {c['name']}: bad reduced key {k!r}"
                for k in c["reduced"] if not NAME.fullmatch(k)]
    out += [f"metric {m['name']}: bad unit {m['unit']!r}"
            for m in groups["metrics"] if not UNIT.fullmatch(m["unit"])]
    return out
