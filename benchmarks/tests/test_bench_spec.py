"""``BENCHMARK.json`` against the benchmark's contract, every file it
names found by name, and a configuration, traffic mix, cell and metric
added as new files and entries alone."""

from __future__ import annotations

import json

import pytest

from bench_small import BENCH_DIR, ROOT
from fhbench import spec

BENCH = spec.load()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "benchmarks/run.py"]
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units_are_allowed():
    assert spec.problems(BENCH) == []


def test_check_fits_with_24_cells():
    seconds = (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
    assert seconds <= 43200


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(w):
    cell = spec.cell(BENCH, w["name"])
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
        if m in cell.per_layer:
            assert m["moves"] in e2e
    assert cell.limits and all("limit" in v for v in cell.limits.values())
    assert w["chips"] == 1


def test_bounds_and_metric_entries():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith(("_roofline.train", "_roofline.hier")) or \
                "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_config_files_are_under_paths_and_name_no_width_cut():
    widths = ("_dim", "_rank", "hus", "hidden", "size")
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmarks/")
        assert not [k for k in c["reduced"] if k.endswith(widths)]
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (BENCH_DIR / "reference" / f"{cfg['reference']}.py").exists()
        assert (BENCH_DIR / "roofline" / f"{cfg['flops']}.py").exists()


def test_an_added_entry_loads_by_name(small_root):
    """A later benchmark adds a mix, a cell and a metric as files and
    entries only: the copy's new ones load with nothing else changed."""
    bench_dir = small_root / "benchmarks"
    (bench_dir / "metrics" / "epochs_run.train.py").write_text(
        "def read(r):\n    return r.epochs\n")
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "epochs_run.train", "unit": "epochs", "better": "higher",
        "source": "program_span", "layer": "train loop between epochs",
        "moves": "train_segments_per_s", "workloads": ["small_fhvae.k2"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell(spec.load(small_root), "small_fhvae.k2", small_root,
                     bench_dir)
    assert "epochs_run.train" in [m["name"] for m in cell.per_layer]
    assert cell.config["model_type"] == "fhvae"
    assert cell.traffic["flags"][:2] == ["--steps-per-dispatch", "2"]
    read = spec.reader("epochs_run.train", bench_dir)
    assert read(type("R", (), {"epochs": 3})()) == 3


def test_text_fields_fit():
    texts = [e[k] for grp in ("configs", "workloads") for e in BENCH[grp]
             for k in ("why", "source") if k in e]
    texts += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
