"""Small cells for the benchmark's CPU tests: a copy of the benchmark whose
``BENCHMARK.json`` adds cells that the program's plain CPU path runs in
seconds, and a run of one through ``run.py``."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

SMALL = {"z1_hus": [16, 16], "z2_hus": [16, 16], "x_hus": [16, 16],
         "z1_dim": 4, "z2_dim": 4, "feat_dim": 8, "seg_len": 20,
         "seg_shift": 8}


def small_config(model: str, batch: int) -> dict:
    flags = ["--model-type", model, "--z1-hus", "16", "16", "--z2-hus", "16",
             "16", "--x-hus", "16", "16", "--z1-dim", "4", "--z2-dim", "4",
             "--training-batch-size", str(batch), "--dev-batch-size", "64"]
    fhvae = model == "fhvae"
    if fhvae:
        flags += ["--lstm-mm-dtype", "bfloat16"]
    return {"model_type": model, "source": "small widths for the CPU tests",
            "flags": flags, "widths": SMALL, "pz2_std": 0.5,
            "mu2_init_std": 1.0, "grad_clip_norm": 100.0,
            "control": ({"lstm": "fp8", "dense": "tf32"} if fhvae
                        else {"dense": "tf32"}),
            "reference": model, "flops": model,
            "peak": "bf16_dense" if fhvae else "fp32", "reduced": []}


def small_traffic(rounds: bool) -> dict:
    flags = ["--steps-per-dispatch", "2"]
    if rounds:
        # a budget under the store's 125 kB and over a round's, so that each
        # round stages its own sub-pack, as the LibriSpeech cell does
        flags += ["--hierarchical", "--num-hierarchical-sequences", "20",
                  "--device-store-max-bytes", "110000"]
    return {"kind": "train", "flags": flags,
            **({"warm_epochs": 0} if rounds else {}),
            "corpus": {"feat_dim": 8, "offset_std": 2.0, "drift_std": 0.3,
                       "noise_std": 0.5,
                       "train": {"sequences": 60, "frames": [40, 90]},
                       "dev": {"sequences": 10, "frames": [40, 90]}}}


def small_stream_traffic() -> dict:
    """A budget one byte under the store's 124,928 bytes and chunks of 35 kB:
    auto streams the store in four chunks of six or seven batches of 16,
    and three chunks leave room for the 18,656-byte dev split, which is
    staged, as in the LibriSpeech cell."""
    return {"kind": "stream", "warm_epochs": 0,
            "flags": ["--steps-per-dispatch", "2", "--data-placement", "auto",
                      "--device-store-max-bytes", "124927",
                      "--stream-chunk-bytes", "35000"],
            "corpus": small_traffic(False)["corpus"]}


# set from small runs on the CPU: sound ones read loss 7e-6-7e-5 (the
# first three steps), its replay 5e-6-6e-5, grad 6e-3-6e-2, update
# 1e-3-1e-2, table 8e-3, dev bound 1e-5-3e-4; the control (fp8 LSTM
# operands, TF32 products) reads loss 8e-4-2e-3, and half of each batch
# left out reads loss and its replay 0.02-0.1; the window's last round's
# table reads 2e-3-8e-3 sound, 0.046-0.069 under the control
SMALL_LIMITS = {"loss_gap": {"limit": 3e-4},
                "replay_loss_gap": {"limit": 1e-3},
                "grad_gap": {"limit": 0.2}, "update_gap": {"limit": 0.1},
                "dev_lb_gap": {"limit": 3e-3}}
# each small cell reports the metrics of the full-size cell it stands for
TWINS = {"small_fhvae.k2": "fhvae.timit.k8",
         "small_simple.k2": "simple_fhvae.timit.k8",
         "small_fhvae.rounds": "fhvae.libri.rounds",
         "small_fhvae.stream": "fhvae.libri.stream"}
CELLS = {"small_fhvae.k2": ("small_fhvae", "small_k2"),
         "small_simple.k2": ("small_simple", "small_k2"),
         "small_fhvae.rounds": ("small_fhvae_b16", "small_rounds"),
         "small_fhvae.stream": ("small_fhvae_b16", "small_stream")}


def write_small(root: Path) -> None:
    """Add the small configurations, mixes, limits and cells to the copy
    at ``root``."""
    bench_dir = root / "benchmarks"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, model, batch in (("small_fhvae", "fhvae", 32),
                               ("small_simple", "simple_fhvae", 32),
                               ("small_fhvae_b16", "fhvae", 16)):
        path = bench_dir / "configs" / f"{name}.json"
        path.write_text(json.dumps(small_config(model, batch)))
        bench["configs"].append({
            "name": name, "source": "https://arxiv.org/abs/1804.03201",
            "file": f"benchmarks/configs/{name}.json", "reduced": [],
            "why": "small widths for the CPU tests"})
    for name, rounds in (("small_k2", False), ("small_rounds", True)):
        (bench_dir / "traffic" / f"{name}.json").write_text(
            json.dumps(small_traffic(rounds)))
    (bench_dir / "traffic" / "small_stream.json").write_text(
        json.dumps(small_stream_traffic()))
    for cell, (config, traffic) in CELLS.items():
        limits = dict(SMALL_LIMITS)
        if config == "small_simple":
            # as the full-size MLP cell: the first step's loss alone (0 on
            # the CPU, where both sides run the same products; the control
            # reads 3e-5-8e-4 there)
            del limits["loss_gap"]
            limits["first_loss_gap"] = {"limit": 1e-5}
        if traffic == "small_rounds":
            limits["table_gap"] = {"limit": 0.05}
            limits["window_draw_gap"] = {"limit": 0.0}
            limits["window_table_gap"] = {"limit": 0.02}
        if traffic == "small_stream":
            # sound runs read the switch's loss 2e-6-1.3e-4, the control
            # 1e-3, the first batch after the switch gathered from the
            # chunk before's rows 0.035-0.04; where the first chunk's short
            # last batch (a few rows) falls among the first steps, sound
            # replays read up to 5e-3 (half of each batch: 0.06-0.2)
            limits["switch_loss_gap"] = {"limit": 1e-3}
            limits["replay_loss_gap"] = {"limit": 0.02}
        (bench_dir / "limits" / f"{cell}.json").write_text(json.dumps(limits))
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a small cell for the CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.get("workloads", []).extend(
            small for small, big in TWINS.items()
            if big in m.get("workloads", []))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def small_copy(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and the benchmark's folder at ``dest``
    with the small cells added."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, dest / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    write_small(dest)
    return dest


def run_small(root: Path, cell: str, capsys, *extra) -> dict:
    """One CPU run of a small cell through ``run.py``'s ``main``; its last
    line of output, parsed."""
    import run as run_py

    rc = run_py.main(["--workload", cell, "--seed", str(2**31 + 7),
                      "--seconds", "1", *extra], device="cpu", root=root)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
