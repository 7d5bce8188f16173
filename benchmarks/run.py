"""The benchmark of the PyTorch/CUDA port of ScalableFHVAE: one run of one
cell on the card this machine holds.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``
(the check against the plain reference), ``attempted`` and ``failed``
(the window's train steps, and those lost to a diverged loss), ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its per-layer
metrics, from a run whose window has one epoch cycle under torch.profiler),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared, with its limit. The same numbers end standard error.
Without the CUDA devices the cell asks for, it exits 2 and prints no
result.

``--readings N`` reads, for the limits, on N seeds, the program's numbers
after a whole run and those of the cell's control (the plain reference one
precision below the configuration's, in the program's place) and of faults
planted in the reference (no result line; one JSON line a seed).
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# the program's own kernels build under build/ in the checkout; any other
# compiler cache a library keeps goes there too, at a fixed path
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / "build" / "bench_cache" / sub))
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]


def written_bytes() -> int | None:
    """Bytes this process has caused to be written to storage so far."""
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("write_bytes:"):
                return int(line.split()[1])
    except OSError:
        return None
    return None


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--readings", type=int, default=0, metavar="N",
                   help="for the limits: the program's, the control's and "
                        "planted faults' numbers on N seeds from --seed on, "
                        "in one process, one JSON line a seed")
    return p.parse_args(argv)


def result_line(cell, run, readings, correct: bool, rows: list,
                traced: bool, bench_dir: Path) -> dict:
    from fhbench import device as devinfo
    from fhbench import spec

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"], bench_dir)(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = devinfo.describe(run.device, cell.workload["chips"])
    dev["memory_peak_bytes"] = run.peak
    out = {"correct": correct, "attempted": readings.attempted,
           "failed": readings.attempted if run.diverged else 0,
           "metrics": metrics, "device": dev}
    cycle = readings.cycle
    if traced and cycle is not None:
        dev["busy_s"], dev["window_s"] = cycle["busy_s"], cycle["window_s"]
        out["breakdown"] = {"device_ops": cycle["device_ops"],
                            "idle_gaps": cycle["idle_gaps"]}
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in rows}
    return out


def run_class(cell):
    """The ``Run`` of the module ``fhbench/<kind>.py`` that the cell's
    traffic names (``"kind": "train"``: ``fhbench/train.py``)."""
    import importlib

    return importlib.import_module(f"fhbench.{cell.traffic['kind']}").Run


def read_seeds(Run, cell, args, device: str) -> int:
    """``--readings N``: on each of N seeds from ``--seed`` on, a whole run
    (set-up, the window, the program's numbers), then the numbers of the
    control (the reference at the configuration's next lower precision in
    the program's place) and of the reference in its place with a fault
    planted (half of each batch left out of the loss; the dev lower bound
    over half of the dev split; in rounds, the window's last table left as
    the round before trained it; on the streamed tier, the first batch
    after a chunk switch gathered from the chunk before's rows), one JSON
    line a seed; no result line."""
    from fhbench.check import judge

    for seed in range(args.seed, args.seed + args.readings):
        with tempfile.TemporaryDirectory(prefix="fhbench-") as tmp:
            run = Run(cell, seed, args.seconds, False, device, Path(tmp))
            try:
                run.setup()
                run.window()
                read = {"program": run.numbers(),
                        "control": run.control_numbers(
                            cell.config["control"]),
                        "half_batch": run.control_numbers(None,
                                                          half_batch=True)}
                if run.dev_compared:
                    read["dev_half"] = run.control_numbers(None,
                                                           dev_half=True)
                if run.hier:
                    read["stale_table"] = run.window_numbers(stale=True)
                if hasattr(run, "switch_numbers"):
                    read["stale_chunk"] = run.switch_numbers(stale=True)
            finally:
                run.close()
        print(json.dumps({"cell": cell.name, "seed": seed, **read,
                          "correct": {k: judge(v, cell.limits)[0]
                                      for k, v in read.items()}}),
              flush=True)
    return 0


def main(argv=None, device: str = "cuda", root: Path = ROOT) -> int:
    """One run; ``device`` and ``root`` (the checkout whose
    ``BENCHMARK.json`` and data files name the cell) are for the CPU
    tests, which run a small cell through the same path."""
    args = parse(argv)
    from fhbench import check, spec
    from fhbench import device as devinfo

    bench_dir = root / "benchmarks"
    bench = spec.load(root)
    cell = spec.cell(bench, args.workload, root, bench_dir)
    if device == "cuda":
        try:
            devinfo.require_cards(cell.workload["chips"])
        except devinfo.NoDevice as e:
            print(f"run.py: {e}", file=sys.stderr)
            return 2
    Run = run_class(cell)
    if args.readings:
        return read_seeds(Run, cell, args, device)
    with tempfile.TemporaryDirectory(prefix="fhbench-") as tmp:
        run = Run(cell, args.seed, args.seconds, bool(args.trace), device,
                  Path(tmp))
        try:
            run.setup()
            probe = None
            if args.trace:
                from fhbench.trace import Probe

                probe = Probe(run.recorder, run.device)
            setup_s = time.perf_counter() - START
            readings = run.window(probe)
            readings.setup_s = setup_s
            found = devinfo.forbidden_modules()
            if found:
                print(f"run.py: the run loaded {found}", file=sys.stderr)
                return 3
            values = run.numbers()
            correct, rows = check.judge(values, cell.limits)
            correct = correct and not run.diverged
        finally:
            run.close()
    line = result_line(cell, run, readings, correct, rows, bool(args.trace),
                       bench_dir)
    if readings.cycle is not None:
        print(f"profiled cycle: reduced in {readings.cycle['reduce_s']:.1f} "
              f"s; launch check {readings.cycle['missed'] or 'agreed'}",
              file=sys.stderr)
    print(f"window: {run.epochs} epochs planned from a {run.t_epoch:.3f} s "
          f"warm epoch; epoch cycles (s) "
          f"{[round(c, 3) for c in run.cycles]}, their steps (s) "
          f"{[round(r['train_seconds'], 3) for r in run.records]}, spans "
          f"{json.dumps(run.window_spans)}", file=sys.stderr)
    print(f"numbers {json.dumps(values)}; this process wrote "
          f"{written_bytes()} bytes", file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
