"""The traced run's profiled cycle: one whole epoch of the window (its
turnover, steps, dev pass and checkpoint) under ``torch.profiler``, reduced
to the device's busy time, its idle gaps by what the host was doing, the
kernels' device times and counts, and each kernel group's roofline bound.

The profiled cycle starts at the start of the window's second epoch and
ends at the start of the next (or at the window's end). The profiler must
see as many launches of each checked kernel as the launch counters of the
program's kernel wrappers advanced over the cycle (a replayed CUDA graph
advances them by its captured launches at each replay); where it does not,
the cycle is dropped and the next one profiled, up to ``TRIES`` cycles, and
the readings that need the trace are left out if none agrees.
"""

from __future__ import annotations

import bisect
import importlib
import re
import time
from pathlib import Path

import torch

from fhbench.hooks import LaunchLog

TRIES = 3
SHORT_GAP_US = 20.0  # idle gaps shorter than this are summed unlabelled
GRAPHS = "pytorch_scalablefhvae_tpu_torch.train.graphs"
ROOFLINE_DIR = Path(__file__).resolve().parents[1] / "roofline"


def kernel_base(name: str) -> str:
    """A kernel's function name without its namespace, template arguments
    and parameters (``void ns::k<128>(float*)`` -> ``k``)."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"<.*", "", s.split("(")[0]).strip()
    return s.split("::")[-1].split()[-1] if s else name


def roofline_modules() -> dict:
    """``{group: module}`` of every kernel group under ``roofline/`` (a
    module that names ``KERNELS``)."""
    out = {}
    for path in sorted(ROOFLINE_DIR.glob("*.py")):
        module = importlib.import_module(f"roofline.{path.stem}")
        if hasattr(module, "KERNELS"):
            out[path.stem] = module
    return out


def launch_counts() -> dict:
    """``{entry name: launches}`` of the program's kernel wrappers."""
    graphs = importlib.import_module(GRAPHS)
    return {e.__name__: n for (e, c), n in graphs.launch_counts().items()
            if c == "launches"}


def union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Probe:
    """Profiles epoch cycles of the window from its ``first`` epoch on;
    :meth:`arm` at the window's start, :meth:`finish` at its end, then
    ``result`` holds the cycle's reduction (or ``None``)."""

    def __init__(self, recorder, device: torch.device, first: int = 1,
                 tries: int = TRIES):
        """``profiled``: the indices of the window's epochs it profiled,
        which a traced run's host-clock readings leave out."""
        self.recorder, self.first, self.tries = recorder, first, tries
        self.device = device
        self.groups = roofline_modules()
        self.logs = {g: LaunchLog(recorder, m)
                     for g, m in self.groups.items() if m.LAUNCHERS}
        self.result, self.attempts = None, []
        self.armed, self.epoch, self.prof = False, -1, None
        self.profiled: list = []  # the window's epochs under the profiler

    def arm(self) -> None:
        self.armed, self.epoch = True, -1
        self.recorder.on_epoch = self._on_epoch

    def _on_epoch(self) -> None:
        if not self.armed:
            return
        self.epoch += 1
        if self.prof is not None:
            self._stop()
        if self.armed and self.epoch >= self.first:
            self._start()
            self.profiled.append(self.epoch)

    def finish(self) -> None:
        if self.prof is not None:
            self._stop()
        self.armed = False
        self.recorder.on_epoch = None

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        for log in self.logs.values():
            log.eager, log.open = [], True
        self.before = launch_counts()
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.cycle = torch.profiler.record_function("bench.cycle")
        self.cycle.__enter__()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stop(self) -> None:
        self._sync()
        self.cycle.__exit__(None, None, None)
        self.prof.stop()
        after = launch_counts()
        for log in self.logs.values():
            log.open = False
        delta = {n: after[n] - self.before.get(n, 0) for n in after}
        t0 = time.perf_counter()
        reading = reduce(self.prof.events(), delta, self.groups, self.logs)
        reading["reduce_s"] = time.perf_counter() - t0
        self.prof = None
        self.attempts.append(reading["missed"])
        if not reading["missed"] or len(self.attempts) >= self.tries:
            self.result = reading
            self.armed = False


def reduce(events, delta: dict, groups: dict, logs: dict) -> dict:
    """The cycle's readings from the profiler's events (times in us)."""
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    # the device's own operations, not the benchmark's spans that the
    # profiler mirrors onto the device's timeline
    dev = [e for e in events
           if e.device_type != torch.autograd.DeviceType.CPU
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("bench.")]
    cycle = next(e for e in cpu if e.name == "bench.cycle")
    c0, c1 = cycle.time_range.start, cycle.time_range.end
    busy_iv, by_name, counts = [], {}, {}
    for e in dev:
        a, b = max(e.time_range.start, c0), min(e.time_range.end, c1)
        if b <= a:
            continue
        busy_iv.append((a, b))
        base = (e.name.split(" (")[0] if e.name.startswith(("Memcpy",
                                                            "Memset"))
                else kernel_base(e.name))
        by_name[base] = by_name.get(base, 0.0) + (b - a)
        counts[base] = counts.get(base, 0) + 1
    busy = union(busy_iv)
    busy_us = sum(b - a for a, b in busy)
    missed = []
    for g in groups.values():
        for kernel, entries in getattr(g, "CHECKED", {}).items():
            want = sum(delta.get(n, 0) for n in entries)
            if counts.get(kernel, 0) != want:
                missed.append([kernel, counts.get(kernel, 0), want])
    rooflines = {}
    for name, g in groups.items():
        device_us = sum(t for k, t in by_name.items() if k in g.KERNELS)
        bound_s = bound_seconds(logs.get(name), delta, g)
        if device_us > 0 and bound_s is not None:
            rooflines[name] = 100.0 * bound_s / (device_us * 1e-6)
    return {"window_s": (c1 - c0) * 1e-6, "busy_s": busy_us * 1e-6,
            "device_ops": sorted(([k, t * 1e-6] for k, t in by_name.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": idle_gaps(busy, c0, c1, cpu),
            "kernel_counts": counts, "missed": missed,
            "rooflines": rooflines}


def bound_seconds(log, delta: dict, group) -> float | None:
    """The least time the card could take for the group's launches in the
    cycle: the eager launches the log saw, plus each replay of the last
    captured graph (its launches are the counters' advance beyond the eager
    ones); ``None`` where the two do not square."""
    if log is None:
        return None
    peaks = group.PEAKS
    per_entry: dict = {}
    for c in log.captured:
        per_entry.setdefault(c["entry"], []).append(c)
    eager_n: dict = {}
    for c in log.eager:
        eager_n[c["entry"]] = eager_n.get(c["entry"], 0) + 1
    replays = set()
    for entry in set(per_entry) | set(eager_n) | {
            n for n in group.ENTRIES if delta.get(n)}:
        extra = delta.get(entry, 0) - eager_n.get(entry, 0)
        captured = len(per_entry.get(entry, []))
        if extra < 0 or (extra and not captured) or (
                captured and extra % captured):
            return None
        if captured:
            replays.add(extra // captured)
    if len(replays) > 1:
        return None
    n_rep = replays.pop() if replays else 0

    def seconds(c):
        return max(c["ops"] / peaks[c["peak"]], c["bytes"] / peaks["hbm"])

    return (sum(seconds(c) for c in log.eager)
            + n_rep * sum(seconds(c) for c in log.captured))


def idle_gaps(busy: list, c0: float, c1: float, cpu: list) -> list:
    """The cycle's idle time by what the host was doing: each gap of at
    least ``SHORT_GAP_US`` labelled ``<span>/<op>`` (the benchmark's span
    and the outermost operator running at the gap's middle), the shorter
    ones summed as ``short gaps``; the ten largest sums, in seconds."""
    gaps, at = [], c0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if c1 > at:
        gaps.append((at, c1))
    spans = [e for e in cpu if e.name.startswith("bench.")
             and e.name != "bench.cycle"]
    ops = sorted((e for e in cpu if not e.name.startswith("bench.")),
                 key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in ops]
    sums: dict = {}
    for a, b in gaps:
        if b - a < SHORT_GAP_US:
            label = "short gaps"
        else:
            mid = 0.5 * (a + b)
            inside = [e for e in spans
                      if e.time_range.start <= mid <= e.time_range.end]
            span = (min(inside, key=lambda e: e.time_range.elapsed_us())
                    .name[len("bench."):] if inside else "loop")
            op, i = "python", bisect.bisect_right(starts, mid)
            for e in ops[max(0, i - 2000):i]:
                if e.time_range.end >= mid and (
                        op == "python" or e.time_range.elapsed_us() > best):
                    op, best = e.name, e.time_range.elapsed_us()
            label = f"{span}/{op}"
        sums[label] = sums.get(label, 0.0) + (b - a) * 1e-6
    return sorted(([k, v] for k, v in sums.items()),
                  key=lambda kv: -kv[1])[:10]
