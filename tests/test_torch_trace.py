"""The training loop's spans and counters (``train/trace.py``,
``sfhvae train --trace-spans``), on the CPU.

The recorder alone: off, every site returns one shared null context and
records nothing (no span object, no profiler range, no clock read); on,
spans nest with their parents' ids, self time is a span's duration less
its children's, counters add up, ``take`` clears, and a span opened on
another thread names its parent. Then the loop: a hierarchical run of
round-staged rounds at K = 2 over two epochs (36 synthetic utterances of 6
speakers, K = 6 sequences a round, tiny widths, the plain kernel versions)
with the flag on and off. On, each epoch's ``metrics.jsonl`` record holds
the sums of every span the CPU path reaches and the counters (each round
gathered from the held host store: ``stage_gathers`` 1 an epoch,
``stage_fallbacks`` 0), and the printed ``Round at epoch`` stage seconds
are the timed stage spans'; on and off give the same losses and final
weights bit for bit; off, the records have no ``spans`` and the sites make
only the turnover's timed spans.
"""

import contextlib
import io
import itertools
import json
import re
import threading
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train import step, trace
from pytorch_scalablefhvae_tpu_torch.train.graphs import launch_span
from pytorch_scalablefhvae_tpu_torch.train.orbax_backend import (
    save_checkpoint_orbax,
    state_tensors,
    wait_for_saves,
)

RUN = "synthetic_np_fbank"
WIDTHS = ["--z1-hus", "16", "16", "--z2-hus", "16", "16", "--x-hus", "16",
          "16", "--z1-dim", "4", "--z2-dim", "4"]
# every span and counter a round-staged hierarchical run at K = 2 reaches
# on the CPU (no CUDA graph: the bundle runs its steps eagerly)
CPU_SPANS = {"epoch", "turnover", "turnover.draw", "turnover.loader",
             "turnover.materialise", "turnover.stage", "turnover.planner",
             "turnover.map_init", "steps", "steps.plan", "dispatch.load",
             "dispatch.launch[replay=false]", "loss_read", "dev_pass",
             "dev_pass.map", "dev_pass.score", "dev_pass.fetch", "save",
             "save.to_host", "save.write"}
CPU_COUNTERS = {"dispatches", "eager_steps", "ckpt_bytes", "staged_bytes",
                "stage_gathers", "stage_fallbacks"}
TIMED = {"turnover.draw", "turnover.loader", "turnover.materialise",
         "turnover.stage", "turnover.map_init"}
ROUND = re.compile(r"Round at epoch (\d+) \([^)]*\): (.*)")


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with recording off and nothing kept."""
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()
    trace.set_epoch(None)


def test_off_sites_return_the_shared_null_and_record_nothing(monkeypatch):
    def forbidden(*args, **kw):
        raise AssertionError("a site while off reached the clock or the "
                             "profiler")

    made = []

    class Counted(trace.Span):
        __slots__ = ()

        def __init__(self, *args):
            made.append(args[0])
            super().__init__(*args)

    monkeypatch.setattr(trace.torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(trace.time, "perf_counter_ns", forbidden)
    monkeypatch.setattr(trace, "Span", Counted)

    def sites(n):
        for _ in itertools.repeat(None, n):
            with trace.span("dispatch.load") as s:
                assert s is trace.NULL
            with launch_span(True, 8) as s:
                assert s is trace.NULL
            with trace.span("save.write", parent=None) as s:
                assert s is trace.NULL
            trace.count("ckpt_bytes", 5)
            assert trace.current() is None

    sites(10)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        sites(10_000)
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after == before
    assert made == []
    assert trace.take() == ([], {})


def test_a_timed_span_reads_the_clock_while_off():
    with trace.span("turnover.draw", timed=True) as s:
        pass
    assert isinstance(s, trace.Span) and not s.kept
    assert s.seconds == (s.t1 - s.t0) / 1e9 >= 0
    assert trace.take() == ([], {})


def test_nesting_self_time_counters_and_take():
    trace.set_epoch(3)
    with torch.profiler.profile() as prof, trace.recording():
        with trace.span("outer") as outer:
            assert trace.current() is outer
            with trace.span("inner", {"replay": True}):
                sum(range(10_000))
            with trace.span("inner", {"replay": True}):
                sum(range(10_000))
            with trace.span("other"):
                trace.count("a")
                trace.count("a", 4)
        trace.count("b", 2)
    assert not trace.ON
    records, counters = trace.take()
    assert counters == {"a": 5, "b": 2}
    assert trace.take() == ([], {})
    by = {}
    for r in records:
        by.setdefault(r.name, []).append(r)
    (o,) = by["outer"]
    assert o.parent is None and o.epoch == 3
    kids = by["inner"] + by["other"]
    assert all(r.parent == o.id and r.epoch == 3 for r in kids)
    assert by["inner"][0].attrs == {"replay": True}
    got = trace.summary(records)
    assert set(got) == {"outer", "inner[replay=true]", "other"}
    n, total, own = got["inner[replay=true]"]
    assert n == 2 and total == own == sum(r.t1 - r.t0
                                          for r in by["inner"]) / 1e9
    n, total, own = got["outer"]
    assert n == 1 and total == (o.t1 - o.t0) / 1e9
    assert own == pytest.approx(
        (o.t1 - o.t0 - sum(r.t1 - r.t0 for r in kids)) / 1e9, abs=1e-12)
    # each span is a profiler range on the profiler's clock
    names = {e.name for e in prof.events()}
    assert {"sfhvae.outer", "sfhvae.inner", "sfhvae.other"} <= names


def test_a_span_on_another_thread_names_its_parent():
    trace.set_epoch(5)
    with trace.recording():
        with trace.span("save") as save:
            parent = trace.current()
            trace.set_epoch(6)  # the next epoch starts before the write

            def write():
                assert trace.current() is None  # nothing open there
                with trace.span("save.write", parent=parent):
                    with trace.span("save.part"):
                        pass

            thread = threading.Thread(target=write)
            thread.start()
            thread.join()
            assert trace.current() is save
    records, _ = trace.take()
    by = {r.name: r for r in records}
    assert by["save.write"].parent == by["save"].id
    assert by["save.part"].parent == by["save.write"].id
    assert by["save"].epoch == by["save.write"].epoch == \
        by["save.part"].epoch == 5


def test_an_orbax_save_writes_under_its_save_on_the_writer_thread(tmp_path):
    state = step.create_train_state(FHVAE(40, z1_hus=(8, 8), z2_hus=(8, 8),
                                          x_hus=(8, 8), z1_dim=3, z2_dim=2,
                                          feat_dim=8, num_seqs=5), seed=1)
    with trace.recording():
        with trace.span("save"):
            save_checkpoint_orbax(tmp_path, state, model_type="fhvae",
                                  run_info="run", epoch=0, meta={})
        wait_for_saves()
    records, counters = trace.take()
    by = {r.name: r for r in records}
    assert by["save.to_host"].parent == by["save"].id
    assert by["save.write"].parent == by["save"].id
    assert counters["ckpt_bytes"] == sum(
        t.numel() * t.element_size() for t in state_tensors(state).values())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    assert main(["preprocess", "--dataset", "synthetic", "--data-root",
                 str(root), "--synthetic-speakers", "6", "--synthetic-utts",
                 "8"]) == 0
    frames = sum(int(n) for n in
                 (root / RUN / "train" / "len.scp").read_text().split()[1::2])
    return root, frames * 80 * 4


def hier_args(corpus, exp_root, *extra):
    root, pack_bytes = corpus
    return ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(root), "--mvn-path", str(root / "mvn.json"),
            "--training-batch-size", "8", "--dev-batch-size", "64",
            "--exp-root", str(exp_root), "--device", "cpu", "--epochs", "2",
            "--hierarchical", "--num-hierarchical-sequences", "6",
            "--steps-per-dispatch", "2", "--epoch-plan", "device",
            "--device-store-max-bytes", str(pack_bytes - 1), *WIDTHS, *extra]


def run_dir(exp_root) -> Path:
    return Path(exp_root) / RUN / "fhvae_e2_p10_a10.0"


def records(d: Path) -> list:
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def traced(corpus, tmp_path_factory):
    root = tmp_path_factory.mktemp("traced")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(hier_args(corpus, root, "--trace-spans")) == 0
    assert not trace.ON
    return run_dir(root), buf.getvalue()


def test_records_hold_every_span_and_counter(traced):
    exp, _ = traced
    recs = records(exp)
    assert [r["epoch"] for r in recs] == [0, 1]
    for r in recs:
        assert set(r["spans"]) >= CPU_SPANS, CPU_SPANS - set(r["spans"])
        assert set(r["counters"]) >= CPU_COUNTERS
        for n, total, own in r["spans"].values():
            assert n >= 1 and 0 <= own <= total + 1e-9
        assert r["spans"]["epoch"][0] == 1
        # every step of the epoch ran eagerly: the bundle's on the CPU
        assert r["counters"]["eager_steps"] == r["train_steps"]
        assert r["spans"]["dispatch.launch[replay=false]"][0] == \
            r["counters"]["dispatches"]
        # the bytes handed to the writer are the checkpoint's arrays'
        with np.load(exp / f"fhvae_{RUN}_e{r['epoch']}.npz") as z:
            assert r["counters"]["ckpt_bytes"] == sum(z[k].nbytes
                                                      for k in z.files)
        assert r["counters"]["staged_bytes"] > 0
        # each epoch's round gathered from the held host store
        assert r["counters"]["stage_gathers"] == 1
        assert r["counters"]["stage_fallbacks"] == 0
    assert "save.best_copy" in recs[0]["spans"]


def test_printed_turnover_seconds_are_the_stage_spans(traced):
    exp, out = traced
    lines = [ROUND.match(line) for line in out.splitlines()
             if line.startswith("Round at epoch")]
    assert [int(m.group(1)) for m in lines] == [0, 1]
    for m, r in zip(lines, records(exp)):
        printed = {s.split()[0]: float(s.split()[1])
                   for s in m.group(2).split(", ")}
        assert list(printed) == ["draw", "materialise", "stage", "map_init"]
        spans = {k: v[1] for k, v in r["spans"].items()}
        want = {"draw": spans["turnover.draw"] + spans["turnover.loader"],
                "materialise": spans["turnover.materialise"],
                "stage": spans["turnover.stage"],
                "map_init": spans["turnover.map_init"]}
        for name, seconds in printed.items():
            assert abs(seconds - want[name]) <= 5e-4 + 1e-9, name


def test_off_run_equals_the_traced_run_and_writes_no_spans(
        corpus, traced, tmp_path, monkeypatch, capsys):
    forbid = []
    made = []

    class Counted(trace.Span):
        __slots__ = ()

        def __init__(self, name, attrs, parent, kept):
            made.append((name, kept))
            super().__init__(name, attrs, parent, kept)

    def record_function(*args, **kw):
        forbid.append(args)
        raise AssertionError("a profiler range while off")

    monkeypatch.setattr(trace, "Span", Counted)
    monkeypatch.setattr(trace.torch.profiler, "record_function",
                        record_function)
    assert main(hier_args(corpus, tmp_path)) == 0
    capsys.readouterr()
    assert not forbid
    # off, the only span objects are the turnover's timed stages, two
    # turnovers of five
    assert sorted(made) == sorted((n, False) for n in TIMED for _ in "ab")
    exp, got = traced[0], run_dir(tmp_path)
    on, off = records(exp), records(got)
    timing = {"spans", "counters", "train_seconds", "train_segments_per_sec"}
    for a, b in zip(on, off):
        assert "spans" not in b and "counters" not in b
        assert {k: v for k, v in a.items() if k not in timing} == \
            {k: v for k, v in b.items() if k not in timing}
    with np.load(exp / f"fhvae_{RUN}_e1.npz") as a, \
            np.load(got / f"fhvae_{RUN}_e1.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ckpt.read_checkpoint_meta(exp / f"fhvae_{RUN}_e1.npz")[
        "values"] == ckpt.read_checkpoint_meta(
            got / f"fhvae_{RUN}_e1.npz")["values"]
