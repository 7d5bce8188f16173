"""Spans and counters of the training loop, on ``time.perf_counter_ns`` and,
under a running ``torch.profiler``, on the profiler's clock.

A span (:func:`span`) names a stretch of the loop's work at a layer
boundary: the epoch, a round's turnover and its stages, the steps, each
dispatch's input load and launch, the loss reads, the dev pass and the save
with their parts. A counter (:func:`count`) adds up events: dispatches,
graph replays, eager steps, captures, bytes handed to the checkpoint
writers and bytes a turnover restages.

Recording is off by default. ``sfhvae train --trace-spans`` turns it on for
the run, and the ``--profile-dir`` epoch for that epoch (:func:`recording`).
While off, a span site costs one test of a module flag and returns one
shared null context (no clock read, no allocation), and a counter returns
at once. While on, each span is kept as a :class:`Record` when it closes
and, under a running profiler, opens
``torch.profiler.record_function("sfhvae.<name>")``, so that the profiler
shows it as an event beside the kernels and copies it issued. ``span(..., timed=True)`` reads
the clock on or off and exposes ``.seconds``: the turnover's stages, whose
seconds the loop prints, come from the same clock as their spans.

Spans nest per thread. A span opened on another thread names its parent
(``parent=``): the orbax backend's write names the ``save`` that submitted
it (:func:`current`). Every record carries its parent's epoch, or, for a
span without one, the epoch set by :func:`set_epoch`: the identifier its
epoch's spans share. :func:`take` returns the records and
counters since its last call and clears them; :func:`summary` folds
records into ``{key: [count, total_s, self_s]}``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from typing import NamedTuple

import torch

ON = False  # the one flag every span site tests
_lock = threading.Lock()
_records: list = []
_counters: dict = {}
_local = threading.local()
_ids = itertools.count(1)
_epoch = None


class Record(NamedTuple):
    """A closed span: its id, its parent's (or ``None``), its name, its
    start and end (``perf_counter_ns``), its epoch and its attributes."""

    id: int
    parent: int | None
    name: str
    t0: int
    t1: int
    epoch: int | None
    attrs: dict | None


class _Null:
    """The context of every span site while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """An open span; ``kept``: recorded, with its profiler range, when it
    closes (else only timed). ``seconds`` once it has closed."""

    __slots__ = ("name", "attrs", "parent", "epoch", "id", "kept", "t0",
                 "t1", "_range")

    def __init__(self, name: str, attrs: dict | None, parent, kept: bool):
        self.name, self.attrs, self.kept = name, attrs, kept
        self.parent = None if parent is None else parent.id
        self.epoch = _epoch if parent is None else parent.epoch
        self.id = next(_ids) if kept else None

    def __enter__(self):
        if self.kept:
            stack = _stack()
            if self.parent is None and stack:
                self.parent, self.epoch = stack[-1].id, stack[-1].epoch
            stack.append(self)
            # a range only where a profiler runs to record it: a range with
            # no observer costs some 12 us a span and shows nowhere
            self._range = None
            if torch._C._autograd._profiler_enabled():
                self._range = torch.profiler.record_function(
                    f"sfhvae.{self.name}")
                self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.kept:
            if self._range is not None:
                self._range.__exit__(*exc)
            _stack().remove(self)
            rec = Record(self.id, self.parent, self.name, self.t0, self.t1,
                         self.epoch, self.attrs)
            with _lock:
                _records.append(rec)
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


def span(name: str, attrs: dict | None = None, parent: Span | None = None,
         timed: bool = False):
    """The span ``name`` (``attrs``: its attributes, e.g. ``{"replay":
    True}``; ``parent``: an open span of another thread), to be used as a
    context: while recording is off :data:`NULL`, or with ``timed`` a span
    that reads the clock and records nothing."""
    if ON:
        return Span(name, attrs, parent, True)
    if timed:
        return Span(name, attrs, None, False)
    return NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if ON:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def current() -> Span | None:
    """This thread's innermost open span, while recording is on."""
    stack = _stack() if ON else None
    return stack[-1] if stack else None


def set_epoch(epoch: int | None) -> None:
    """The epoch the spans opened from now on belong to."""
    global _epoch
    _epoch = epoch


def enable() -> None:
    global ON
    ON = True


def disable() -> None:
    global ON
    ON = False


@contextlib.contextmanager
def recording(on: bool = True):
    """Recording on inside the block where ``on`` (else as it was), then
    as it was before."""
    before = ON
    if on:
        enable()
    try:
        yield
    finally:
        if not before:
            disable()


def take() -> tuple[list, dict]:
    """The records and counters since the last call; clears them."""
    with _lock:
        records, counters = list(_records), dict(_counters)
        _records.clear()
        _counters.clear()
    return records, counters


def key(rec: Record) -> str:
    """A record's name, with its attributes where it has any:
    ``dispatch.launch[replay=true]``."""
    if not rec.attrs:
        return rec.name
    return rec.name + "[" + ",".join(f"{k}={json.dumps(v)}" for k, v in
                                     sorted(rec.attrs.items())) + "]"


def summary(records: list) -> dict:
    """``{key: [count, total_s, self_s]}`` of ``records`` (:func:`key`),
    self time being each span's duration less the part of it that its
    children among ``records`` cover."""
    children: dict = {}
    for r in records:
        if r.parent is not None:
            children.setdefault(r.parent, []).append((r.t0, r.t1))
    out: dict = {}
    for r in records:
        covered, at = 0, r.t0
        for a, b in sorted(children.get(r.id, ())):
            a, b = max(a, at), min(b, r.t1)
            if b > a:
                covered += b - a
                at = b
        n, total, own = out.get(key(r), (0, 0, 0))
        out[key(r)] = (n + 1, total + r.t1 - r.t0,
                       own + r.t1 - r.t0 - covered)
    return {k: [n, total / 1e9, own / 1e9]
            for k, (n, total, own) in out.items()}
