"""Spans and counters the benchmark records around the program's calls.

The program is not edited: the benchmark swaps a few names of the training
loop's module for wrappers that call the original and note the time (the
counterpart of spans at the loop's layer boundaries), and, in a traced run,
the kernel launchers for wrappers that note each launch's shapes. Every
swap is undone by :meth:`Recorder.close`.

- ``EpochCursor``: each epoch's cursor, whose losses are the steps' losses
  as the loop reads them back; its construction starts an epoch (and, for
  hierarchical runs, ``Rounds.loader_for`` does, which turns a round over
  before the cursor exists);
- ``device_dev_pass`` / ``dev_pass``, ``save_state``, ``Rounds.loader_for``
  and the epoch runners: host spans ``dev_pass``, ``save_state``,
  ``turnover`` and ``steps`` (with ``torch.profiler.record_function`` in a
  traced run, so the trace names them too), and ``StepBundle.capture``:
  ``capture``, each call's capture of its K-step CUDA graph;
- ``Rounds.map_init``: the last fresh round's record (``round``): its
  epoch, its drawn keys in the program's order, and device copies of the
  weights it was MAP-initialised from (the last round's table among them)
  and of the table it made;
- ``run_stream_epoch``: the streamed tier's source (``stream_source``),
  and, once each epoch's steps have returned (the runner has synchronised
  the device), the source's ``switch_waits()``, a list an epoch in
  ``switches``: each chunk switch's host wait for the filler thread and
  the device's wait for the slot's copy.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import time

import torch

LOOP = "pytorch_scalablefhvae_tpu_torch.train.loop"
ROUNDS = "pytorch_scalablefhvae_tpu_torch.train.rounds"
GRAPHS = "pytorch_scalablefhvae_tpu_torch.train.graphs"
SPANS = {"device_dev_pass": "dev_pass", "dev_pass": "dev_pass",
         "save_state": "save_state", "run_device_epoch": "steps",
         "run_stream_epoch": "steps", "run_epoch": "steps"}


class Recorder:
    """Spans ``(name, t0, t1)`` on the host clock, each call's epoch
    cursors, an ``on_epoch`` callback run at the start of every epoch
    (before its steps and, in a hierarchical run, before its turnover),
    the last fresh round's record ``round``, and on the streamed tier its
    source and each epoch's chunk switches."""

    def __init__(self, hierarchical: bool, traced: bool = False):
        self.hierarchical, self.traced = hierarchical, traced
        self.spans: list = []
        self.marks: list = []
        self.cursors: list = []
        self.on_epoch = None
        self.round: dict | None = None
        self.stream_source = None
        self.switches: list = []
        self._epoch = None
        self._undo: list = []
        loop = importlib.import_module(LOOP)
        rounds = importlib.import_module(ROUNDS)
        graphs = importlib.import_module(GRAPHS)
        rec = self
        real_cursor = loop.EpochCursor

        class Cursor(real_cursor):
            def __init__(self, *args, **kw):
                if not rec.hierarchical:
                    rec.epoch_start()
                super().__init__(*args, **kw)
                rec.cursors.append(self)

        self._swap(loop, "EpochCursor", Cursor)
        for name, span in SPANS.items():
            self._swap(loop, name, self._timed(span, getattr(loop, name)))
        self._swap(graphs.StepBundle, "capture",
                   self._timed("capture", graphs.StepBundle.capture))
        timed_stream = loop.run_stream_epoch

        @functools.wraps(timed_stream)
        def run_stream_epoch(state, optimizer, source, *args, **kw):
            rec.stream_source = source
            stats = timed_stream(state, optimizer, source, *args, **kw)
            rec.switches.append(source.switch_waits())
            return stats

        self._swap(loop, "run_stream_epoch", run_stream_epoch)
        real_loader_for = rounds.Rounds.loader_for
        real_map_init = rounds.Rounds.map_init

        @functools.wraps(real_loader_for)
        def loader_for(this, epoch, *args, **kw):
            rec.epoch_start()
            rec._epoch = epoch
            with rec.span("turnover"):
                return real_loader_for(this, epoch, *args, **kw)

        @functools.wraps(real_map_init)
        def map_init(this, state, ds):
            params = {n: p.detach().clone()
                      for n, p in state.params().items()}
            real_map_init(this, state, ds)
            after = state.params()["mu2_table"].detach().clone()
            rec.round = {"epoch": rec._epoch,
                         "keys": list(ds.store.seq_keys),
                         "params": params, "table_after": after}

        self._swap(rounds.Rounds, "loader_for", loader_for)
        self._swap(rounds.Rounds, "map_init", map_init)

    def _swap(self, owner, name: str, value) -> None:
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def wrap(self, owner, name: str, make) -> None:
        """Swap ``owner.name`` for ``make(original)`` until :meth:`close`."""
        self._swap(owner, name, make(getattr(owner, name)))

    def close(self) -> None:
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)
        self._undo.clear()

    @contextlib.contextmanager
    def span(self, name: str):
        label = (torch.profiler.record_function(f"bench.{name}")
                 if self.traced else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with label:
                yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def _timed(self, span: str, fn):
        rec = self

        @functools.wraps(fn)
        def timed(*args, **kw):
            with rec.span(span):
                return fn(*args, **kw)
        return timed

    def epoch_start(self) -> None:
        """An epoch starts: run ``on_epoch`` and note ``(before, after)`` it
        on the host clock in ``marks``."""
        t0 = time.perf_counter()
        if self.on_epoch is not None:
            self.on_epoch()
        self.marks.append((t0, time.perf_counter()))

    def losses(self) -> list:
        """Every step loss the cursors read, in order."""
        return [v for c in self.cursors for v in c.losses.values]


class LaunchLog:
    """Each launch of the kernel launchers a roofline module names
    (``LAUNCHERS``: launcher name -> kind), with its operations, bytes and
    peak from the module's ``cost``: launches issued while a CUDA graph is
    being captured go to ``captured`` (the last capture's), the others, while
    ``open``, to ``eager``. Launch counters stay the program's own: the
    launchers increment them as before."""

    def __init__(self, recorder: Recorder, roofline):
        self.roofline = roofline
        self.captured: list = []
        self.eager: list = []
        self.open = False
        self._capturing = False
        module = importlib.import_module(roofline.MODULE)
        for name, kind in roofline.LAUNCHERS.items():
            recorder.wrap(module, name, functools.partial(self._logged, kind))

    def _logged(self, kind: str, fn):
        sig = inspect.signature(fn)
        log = self

        @functools.wraps(fn)
        def logged(*args, **kw):
            out = fn(*args, **kw)
            bound = sig.bind(*args, **kw).arguments
            cost = log.roofline.cost(kind, bound, out)
            capturing = (torch.cuda.is_available()
                         and torch.cuda.is_current_stream_capturing())
            if capturing and not log._capturing:
                log.captured = []
            log._capturing = capturing
            if capturing:
                log.captured.append(cost)
            elif log.open:
                log.eager.append(cost)
            return out
        return logged
