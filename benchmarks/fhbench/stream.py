"""A training cell on the streamed tier: ``sfhvae train`` over a store past
the device-store budget, which ``--data-placement auto`` streams through the
card in chunks (``data/stream_store.py``: two slots, pinned host buffers
filled by a thread, a copy stream, each chunk's own plan replayed by the
same K-step graph, each chunk's ``n % K`` batches as eager steps).

The run is :mod:`fhbench.train`'s, with these differences:

- a run whose program does not stream the store fails;
- the reference's first batches follow the streamed tier's documented
  schedule (``common.stream_chunks``, ``common.stream_schedule``), across
  a chunk's end where the first chunk is short;
- each window epoch's chunk switches, read from the program's source once
  the epoch's steps have returned (``Recorder.switches``), give
  ``chunk_waits``: the seconds an epoch's switches waited, the host for
  the filler thread and the device for the slot's copy;
- ``switch_loss_gap``: after the window, two calls more from call 2's
  checkpoint (step ``1 + 2 K``): one stopped at the first chunk switch at
  or past it, step ``n``, whose step checkpoint holds the weights that
  the next chunk's first batch meets; and one that runs on to ``n + K`` in
  one process, so that its step ``n + 1`` comes through the double buffer
  (the next chunk filled and copied in behind the steps, the graph
  replayed over the other slot). The number is the relative gap between
  that step's loss and the reference's over the batch its own schedule
  puts there, at the first call's weights.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from fhbench import train
from reference import common
from reference import train as ref_train

ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


class Run(train.Run):
    """One run of a streamed training cell on ``device`` in ``workdir``."""

    def setup_data(self) -> None:
        super().setup_data()
        d = self.config.data
        split = self.reference_split("train")
        # the training loop's documented default: a quarter of the budget
        chunk_bytes = d.stream_chunk_bytes or d.device_store_max_bytes // 4
        self.chunks = common.stream_chunks(
            split.lens, split.nsegs,
            self.cell.config["widths"]["feat_dim"]
            * ITEMSIZE[d.transfer_dtype], chunk_bytes)
        self.schedule = common.stream_schedule(self.chunks, self.seed, 0)
        B = d.training_batch_size
        self.batches = ref_train.stream_batches(self.schedule, B)
        ends = np.cumsum([-(-len(order) // B) for _, order in self.schedule])
        first = 1 + 2 * self.k
        at = int(np.searchsorted(ends, first))
        if at + 1 >= len(ends):
            raise ValueError("the stream cell needs a chunk switch past its "
                             "first steps")
        # the switch: the last batch of schedule[at], then schedule[at + 1]
        self.switch_step, self.switch_at = int(ends[at]), at
        self._switch = self._switch_ref = None

    def setup_program(self) -> None:
        super().setup_program()
        source = self.recorder.stream_source
        if source is None:
            raise RuntimeError(
                f"the program trained {self.cell.name} without streaming "
                f"its store: the cell measures the streamed tier")
        print(f"stream: {len(source.chunks)} chunks of {source.chunk_rows} "
              f"rows, {len(self.chunks)} by the reference; the first switch "
              f"past the first steps after batch {self.switch_step}; dev "
              f"split staged: "
              f"{'Dev split device-resident' in self.log.read_text()}",
              file=sys.stderr)

    def first_batches(self, split: common.Split) -> list:
        return self.batches[:1 + 2 * self.k]

    def window(self, probe=None) -> train.Readings:
        self.recorder.switches = []
        readings = super().window(probe)
        skipped = set() if probe is None else set(probe.profiled)
        readings.chunk_waits = [
            sum(host + (ms or 0.0) * 1e-3 for host, ms in waits)
            for i, waits in enumerate(self.recorder.switches)
            if i not in skipped]
        return readings

    # ------------------------------------------------------------ check

    def switch(self) -> dict:
        """The program's side of the switch: the weights at step ``n`` and
        the loss of step ``n + 1``, from two calls from call 2's checkpoint
        (computed once a run)."""
        if self._switch is not None:
            return self._switch
        n, first = self.switch_step, 1 + 2 * self.k
        weights = self.after
        if n > first:
            self.call("switch_at", 1, n, self.after["path"])
            weights = train.checkpoint(self.workdir / "switch_at",
                                       f"*_e0s{n}.npz")
        self.call("switch", 1, n + self.k, self.after["path"])
        losses = self.recorder.losses()
        if len(losses) != n + self.k - first:
            raise RuntimeError(f"the call through the switch took "
                               f"{len(losses)} steps, not "
                               f"{n + self.k - first}")
        self._switch = {"loss": losses[n - first],
                        "params": {name: weights[name]
                                   for name in self.params0}}
        return self._switch

    def switch_windows(self, stale: bool = False) -> tuple:
        """``(x, seq, nsegs)`` of the first batch after the switch; with
        ``stale`` (a planted fault), its plan gathered from the chunk
        before's rows: the same frame offsets within the chunk, rows past
        that chunk's end zero, as in a slot that was never refilled."""
        split = self.reference_split("train")
        idx = np.asarray(self.batches[self.switch_step], np.int64)
        if not stale:
            return split.windows(idx, self.device)
        old_base, old_rows = self.chunks[self.schedule[self.switch_at][0]][:2]
        new_base = self.chunks[self.schedule[self.switch_at + 1][0]][0]
        seq = split.seq[idx]
        within = (split.offsets[seq] + split.start[idx] - new_base)[:, None] \
            + np.arange(split.seg_len)[None, :]
        rows = np.where(within < old_rows, old_base + within, 0)
        x = np.where((within < old_rows)[..., None], split.frames[rows], 0.0)
        return (torch.from_numpy(x.astype(np.float32)).to(self.device),
                torch.from_numpy(seq).to(self.device),
                torch.from_numpy(split.nsegs[seq].astype(np.float32))
                .to(self.device))

    def switch_loss(self, prec: dict | None = None, half_batch: bool = False,
                    stale: bool = False) -> float:
        """The reference's loss of step ``n + 1`` at the program's weights
        of step ``n``: float32, or at ``prec``, or with a fault planted."""
        params = {name: torch.from_numpy(v).to(self.device)
                  for name, v in self.switch()["params"].items()}
        with torch.no_grad():
            loss = ref_train.step_loss(
                self.model, params, self.switch_windows(stale), self.seed,
                self.switch_step, self.config.optim.alpha_dis, self.device,
                prec, half_batch)
        return float(loss)

    def switch_numbers(self, prec: dict | None = None,
                       half_batch: bool = False, stale: bool = False) -> dict:
        """``switch_loss_gap``: the program's loss of the first step after
        the switch (``prec``, ``half_batch``, ``stale``: the reference with
        that control or fault in its place) against the float32
        reference's."""
        if self._switch_ref is None:
            self._switch_ref = self.switch_loss()
        ref = self._switch_ref
        prog = (self.switch()["loss"]
                if prec is None and not half_batch and not stale
                else self.switch_loss(prec, half_batch, stale))
        return {"switch_loss_gap": abs(prog - ref) / abs(ref)}

    def numbers(self) -> dict:
        return {**super().numbers(), **self.switch_numbers()}

    def control_numbers(self, prec: dict | None, half_batch: bool = False,
                        dev_half: bool = False) -> dict:
        out = super().control_numbers(prec, half_batch, dev_half)
        if not dev_half:
            out.update(self.switch_numbers(prec, half_batch))
        return out
