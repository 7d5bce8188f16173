"""Streamed device-data tier: chunks of the packed store double-buffered
through the device.

Counterpart of ``pytorch_scalablefhvae_tpu/data/stream_store.py``. A packed
store over the device-store budget is partitioned into sequence-aligned
CHUNKS small enough that two fit the budget at once. While the train steps
consume chunk c's segments (gathered on the device from the staged chunk,
as on the device-resident tier), chunk c+1 is copied in behind them, so each
frame crosses the host-to-device link once an epoch and the overlapping
windows are cut on the device. Chunk visit order is shuffled per epoch and
segments are shuffled within each chunk; a host-fed replay of the same
schedule trains to the same bits (``tests/test_torch_stream.py``).

The host half is this package's own copy of the JAX package's:
:class:`ChunkSpec`, :func:`partition_chunks`, the schedule
(:meth:`StreamingDeviceSource.epoch_schedule`), the chunk plans
(``_plan_for``: corpus-wide sequence rows, chunk-relative frame starts, a
fixed ``plan_rows`` whose padding batches are never dispatched), the int8
per-chunk quantize cache with its byte cap, ``host_bytes_per_epoch`` and
:func:`resolve_data_mode`. :func:`resolve_tier` picks the run's tier from
them.

The device half is torch's own, not a translation of ``jax.device_put``:

- two slots of ``[chunk_rows, D]`` in the staging dtype, allocated once as
  one ``[2, chunk_rows, D]`` tensor, so that every step gathers from one
  store address, ``data``, the flat ``[2 * chunk_rows, D]`` view: a chunk's
  plan starts carry its slot's row offset. A K-step bundle captured as a
  CUDA graph reads that one address, whichever slot a chunk lands in (one
  capture, not one a slot). An int8 store is a ``Quantized`` whose
  ``scale`` and ``offset`` are the current chunk's, copied in at its
  switch on the compute stream;
- two pinned host buffers, filled by one background thread (``numpy`` and
  ``torch`` copies, which release the interpreter lock) while the steps of
  the chunk before run;
- a copy stream of its own, which copies chunk c+1 with ``non_blocking``
  while the compute stream trains on chunk c;
- per slot, an event recorded when its copy has landed (the compute stream
  waits on it before the chunk's first step, and the filler before it
  refills the slot's host buffer) and one recorded after the last step that
  reads it (the copy stream waits on it before refilling the slot). A slot
  is refilled in place, so holding its tensor with ``record_stream`` would
  not be enough;
- the per-sequence ``nsegs`` table staged once.

On the CPU the same code runs with plain copies and no events.

On a mesh every rank runs its own source: the schedule and the chunk plans
are functions of the seed, so every rank switches chunk at the same batch.
With ``shard_store`` and a model axis ``m > 1`` (``--shard-device-store``)
``chunk_rows`` is padded to a multiple of ``m`` and a rank fills and copies
only its rows of each chunk (``mesh.store_rows``), so its link carries 1/m
of each chunk; ``data`` is then a ``RowShard`` whose period is one slot.
An int8 chunk is quantized whole on every rank (its scale and offset are
the whole chunk's, as in the JAX package) before the rank takes its rows.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from pytorch_scalablefhvae_tpu_torch.data.device_store import (
    STAGING_DTYPES,
    EpochPlan,
    Quantized,
    RowShard,
    copy_rows,
    model_axis,
    resolve_data_placement,
    staging_itemsize,
    store_budget,
)
from pytorch_scalablefhvae_tpu_torch.data.quantize import quantize_columns
from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset


@dataclass(frozen=True)
class ChunkSpec:
    """One sequence-aligned slice of the packed store.

    Sequences (and therefore segments — ``make_segments`` emits them
    sequence-major) are contiguous per chunk, so the chunk's frames are ONE
    contiguous ``[n_frames, dim]`` region of the pack and its segments one
    contiguous range of the dataset's segment index.
    """

    seq_lo: int
    seq_hi: int
    frame_base: int  # global frame offset of seq_lo's first frame
    n_frames: int
    seg_lo: int  # segment-index range [seg_lo, seg_hi) in dataset order
    seg_hi: int

    @property
    def n_segments(self) -> int:
        return self.seg_hi - self.seg_lo


def partition_chunks(lens: np.ndarray, nsegs: np.ndarray, dim: int,
                     itemsize: int, chunk_bytes: int) -> list[ChunkSpec]:
    """Greedy sequence-aligned partition: walk sequences in store order,
    close a chunk when adding the next sequence would exceed ``chunk_bytes``.
    A single sequence larger than the budget raises (it could never stage).
    """
    lens = np.asarray(lens, dtype=np.int64)
    nsegs = np.asarray(nsegs, dtype=np.int64)
    row_bytes = dim * itemsize
    max_rows = max(chunk_bytes // max(row_bytes, 1), 1)
    too_big = int(lens.max(initial=0))
    if too_big > max_rows:
        raise ValueError(
            f"a single sequence has {too_big} frames "
            f"({too_big * row_bytes / 2**20:.1f} MiB) — larger than the "
            f"{chunk_bytes / 2**20:.1f} MiB stream chunk budget; raise "
            f"--stream-chunk-bytes")
    chunks: list[ChunkSpec] = []
    seq_starts = np.concatenate([[0], np.cumsum(lens)])
    seg_starts = np.concatenate([[0], np.cumsum(nsegs)])
    lo = 0
    n = len(lens)
    while lo < n:
        hi = lo
        rows = 0
        while hi < n and rows + lens[hi] <= max_rows:
            rows += int(lens[hi])
            hi += 1
        chunks.append(ChunkSpec(
            seq_lo=lo, seq_hi=hi,
            frame_base=int(seq_starts[lo]), n_frames=rows,
            seg_lo=int(seg_starts[lo]), seg_hi=int(seg_starts[hi]),
        ))
        lo = hi
    return chunks


class StreamChunk(NamedTuple):
    """One staged chunk of an epoch: its plan, the plan on the device
    ``(seq_idx [plan_rows], starts [plan_rows] into the source's data,
    nsegs_tab [S])``, the batch of the chunk to start from, and its slot."""

    plan: EpochPlan
    arrays: tuple
    start_batch: int
    slot: int


class StreamingDeviceSource:
    """Double-buffered chunk staging plus per-chunk epoch plans (see the
    module docstring). One instance per training run; the steps gather from
    ``data``, as from a ``DeviceDataSource``'s. Device memory: the two slots, ``2 * chunk_rows * D`` in the
    staging dtype; the training loop defaults ``chunk_bytes`` to a quarter
    of the budget and budgets the dev split against three chunks.

    All chunks share one slot shape and all plans one length
    (``plan_rows``), so one captured K-step bundle serves every chunk of
    every epoch.
    """

    def __init__(self, dataset: SegmentDataset, chunk_bytes: int,
                 batch_size: int, device: torch.device,
                 store_dtype: str = "float32", mesh=None,
                 shard_store: bool = False):
        store = dataset.store
        self.dataset = dataset
        self.quantized = store_dtype == "int8"
        self.dtype = STAGING_DTYPES[store_dtype]
        self.itemsize = staging_itemsize(store_dtype)
        self.chunks = partition_chunks(store.lens, dataset.nsegs, store.dim,
                                       self.itemsize, chunk_bytes)
        self.chunk_rows = max(c.n_frames for c in self.chunks)
        self.shard_store = bool(shard_store and model_axis(mesh) > 1)
        if self.shard_store:
            self.chunk_rows += (-self.chunk_rows) % model_axis(mesh)
            self.window = mesh.store_rows(self.chunk_rows)
        else:
            self.window = slice(0, self.chunk_rows)
        per = self.window.stop - self.window.start
        # fixed plan length: every chunk's plan pads to a whole number of
        # batches; only each chunk's real batches are dispatched
        segs = max(c.n_segments for c in self.chunks)
        self.plan_rows = segs + (-segs) % batch_size
        self.batch_size = batch_size
        self.device = torch.device(device)

        dim, cuda = store.dim, self.device.type == "cuda"
        self._slots = torch.zeros((2, per, dim), dtype=self.dtype,
                                  device=self.device)
        self._host = [torch.zeros((per, dim), dtype=self.dtype,
                                  pin_memory=cuda) for _ in range(2)]
        flat = self._slots.view(2 * per, dim)
        if self.quantized:
            # per slot (scale, offset) on the host and the device; the
            # current chunk's in `data`
            self._host_q = [torch.zeros((2, dim), pin_memory=cuda)
                            for _ in range(2)]
            self._slot_q = torch.zeros((2, 2, dim), device=self.device)
            self._cur_q = torch.zeros((2, dim), device=self.device)
            self.data = Quantized(flat, self._cur_q[0], self._cur_q[1])
        else:
            self.data = flat
        if self.shard_store:
            self.data = RowShard(self.data, self.window.start, per,
                                 self.chunk_rows, mesh)
        # per-sequence nsegs table (global rows), staged once per run
        self.nsegs_tab = torch.from_numpy(
            dataset.nsegs.astype(np.float32)).to(self.device)
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._copied = [torch.cuda.Event() if cuda else None
                        for _ in range(2)]
        self._released = [torch.cuda.Event() if cuda else None
                          for _ in range(2)]
        self._switches: list = []
        # int8 tier: per-chunk quantized buffers reused across epochs,
        # BOUNDED (a corpus-scale pack is memmapped, and an unbounded cache
        # would become the dominant heap allocation); past the cap, chunks
        # are re-quantized per stage, to the same bits
        self._qcache: dict[int, tuple] = {}
        self._qcache_left = max(4 * int(chunk_bytes), 256 << 20)

    # ---- host side ----

    def _quantized_chunk(self, spec: ChunkSpec):
        """``(q [rows, D] uint8, scale [D], offset [D])`` of a chunk, ``q``
        this device's window of its rows, zero-padded: the whole chunk is
        quantized, so a row shard's scale and offset are the chunk's. Chunk
        partitions are fixed for the run and the quantize parameters
        deterministic, so each chunk is quantized once, up to the cache's
        byte cap."""
        cached = self._qcache.get(spec.frame_base)
        if cached is None:
            data = self.dataset.store.data
            real = data[spec.frame_base: spec.frame_base + spec.n_frames]
            q, scale, offset = quantize_columns(real)
            buf = np.zeros((self.chunk_rows, data.shape[1]), np.uint8)
            buf[: spec.n_frames] = q
            rows = np.ascontiguousarray(buf[self.window])
            cached = (rows, scale, offset)
            if self._qcache_left >= rows.nbytes:
                self._qcache[spec.frame_base] = cached
                self._qcache_left -= rows.nbytes
        return cached

    def host_bytes_per_epoch(self) -> int:
        """Link bytes one epoch ships to this device (chunk padding
        included; a row shard's rows only)."""
        row = self.dataset.store.dim * self.itemsize
        per_chunk = (self.window.stop - self.window.start) * row
        if self.quantized:  # + the per-column scale/offset f32 legs
            per_chunk += 2 * self.dataset.store.dim * 4
        return per_chunk * len(self.chunks)

    def epoch_schedule(self, epoch_seed: int
                       ) -> list[tuple[ChunkSpec, np.ndarray]]:
        """The epoch's deterministic schedule: shuffled chunk visit order,
        with a within-chunk permutation of GLOBAL segment indices per chunk
        (what :meth:`epoch_batches` trains on, for a host replay)."""
        rng = np.random.default_rng(epoch_seed)
        visit = rng.permutation(len(self.chunks))
        out = []
        for ci in visit:
            c = self.chunks[ci]
            order = c.seg_lo + rng.permutation(c.n_segments)
            out.append((c, order))
        return out

    def _plan_for(self, spec: ChunkSpec, order: np.ndarray
                  ) -> tuple[EpochPlan, np.ndarray, np.ndarray]:
        """Chunk plan: GLOBAL sequence rows (the mu2 table is corpus-wide)
        and CHUNK-RELATIVE frame starts, zero-padded to the fixed length;
        ``n_rows`` counts the real batches only."""
        ds = self.dataset
        seq_idx = ds.seq_idx[order].astype(np.int32)
        abs_starts = (ds.store.seq_starts[seq_idx] + ds.starts[order]
                      - spec.frame_base).astype(np.int32)
        n_real = len(order)
        seq_pad = np.zeros(self.plan_rows, np.int32)
        start_pad = np.zeros(self.plan_rows, np.int32)
        seq_pad[:n_real] = seq_idx
        start_pad[:n_real] = abs_starts
        plan = EpochPlan(seq_idx=None, abs_starts=None, n_real=n_real,
                         batch_size=self.batch_size,
                         n_rows=n_real + (-n_real) % self.batch_size)
        return plan, seq_pad, start_pad

    def _fill(self, spec: ChunkSpec, slot: int) -> None:
        """Fill host buffer ``slot`` with the chunk's rows of this device's
        window, in the staging dtype and zero-padded, once its last copy has
        left it (the filler thread)."""
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        host, lo = self._host[slot], self.window.start
        if self.quantized:
            buf, scale, offset = self._quantized_chunk(spec)
            host.copy_(torch.from_numpy(buf))
            self._host_q[slot].copy_(torch.from_numpy(np.stack([scale,
                                                                offset])))
            return
        hi = max(min(self.window.stop, spec.n_frames), lo)
        data = self.dataset.store.data
        copy_rows(host, data[spec.frame_base + lo: spec.frame_base + hi])
        host[hi - lo:].zero_()

    # ---- device side ----

    def _issue(self, slot: int) -> None:
        """Copy host buffer ``slot`` into its device slot on the copy
        stream, once the steps that read the slot's last chunk have run."""
        if self._copy_stream is None:
            self._slots[slot].copy_(self._host[slot])
            if self.quantized:
                self._slot_q[slot].copy_(self._host_q[slot])
            return
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(self._released[slot])
            self._slots[slot].copy_(self._host[slot], non_blocking=True)
            if self.quantized:
                self._slot_q[slot].copy_(self._host_q[slot],
                                         non_blocking=True)
            self._copied[slot].record(self._copy_stream)

    def _acquire(self, slot: int, host_wait: float) -> None:
        """Make the compute stream wait for the slot's copy before the
        chunk's first step (timed on the device by two events around the
        wait), and point an int8 store at the chunk's scale and offset."""
        events = None
        if self._copy_stream is not None:
            cur = torch.cuda.current_stream(self.device)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(cur)
            cur.wait_event(self._copied[slot])
            events[1].record(cur)
        if self.quantized:
            self._cur_q.copy_(self._slot_q[slot])
        self._switches.append((host_wait, events))

    def _release(self, slot: int) -> None:
        """Every step that reads ``slot`` has been issued: record it on the
        compute stream."""
        if self._copy_stream is not None:
            self._released[slot].record(
                torch.cuda.current_stream(self.device))

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr.astype(np.int64))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def switch_waits(self) -> list[tuple[float, float | None]]:
        """Per chunk switch of the last epoch, ``(host seconds waiting for
        the filler thread, device ms the compute stream waited for the
        slot's copy)`` (``None`` on the CPU); synchronizes the device."""
        out = []
        for host_wait, events in self._switches:
            ms = None
            if events is not None:
                events[1].synchronize()
                ms = events[0].elapsed_time(events[1])
            out.append((host_wait, ms))
        return out

    def epoch_batches(self, epoch_seed: int, skip_batches: int = 0):
        """Yield a :class:`StreamChunk` per chunk of the epoch's schedule,
        with the NEXT chunk's copy already issued, so that staging overlaps
        the consumer's steps. The consumer must issue every step of a chunk
        before it asks for the next.

        ``skip_batches``: mid-epoch resume cursor — chunks whose batches are
        entirely behind it are dropped WITHOUT staging; the first surviving
        chunk carries the within-chunk ``start_batch`` offset.
        """
        B = self.batch_size
        todo = []
        for spec, order in self.epoch_schedule(epoch_seed):
            n_batches = -(-len(order) // B)
            if skip_batches >= n_batches:
                skip_batches -= n_batches
                continue
            todo.append((spec, order, skip_batches))
            skip_batches = 0
        self._switches = []
        n = len(todo)
        slot = None
        pool = ThreadPoolExecutor(1, thread_name_prefix="stream-filler")
        try:
            fills = [pool.submit(self._fill, todo[i][0], i % 2)
                     for i in range(min(n, 2))]
            if n:
                fills[0].result()
                self._issue(0)
            for i, (spec, order, start_b) in enumerate(todo):
                slot = i % 2
                if i >= 1:
                    self._release(1 - slot)  # chunk i-1's steps are issued
                t0 = time.perf_counter()
                if i + 1 < n:
                    fills[i + 1].result()
                    self._issue(1 - slot)
                host_wait = time.perf_counter() - t0
                if i + 2 < n:
                    fills.append(pool.submit(self._fill, todo[i + 2][0],
                                             slot))
                plan, seq_np, starts_np = self._plan_for(spec, order)
                starts_np = starts_np.astype(np.int64) \
                    + slot * self.chunk_rows
                arrays = (self._upload(seq_np), self._upload(starts_np),
                          self.nsegs_tab)
                self._acquire(slot, host_wait)
                yield StreamChunk(plan, arrays, start_b, slot)
        finally:
            if slot is not None:  # the last chunk's steps are issued
                self._release(slot)
            pool.shutdown(wait=True, cancel_futures=True)


def resolve_data_mode(
    placement: str,
    store,
    mesh=None,
    shard_store: bool = False,
    max_bytes: int = 4 << 30,
    legacy: bool = False,
    store_dtype: str = "float32",
    hierarchical: bool = False,
) -> str:
    """Decide the run's data tier: ``"device"`` (whole store staged),
    ``"stream"`` (chunked double-buffered staging), or ``"host"``.

    ``auto`` picks device iff the packed bytes fit the budget (scaled by the
    model-axis size when row-sharded), else stream — unless the run is
    legacy (per-batch log/break semantics) or hierarchical (round subsets
    re-sample sequences across the whole pack, so chunk streaming does not
    compose), which fall back to host.
    """
    if placement == "stream":
        if legacy:
            raise ValueError("data_placement=stream is incompatible with "
                             "legacy per-step epochs; use host")
        if hierarchical:
            # chunk streaming does not compose with hierarchical sampling
            # (round subsets re-sample sequences across the whole pack)
            return "host"
        return "stream"
    if placement == "auto" and not legacy and not hierarchical:
        if resolve_data_placement("auto", store, mesh, shard_store=shard_store,
                                  max_bytes=max_bytes, legacy=legacy,
                                  store_dtype=store_dtype):
            return "device"
        return "stream"
    if placement == "device" and hierarchical and not legacy:
        # an over-budget pack is not a hard config error for hier runs: the
        # unit that must fit is ONE round's sub-pack
        if resolve_data_placement("auto", store, mesh, shard_store=shard_store,
                                  max_bytes=max_bytes, legacy=legacy,
                                  store_dtype=store_dtype):
            return "device"
        return "host"
    fits = resolve_data_placement(placement, store, mesh,
                                  shard_store=shard_store,
                                  max_bytes=max_bytes, legacy=legacy,
                                  store_dtype=store_dtype)
    return "device" if fits else "host"


TIER_WORDS = {"device": "staging it whole", "stream": "streaming it",
              "host": "training from the host loader"}


def resolve_tier(placement: str, store, max_bytes: int,
                 store_dtype: str = "float32", verbose: bool = True,
                 mesh=None, shard_store: bool = False,
                 hierarchical: bool = False, legacy: bool = False) -> str:
    """The run's data tier, ``"device"``, ``"stream"`` or ``"host"``, as
    ``resolve_data_mode`` decides it from the placement and the budget, on
    one device or on a rank of ``mesh``, where ``shard_store`` scales the
    budget by the model axis: ``device`` raises its ``ValueError`` when the
    store is over the budget; ``auto`` stages it when it fits and streams it
    otherwise, and says which (where ``verbose``: one rank of a mesh says
    it). ``legacy`` (``--legacy`` step epochs at batch 1) takes the host
    loader: ``auto`` resolves to it, ``device`` and ``stream`` raise JAX's
    ``ValueError``.

    ``hierarchical``: rounds of a subset of the store. A store that fits
    stages whole (``auto``, ``device``) and a round's subset is a view of
    it; over the budget (or at ``stream``) the tier is ``"host"``, which the
    training loop turns into per-round staging of the subset where one
    round fits (``train/rounds.py``)."""
    mode = resolve_data_mode(placement, store, mesh, shard_store=shard_store,
                             max_bytes=max_bytes, legacy=legacy,
                             store_dtype=store_dtype,
                             hierarchical=hierarchical)
    if verbose and placement == "auto":
        nbytes = (store.data.shape[0] * store.dim
                  * staging_itemsize(store_dtype))
        budget = store_budget(max_bytes, mesh, shard_store)
        within = "within" if nbytes <= budget else "over"
        words = TIER_WORDS[mode]
        if legacy:
            words = "training from the host loader (--legacy)"
        elif hierarchical and mode == "host":
            words = ("staging each hierarchical round's subset where one "
                     "fits, else training from the host loader")
        sharded = (f" ({max_bytes / 1e6:.1f} MB a device x "
                   f"{model_axis(mesh)}, row-sharded over the model axis)"
                   if budget != max_bytes else "")
        print(f"data placement auto: the packed store is {nbytes / 1e6:.1f} "
              f"MB in {store_dtype}, {within} the device-store budget of "
              f"{budget / 1e6:.1f} MB{sharded}; {words}")
    return mode
