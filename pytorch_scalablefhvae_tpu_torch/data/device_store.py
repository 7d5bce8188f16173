"""Device-resident training data: the packed store staged on the device.

Counterpart of ``pytorch_scalablefhvae_tpu/data/device_store.py``. The
packed ``[frames, D]`` store is copied to the device once per run in the
run's transfer dtype (float32; bfloat16; or int8, as per-column affine
``uint8`` rows with their fp32 ``scale`` and ``offset``, a
:class:`Quantized`), with ``STORE_TAIL_SLACK`` zero rows after it (the
chunked window gather reads whole regions that may run past the last
sequence); each epoch then uploads only its index plan, and every step
gathers its segments on the device (``train/device_step.py``). A store over
the budget streams through the device instead (``data/stream_store.py``).

The host-side pieces are this package's own numpy copies of the JAX
package's: ``EpochPlan``, ``build_epoch_plan``, ``STORE_TAIL_SLACK``,
``staging_itemsize`` and ``resolve_data_placement``. A hierarchical round
on a store over the budget stages its sub-pack into a buffer of a fixed
row ceiling (``DeviceDataSource(pad_to_rows=)``): a round held as a
layout (:class:`RoundLayout`) by one launch of ``ops/stage_gather.py`` from
the host store, page-locked and mapped once (``hold_host``,
``restage_runs``), or, for int8 staging, a sub-pack materialised on the
host (``restage``).
``--epoch-plan device`` derives each epoch's plan on the device from the
per-sequence vectors and a seeded generator (:func:`make_device_epoch_plan`,
:class:`DeviceEpochPlanner`) instead of uploading it.

On a mesh (``DeviceDataSource(mesh=)``) the store is staged without the
tail slack (the chunked MAP pass does not run there) in any transfer dtype.
By default every rank stages the whole store, the JAX package's default;
with ``shard_store`` and a model axis ``m > 1`` (``--shard-device-store``;
on one device a no-op, as in the JAX package) the row count is padded to a
multiple of ``m`` and rank ``(i, j)`` stages rows ``[j R/m, (j+1) R/m)``
only, a :class:`RowShard` whose windows the gather sums over the model
group (``train/device_step.py`` ``gather_segments``). An int8 store is
quantized whole on every rank, so every rank holds the same scale and
offset.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from pytorch_scalablefhvae_tpu_torch.data.quantize import quantize_columns
from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
from pytorch_scalablefhvae_tpu_torch.ops import stage_gather
from pytorch_scalablefhvae_tpu_torch.train import trace

# zero rows appended to the staged pack: the chunked window gather
# (ops/window_gather.py) reads whole ``(spb-1)*shift + seg_len`` regions
# whose tail may extend past the last sequence's frames; the slack keeps
# those regions inside the allocation (the overhanging windows carry weight 0
# and are never consumed). 256 rows cover any
# ``(spb-1)*seg_shift + seg_len <= 256`` — e.g. spb=16 at the default
# shift 8 up to seg_len 136; ``chunk_layout`` raises when a configuration
# would exceed it.
STORE_TAIL_SLACK = 256

# the longest run of the kernel's runs table (:func:`gather_runs` on a
# GPU): longer ones are cut, so that its blocks, one a run, are many and
# even; at a round of 5,000 LibriSpeech-sized sequences 64 rows read
# fastest of 64-2,048 (87.5 ms against 93.7 at 128 and 96.2 at 256 on an
# H100)
GATHER_PIECE_ROWS = 64


def staging_itemsize(store_dtype: str) -> int:
    """Bytes per element a staged store ships/holds for ``store_dtype``
    ("float32" | "bfloat16" | "int8"). The ONE definition every budget
    computation uses (placement resolution, verbose MB prints) — drifted
    copies mis-budget device memory and silently pick the wrong data tier."""
    return {"bfloat16": 2, "int8": 1}.get(store_dtype, 4)


@dataclass
class EpochPlan:
    """Host-side segment schedule for one epoch (uploaded once per epoch).

    ``seq_idx``/``abs_starts`` are padded to a whole number of batches; rows
    at positions >= ``n_real`` are padding (sequence 0, frame 0) and receive
    weight 0 inside the step.

    With device-side planning the index arrays never exist on the host;
    :meth:`meta` carries only the bookkeeping
    (``n_real``/``n_rows``/``batch_size``) the loop needs.
    """

    seq_idx: np.ndarray | None  # [Npad] int32 — mu2-table row per segment
    abs_starts: np.ndarray | None  # [Npad] int32 — abs frame offset in pack
    n_real: int
    batch_size: int
    n_rows: int | None = None  # defaults to len(seq_idx)

    @property
    def n_batches(self) -> int:
        rows = self.n_rows if self.n_rows is not None else len(self.seq_idx)
        return rows // self.batch_size

    @classmethod
    def meta(cls, n_real: int, batch_size: int) -> "EpochPlan":
        """Bookkeeping-only plan for device-side planning: the loop
        dispatches ``ceil(n_real / batch_size)`` batches; rows past
        ``n_real`` (always at the tail) carry weight 0."""
        rows = n_real + (-n_real) % batch_size
        return cls(seq_idx=None, abs_starts=None, n_real=n_real,
                   batch_size=batch_size, n_rows=rows)

    def batch_real_counts(self) -> list[int]:
        """Per-batch real-row counts (for seg/s accounting)."""
        counts = []
        for b in range(self.n_batches):
            lo = b * self.batch_size
            counts.append(int(np.clip(self.n_real - lo, 0, self.batch_size)))
        return counts


def build_epoch_plan(
    dataset: SegmentDataset, order: np.ndarray, batch_size: int,
    pad_rows: int | None = None,
) -> EpochPlan:
    """Materialize the epoch's segment schedule from a permutation.

    ``order`` must be the SAME permutation the host loader would use
    (``SegmentLoader._order()``), so the device-resident path trains on an
    identical batch sequence — the equivalence tests rely on it.

    ``pad_rows``: pad the index ARRAYS to this fixed length (a per-run
    ceiling) while ``n_batches`` still covers only ``ceil(n_real / B)``
    batches (hierarchical rounds have varying subset sizes).
    """
    seq_idx = dataset.seq_idx[order].astype(np.int32)
    starts = dataset.starts[order].astype(np.int64)
    abs_starts = (dataset.store.seq_starts[seq_idx] + starts).astype(np.int32)
    n_real = len(order)
    rows = n_real + (-n_real) % batch_size
    target = pad_rows if pad_rows is not None else rows
    if target < rows:
        # the index arrays must cover every row the n_batches slices read
        raise ValueError(
            f"pad_rows={pad_rows} < batch-rounded row count {rows} "
            f"(n_real={n_real}, batch_size={batch_size})")
    pad = target - n_real
    if pad:
        seq_idx = np.concatenate([seq_idx, np.zeros(pad, np.int32)])
        abs_starts = np.concatenate([abs_starts, np.zeros(pad, np.int32)])
    return EpochPlan(seq_idx=seq_idx, abs_starts=abs_starts, n_real=n_real,
                     batch_size=batch_size, n_rows=rows)


def make_device_epoch_plan(generator: torch.Generator | None,
                           seq_starts: torch.Tensor, nsegs: torch.Tensor,
                           n_real: int, n_rows: int, seg_shift: int,
                           shuffle: bool = True):
    """One epoch's plan derived on the device (the JAX package's in-graph
    planner): ``(seq_idx [n_rows], abs_starts [n_rows])``, int64, on
    ``seq_starts``' device.

    Segment ``g`` belongs to the sequence whose window range holds it (the
    ``repeat_interleave`` of ``nsegs``, found by ``searchsorted`` over its
    prefix sums, so nothing waits for the device); its first frame is
    ``seq_starts[s] + (g - offs[s]) * seg_shift``. Rows at or past ``n_real``
    (``sum(nsegs)``) are padding ``(0, 0)``. With ``shuffle`` the real rows
    are permuted by ``torch.randperm`` drawn from ``generator`` (on the same
    device), any uniform permutation being an epoch order; the padding stays
    at the tail. Without it the plan is sequence-major, the host plan of
    ``np.arange`` (:func:`build_epoch_plan`). Deterministic windowing only:
    random windows are drawn on the host."""
    if n_real > n_rows:
        raise ValueError(f"n_real={n_real} segments do not fit a plan of "
                         f"n_rows={n_rows}")
    dev = seq_starts.device
    nsegs = nsegs.to(torch.long)
    ends = torch.cumsum(nsegs, 0)
    g = torch.arange(n_rows, device=dev)
    seq = torch.searchsorted(ends, g, right=True).clamp(max=len(nsegs) - 1)
    starts = seq_starts.to(torch.long)[seq] + (g - (ends - nsegs)[seq]) \
        * seg_shift
    real = g < n_real
    seq = torch.where(real, seq, 0)
    starts = torch.where(real, starts, 0)
    if shuffle:
        perm = torch.randperm(n_real, generator=generator, device=dev)
        seq[:n_real] = seq[perm]
        starts[:n_real] = starts[perm]
    return seq, starts


def model_axis(mesh) -> int:
    """The model-axis size of a mesh (``shape`` ``(d, m)``); 1 without
    one."""
    return 1 if mesh is None else mesh.shape[1]


def store_budget(max_bytes: int, mesh=None, shard_store: bool = False) -> int:
    """The device-store budget of a run: ``max_bytes`` per device, times the
    model axis when the store is row-sharded over it."""
    return max_bytes * (model_axis(mesh) if shard_store else 1)


def resolve_data_placement(
    placement: str,
    store,
    mesh=None,
    shard_store: bool = False,
    max_bytes: int = 4 << 30,
    legacy: bool = False,
    store_dtype: str = "float32",
) -> bool:
    """Decide whether training data lives on device this run.

    ``auto`` stages the store iff its packed bytes fit the budget (scaled by
    the model-axis size when row-sharded). Legacy per-step epoch emulation
    always uses the host loader (its log/break semantics are per-batch).
    """
    if legacy:
        if placement == "device":
            raise ValueError("data_placement=device is incompatible with "
                             "legacy per-step epochs; use host")
        return False
    if placement == "host":
        return False
    itemsize = staging_itemsize(store_dtype)
    nbytes = store.data.shape[0] * store.dim * itemsize
    budget = store_budget(max_bytes, mesh, shard_store)
    if placement == "device":
        if nbytes > budget:
            # fail here with a configuration error instead of an opaque
            # out-of-memory later inside the staging copy
            raise ValueError(
                f"data_placement=device but the packed store is "
                f"{nbytes / 2**30:.2f} GiB, over the "
                f"{budget / 2**30:.2f} GiB device-store budget — raise "
                f"--device-store-max-bytes (or shard the store over a "
                f"model axis / use --transfer-dtype bfloat16 staging), "
                f"or use data_placement=auto/host")
        return True
    if placement == "auto":
        return nbytes <= budget
    raise ValueError(f"Unknown data_placement {placement!r}")


STAGING_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "int8": torch.uint8}


class RowShard(NamedTuple):
    """This rank's part of a store row-sharded over the model axis of
    ``mesh``: of every ``period`` rows (the padded store, or one streamed
    chunk's slot) the rank holds the ``per`` rows from ``lo`` on, the
    periods one after the other in ``local`` (a tensor in the staging dtype,
    or a ``Quantized``). Row ``g`` of the whole store is ``local[(g //
    period) * per + g % period - lo]`` on the rank that owns it."""

    local: "torch.Tensor | Quantized"
    lo: int
    per: int
    period: int
    mesh: object

    @property
    def device(self) -> torch.device:
        return self.local.device


class Quantized(NamedTuple):
    """A store staged at ``--transfer-dtype int8`` (``data/quantize.py``):
    a row reads back as ``rows[i].float() * scale + offset`` in fp32, the
    bits of ``quantize.dequantize`` on the host."""

    rows: torch.Tensor    # [N, D] uint8
    scale: torch.Tensor   # [D] float32
    offset: torch.Tensor  # [D] float32

    @property
    def device(self) -> torch.device:
        return self.rows.device


def host_rows(data: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """``data [rows, D]`` float32 (a memory-mapped store is read-only, and
    only read here) as a CPU tensor of ``dtype``: bfloat16 rounds to nearest
    even, the bits of ``ml_dtypes.bfloat16``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(np.asarray(data, dtype=np.float32))
    return t if dtype == torch.float32 else t.to(dtype)


def copy_rows(dst: torch.Tensor, data: np.ndarray,
              block_rows: int = 1 << 20) -> None:
    """``dst[:len(data)] = data`` in ``dst``'s dtype, converted on the host
    ``block_rows`` at a time, so that the host holds one block beside the
    store, whatever its size."""
    for lo in range(0, data.shape[0], block_rows):
        blk = data[lo:lo + block_rows]
        dst[lo:lo + blk.shape[0]].copy_(host_rows(blk, dst.dtype))


class RoundLayout:
    """A hierarchical round's sub-pack as a layout alone, for a round whose
    rows are gathered from the host store straight into the staged buffer:
    the keys in draw order, their lengths, each sequence's first row in
    the sub-pack (``seq_starts``, local: the cumulative sum of the lengths)
    and in the host store (``src_starts``). It has no rows on the host:
    reading ``data`` raises."""

    def __init__(self, store, keys):
        idx = np.asarray([store.seq2idx[k] for k in keys], dtype=np.int64)
        self.seq_keys = list(keys)
        self.seq2idx = {k: i for i, k in enumerate(self.seq_keys)}
        self.lens = store.lens[idx]
        self.dim = store.dim
        self.src_starts = np.asarray(store.seq_starts, np.int64)[idx]
        self.seq_starts = np.zeros(len(idx), dtype=np.int64)
        np.cumsum(self.lens[:-1], out=self.seq_starts[1:])
        self.rows = int(self.lens.sum())
        self.mvn_params = store.mvn_params

    @property
    def num_seqs(self) -> int:
        return len(self.seq_keys)

    @property
    def data(self):
        raise RuntimeError(
            "a round gathered on the device has no rows on the host: they "
            "live in the staged buffer (DeviceDataSource.restage_runs)")


def gather_runs(layout: RoundLayout, lo: int = 0, hi: int | None = None,
                piece: int | None = None) -> np.ndarray:
    """``[R, 3]`` int64 runs ``(src, dst, n)`` that copy ``layout``'s rows
    ``[lo, hi)`` of its sub-pack from the host store into a buffer that
    holds those rows from row 0 (a mesh rank's window of a row-sharded
    buffer), in draw order: a sequence a run, sequences adjacent in the
    store merged, each cut into pieces of at most ``piece`` rows where
    ``piece`` is given."""
    hi = layout.rows if hi is None else hi
    dst = layout.seq_starts
    a = np.clip(dst, lo, hi)
    b = np.clip(dst + layout.lens, lo, hi)
    keep = b > a
    src = (layout.src_starts + a - dst)[keep]
    dst, n = (a - lo)[keep], (b - a)[keep]
    if not len(n):
        return np.zeros((0, 3), np.int64)
    # the kept runs are contiguous in the buffer; merge those that are in
    # the store too
    first = np.ones(len(n), bool)
    first[1:] = src[1:] != src[:-1] + n[:-1]
    heads = np.flatnonzero(first)
    src, dst, n = src[heads], dst[heads], np.add.reduceat(n, heads)
    if piece is None:
        return np.stack([src, dst, n], axis=1)
    pieces = -(-n // piece)
    run = np.repeat(np.arange(len(n)), pieces)
    off = (np.arange(int(pieces.sum()))
           - np.repeat(np.cumsum(pieces) - pieces, pieces)) * piece
    return np.stack([src[run] + off, dst[run] + off,
                     np.minimum(n[run] - off, piece)], axis=1)


class DeviceDataSource:
    """The packed store on ``device`` in ``store_dtype`` (``"float32"``,
    ``"bfloat16"`` or ``"int8"``), plus per-epoch plan uploads. ``data`` is
    the staged tensor, or a :class:`Quantized` for int8, or on a mesh with
    ``shard_store`` a :class:`RowShard` of either.

    ``pad_to_rows``: the staged buffer's row count, at least the store's
    rows and ``STORE_TAIL_SLACK``, for per-round sub-pack staging
    (hierarchical rounds on a store over the budget): every round's sub-pack
    is staged by :meth:`restage` into this one allocation, whose address a
    captured K-step graph keeps. ``mesh``: a rank's mesh; no tail slack
    there, and with ``shard_store`` (a no-op when the model axis is 1) the
    rows padded to a multiple of the model axis and this rank's
    ``mesh.store_rows`` of them staged."""

    def __init__(self, store, device: torch.device,
                 store_dtype: str = "float32", pad_to_rows: int | None = None,
                 mesh=None, shard_store: bool = False):
        rows, dim = store.data.shape
        self.slack = STORE_TAIL_SLACK if mesh is None else 0
        total = rows + self.slack
        if pad_to_rows is not None:
            if total > pad_to_rows:
                raise ValueError(
                    f"staged store needs {total} rows (incl. slack) but "
                    f"pad_to_rows={pad_to_rows}; raise the ceiling")
            total = pad_to_rows
        self.shard_store = bool(shard_store and model_axis(mesh) > 1)
        if self.shard_store:
            total += (-total) % model_axis(mesh)
            self.window = mesh.store_rows(total)
        else:
            self.window = slice(0, total)
        self.total_rows = total
        # one allocation; the rows past a store's stay zero (byte 0 in int8:
        # never addressed by a real plan row)
        self.device = torch.device(device)
        self.store_dtype = store_dtype
        buf = torch.zeros((self.window.stop - self.window.start, dim),
                          dtype=STAGING_DTYPES[store_dtype],
                          device=self.device)
        if store_dtype == "int8":
            zeros = torch.zeros(dim, dtype=torch.float32, device=self.device)
            self.data = Quantized(buf, zeros, zeros.clone())
        else:
            self.data = buf
        if self.shard_store:
            self.data = RowShard(self.data, self.window.start, buf.shape[0],
                                 total, mesh)
        self.host = None  # the host store rounds are gathered from
        self.restage(store)

    @property
    def staged(self) -> "torch.Tensor | Quantized":
        """What this device holds: ``data``, or a :class:`RowShard`'s
        rows."""
        return self.data.local if isinstance(self.data, RowShard) \
            else self.data

    @property
    def rows(self) -> torch.Tensor:
        """The staged rows (the bytes of an int8 store)."""
        staged = self.staged
        return staged.rows if isinstance(staged, Quantized) else staged

    def restage(self, store) -> None:
        """Copy ``store`` into the buffer in place, its rows first and zeros
        after them (int8: the whole store's columns' scale and offset; a
        row shard: this rank's window of the rows). The copies run on the
        current stream, so a step issued before reads the rows it was
        issued with; raises when the store and the tail slack do not
        fit."""
        data = store.data
        lo, hi = self._held(data.shape[0])
        buf = self.rows
        if self.store_dtype == "int8":
            q, scale, offset = quantize_columns(data)
            buf[:hi - lo].copy_(torch.from_numpy(q[lo:hi]))
            self.staged.scale.copy_(torch.from_numpy(scale))
            self.staged.offset.copy_(torch.from_numpy(offset))
        else:
            copy_rows(buf, data[lo:hi])
        self._zero_after(hi - lo)

    def _held(self, rows: int) -> tuple[int, int]:
        """The rows ``[lo, hi)`` of a store of ``rows`` rows that this
        rank's buffer holds, from its row 0; raises when the store and the
        tail slack do not fit."""
        if rows + self.slack > self.total_rows:
            raise ValueError(
                f"a store of {rows} rows (and {self.slack} of slack) "
                f"does not fit the staged buffer's {self.total_rows}")
        lo = self.window.start
        return lo, max(min(self.window.stop, rows), lo)

    def _zero_after(self, held: int) -> None:
        """Zero the buffer past its ``held`` staged rows; count them."""
        buf = self.rows
        buf[held:].zero_()
        if trace.ON:
            trace.count("staged_bytes",
                        held * buf.shape[1] * buf.element_size())

    def hold_host(self, data: np.ndarray) -> None:
        """Hold ``data``, the packed host store whose rounds
        :meth:`restage_runs` gathers into the buffer
        (``ops/stage_gather.py`` ``host_store``: on a GPU page-locked and
        mapped, once per array); raises where it cannot be held."""
        try:
            self.host = stage_gather.host_store(data, self.device)
        except stage_gather.NotMapped as e:
            raise RuntimeError(
                f"hierarchical rounds on the round tier gather each round "
                f"from the page-locked host store, which cannot be held: "
                f"{e}; --data-placement host trains from the host loader "
                f"instead") from e

    def upload_runs(self, layout: RoundLayout) -> torch.Tensor:
        """``layout``'s runs table (:func:`gather_runs`) within this rank's
        window, on the device; on a GPU cut into the kernel's pieces."""
        piece = GATHER_PIECE_ROWS if self.device.type == "cuda" else None
        runs = gather_runs(layout, *self._held(layout.rows), piece)
        # the kernel reads and writes where the runs say: hold them inside
        # the host store and the buffer
        ends = runs[:, :2] + runs[:, 2:]
        if len(runs) and (ends[:, 0].max() > self.host.rows.shape[0]
                          or ends[:, 1].max() > self.rows.shape[0]):
            raise ValueError(f"the round's runs reach past the host store "
                             f"or the staged buffer: {ends.max(axis=0)}")
        return self.upload(runs, torch.long)

    def restage_runs(self, layout: RoundLayout, runs: torch.Tensor) -> None:
        """:meth:`restage` of a round held as a layout: its rows (of this
        rank's window) gathered from the held host store by ``runs``
        (:meth:`upload_runs`) in one launch of ``stage_gather``, zeros
        after them, on the current stream; raises when the rows and the
        tail slack do not fit."""
        lo, hi = self._held(layout.rows)
        stage_gather.stage_gather(self.host, runs, self.rows)
        self._zero_after(hi - lo)

    def upload(self, arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device,
                                                             dtype)

    def stage_epoch(self, dataset: SegmentDataset, order: np.ndarray,
                    batch_size: int, pad_rows: int | None = None):
        """Upload one epoch's plan: ``(plan, (seq_idx [Npad] int64,
        abs_starts [Npad] int64, nsegs_tab [S] float32))`` on the device;
        ``pad_rows``: the index arrays' fixed length (``build_epoch_plan``),
        so that every hierarchical round's plan has one shape."""
        plan = build_epoch_plan(dataset, order, batch_size, pad_rows=pad_rows)
        return plan, (self.upload(plan.seq_idx, torch.long),
                      self.upload(plan.abs_starts, torch.long),
                      self.upload(dataset.nsegs, torch.float32))

    def stage_meta(self, dataset: SegmentDataset,
                   pad_seqs: int | None = None):
        """The per-sequence vectors the chunked MAP pass takes: each
        sequence's first frame in the staged buffer and its window count
        (int64), zero-padded to ``pad_seqs`` sequences (window count 0: no
        window, nothing summed)."""
        starts = np.asarray(dataset.store.seq_starts, np.int64)
        nsegs = np.asarray(dataset.nsegs, np.int64)
        if pad_seqs is not None and pad_seqs > len(nsegs):
            pad = pad_seqs - len(nsegs)
            starts = np.concatenate([starts, np.zeros(pad, np.int64)])
            nsegs = np.concatenate([nsegs, np.zeros(pad, np.int64)])
        return self.upload(starts, torch.long), self.upload(nsegs, torch.long)


def plan_seed(seed: int, epoch: int) -> int:
    """The generator seed of ``epoch``'s device plan: a function of the run's
    seed and the epoch alone, so a mid-epoch resume derives the plan the run
    never stopped had (``train/step.py`` ``noise_seed``'s form)."""
    return (((seed + 41) & 0xFFFFFFFF) << 32) | (epoch & 0xFFFFFFFF)


class DeviceEpochPlanner:
    """``--epoch-plan device`` on a staged ``source``: each epoch's plan of
    ``n_rows`` rows (the run's ceiling, so one captured graph serves every
    round) derived on the device by :func:`make_device_epoch_plan` from the
    per-sequence vectors, which :meth:`stage` uploads once per run, or once
    per hierarchical round, and a generator seeded by :func:`plan_seed`."""

    def __init__(self, source: DeviceDataSource, seed: int, seg_shift: int,
                 n_rows: int):
        self.source, self.seed = source, seed
        self.seg_shift, self.n_rows = seg_shift, n_rows
        self.generator = torch.Generator(device=source.device)
        self.meta = None

    def stage(self, dataset: SegmentDataset,
              pad_seqs: int | None = None) -> None:
        """Upload ``dataset``'s sequence starts and window counts (zero
        padded to ``pad_seqs``) and its float window-count table."""
        starts, nsegs = self.source.stage_meta(dataset, pad_seqs)
        self.meta = (starts, nsegs, nsegs.to(torch.float32))

    def plan(self, epoch: int, n_real: int, batch_size: int):
        """``epoch``'s ``(plan, (seq_idx, abs_starts, nsegs_tab))``, as
        ``DeviceDataSource.stage_epoch`` returns the host plan's."""
        starts, nsegs, nsegs_tab = self.meta
        self.generator.manual_seed(plan_seed(self.seed, epoch))
        seq, abs_starts = make_device_epoch_plan(
            self.generator, starts, nsegs, n_real, self.n_rows,
            self.seg_shift)
        return (EpochPlan.meta(n_real, batch_size),
                (seq, abs_starts, nsegs_tab))
