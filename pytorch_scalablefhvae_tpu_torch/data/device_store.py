"""Device-resident training data: the packed store staged on the device.

Counterpart of ``pytorch_scalablefhvae_tpu/data/device_store.py``. The
packed ``[frames, D]`` float32 store is copied to the device once per run,
with ``STORE_TAIL_SLACK`` zero rows after it (the chunked window gather
reads whole regions that may run past the last sequence); each epoch then
uploads only its index plan, and every step gathers its segments on the
device (``train/device_step.py``).

The host-side pieces are this package's own numpy copies of the JAX
package's: ``EpochPlan``, ``build_epoch_plan``, ``STORE_TAIL_SLACK``,
``staging_itemsize`` and ``resolve_data_placement`` (its
``data/device_store.py``) and ``resolve_data_mode`` (its
``data/stream_store.py``). :func:`resolve_tier` picks the run's tier from
them. Not ported yet (``ROADMAP.md``): the streamed tier, bfloat16/int8
staging, the on-device epoch plan (``make_device_epoch_plan``) and a store
sharded over a mesh (``--shard-device-store``): on a mesh every rank stages
the whole store, the JAX package's default, and gathers its rows of each
planned batch from it.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset

# zero rows appended to the staged pack: the chunked window gather
# (ops/window_gather.py) reads whole ``(spb-1)*shift + seg_len`` regions
# whose tail may extend past the last sequence's frames; the slack keeps
# those regions inside the allocation (the overhanging windows carry weight 0
# and are never consumed). 256 rows cover any
# ``(spb-1)*seg_shift + seg_len <= 256`` — e.g. spb=16 at the default
# shift 8 up to seg_len 136; ``chunk_layout`` raises when a configuration
# would exceed it.
STORE_TAIL_SLACK = 256


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
    budget = max_bytes
    if mesh is not None and shard_store:
        budget = max_bytes * mesh.shape["model"]
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


def resolve_tier(placement: str, store, max_bytes: int,
                 verbose: bool = True) -> str:
    """The run's data tier, ``"device"`` or ``"host"``, as
    ``resolve_data_mode`` decides it on one device: ``host`` is the loader;
    ``device`` stages the store or raises its ``ValueError`` when it
    is over ``max_bytes``; ``auto`` stages it when it fits. Where ``auto``
    would stream (over budget), the streamed tier is not ported, so the run
    keeps the host loader and says so (where ``verbose``: one rank of a mesh
    says it). The store stages as float32 and, on a mesh, whole on every
    rank."""
    mode = resolve_data_mode(placement, store, max_bytes=max_bytes)
    if mode == "stream":
        if placement != "auto":
            raise NotImplementedError(
                f"--data-placement {placement} is not yet ported to PyTorch "
                f"(ROADMAP.md, item 7)")
        if verbose:
            print(f"data placement auto: the packed store "
                  f"({store.data.nbytes / 1e6:.0f} MB) is over the "
                  f"device-store budget ({max_bytes / 1e6:.0f} MB) and the "
                  f"streamed tier is not yet ported (ROADMAP.md, item 7); "
                  f"training from the host loader")
        return "host"
    return mode


class DeviceDataSource:
    """The packed store on ``device``, plus per-epoch plan uploads."""

    def __init__(self, store, device: torch.device,
                 store_dtype: str = "float32"):
        if store_dtype != "float32":
            raise NotImplementedError(
                f"{store_dtype} staging of the device store is not yet ported "
                f"to PyTorch (ROADMAP.md, item 7)")
        data = np.asarray(store.data, dtype=np.float32)
        rows, dim = data.shape
        # one allocation and one copy; the slack rows stay zero
        self.data = torch.zeros((rows + STORE_TAIL_SLACK, dim),
                                dtype=torch.float32, device=device)
        with warnings.catch_warnings():
            # a memory-mapped store is read-only; it is only read from here
            warnings.simplefilter("ignore", UserWarning)
            self.data[:rows].copy_(torch.from_numpy(data))
        self.device = torch.device(device)

    def upload(self, arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device,
                                                             dtype)

    def stage_epoch(self, dataset: SegmentDataset, order: np.ndarray,
                    batch_size: int):
        """Upload one epoch's plan: ``(plan, (seq_idx [Npad] int64,
        abs_starts [Npad] int64, nsegs_tab [S] float32))`` on the device."""
        plan = build_epoch_plan(dataset, order, batch_size)
        return plan, (self.upload(plan.seq_idx, torch.long),
                      self.upload(plan.abs_starts, torch.long),
                      self.upload(dataset.nsegs, torch.float32))
