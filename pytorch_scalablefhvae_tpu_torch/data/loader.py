"""Fixed-shape batch loader with background prefetch.

Replaces the reference's ``torch.utils.data.DataLoader(num_workers=4)``
(train_model.py:379-395) with a design suited to an accelerator:

- every batch has the same static shape ``[B, seg_len, dim]`` (the kernels
  are launched at one shape); the final partial batch is padded and carries a weight
  mask so padded rows contribute zero loss;
- a batch is one vectorized gather from the packed :class:`FeatureStore`
  (no per-item file I/O);
- an optional background thread keeps ``prefetch`` batches ready so host
  batch assembly overlaps device compute.

The port's own copy of the JAX package's ``data/loader.py``, without its
device-prefetch helpers (``train/loop.py`` moves batches to the device), and
with bfloat16 batches made by ``torch`` (round to nearest even, the bits of
``ml_dtypes.bfloat16``) instead of ``ml_dtypes``, which is JAX's dependency.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset


@dataclass
class Batch:
    """One fixed-shape training batch.

    Attributes:
        feats:   [B, seg_len, dim] float32, or a torch.bfloat16 tensor
                 where the loader's transfer dtype is bfloat16
        seq_idx: [B] int32 — mu2-table row of each segment's sequence
        nsegs:   [B] float32 — segment count of the owning sequence
                 (weights log p(mu2) in the ELBO; simple_fhvae.py:116)
        weight:  [B] float32 — 1 for real rows, 0 for padding
    """

    feats: "np.ndarray | torch.Tensor"
    seq_idx: np.ndarray
    nsegs: np.ndarray
    weight: np.ndarray
    # real-row count, cached host-side so reading it never syncs a device
    # tensor after the batch was moved to the device
    n_real: int = -1

    @property
    def num_real(self) -> int:
        if self.n_real >= 0:
            return self.n_real
        return int(np.asarray(self.weight).sum())


class SegmentLoader:
    def __init__(
        self,
        dataset: SegmentDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        transfer_dtype: str = "float32",
        indices: "np.ndarray | None" = None,
    ):
        """``transfer_dtype``: dtype of the emitted feature batches.
        "bfloat16" halves host->device transfer bytes (and device memory for the staged
        batch); the model upcasts to float32 on entry, so only the feature
        quantization (~3 decimal digits) changes. Opt-in: useful when the
        input link, not compute, bounds throughput. "int8" stages only the
        device tiers' stores: the loader then emits float32 batches, as the
        JAX package's does. On a mesh every rank assembles the whole batch
        and moves its rows of it, in either dtype
        (``train/loop.py`` ``batch_tensors``).

        ``indices``: optional fixed subset of GLOBAL segment indices to
        iterate instead of the whole dataset (e.g. the chunk-skip subsample
        of a hierarchical round's MAP-init pass,
        data.segments.chunk_skip_indices)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.indices = None if indices is None else np.asarray(indices)
        self.bfloat16 = transfer_dtype == "bfloat16"
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if self.dataset.rand_seg:
            self.dataset.resample_segments(self.seed + 7919 * epoch)

    def __len__(self) -> int:
        n = (len(self.indices) if self.indices is not None
             else len(self.dataset))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        base = (self.indices if self.indices is not None
                else np.arange(len(self.dataset)))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + 1_000_003 * self._epoch)
            return rng.permutation(base)
        return base

    def _assemble(self, idx: np.ndarray) -> Batch:
        ds = self.dataset
        B = self.batch_size
        real = len(idx)
        if real < B:
            # pad by repeating the first index; weights zero the extras
            pad = np.full(B - real, idx[0] if real else 0, dtype=idx.dtype)
            idx = np.concatenate([idx, pad])
        seq_idx = ds.seq_idx[idx]
        feats = ds.store.gather_segments(seq_idx, ds.starts[idx], ds.seg_len)
        nsegs = ds.nsegs[seq_idx].astype(np.float32)
        weight = np.zeros(B, dtype=np.float32)
        weight[:real] = 1.0
        feats = np.ascontiguousarray(feats, dtype=np.float32)
        if self.bfloat16:
            feats = torch.from_numpy(feats).to(torch.bfloat16)
        return Batch(
            feats=feats,
            seq_idx=seq_idx.astype(np.int32),
            nsegs=nsegs,
            weight=weight,
            n_real=real,
        )

    def _batches_indices(self, start_batch: int = 0) -> Iterator[np.ndarray]:
        order = self._order()
        n = len(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for s in range(start_batch * self.batch_size, stop, self.batch_size):
            yield order[s : s + self.batch_size]

    def __iter__(self) -> Iterator[Batch]:
        return self.batches_from(0)

    def batches_from(self, start_batch: int) -> Iterator[Batch]:
        """Iterate the epoch from batch ``start_batch`` (mid-epoch resume:
        the skipped batches are never assembled — the deterministic order
        is just sliced past them)."""
        if self.prefetch <= 0:
            for idx in self._batches_indices(start_batch):
                yield self._assemble(idx)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _SENTINEL = object()
        stop = threading.Event()
        failure: list[BaseException] = []

        def _put(item) -> bool:
            """Blocking put that aborts when the consumer abandoned us."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idx in self._batches_indices(start_batch):
                    if not _put(self._assemble(idx)):
                        return
            except BaseException as e:  # surface in the consumer, never
                failure.append(e)       # silently truncate the epoch
            finally:
                _put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    if failure:
                        raise failure[0]
                    break
                yield item
        finally:
            # consumer abandoned the iterator (break / GC): release the
            # producer so it does not stay blocked on the bounded queue
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)

