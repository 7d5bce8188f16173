"""Segment index construction.

Windowing math matches the reference (datasets.py:155-185): deterministic
mode yields ``(len - seg_len) // seg_shift + 1`` segments at stride
``seg_shift``; random mode draws ``floor(len / seg_shift)`` start positions
per sequence (the *documented* contract, datasets.py:70-72 — the reference
code drew the sliding-window count instead; defect B19 is fixed here).

The index is held as flat numpy arrays (seq_idx, start) — no per-segment
Python objects — so shuffling and batch gathering are vectorized.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pytorch_scalablefhvae_tpu_torch.data.feature_store import FeatureStore


def make_segments(
    lens: np.ndarray,
    seg_len: int = 20,
    seg_shift: int = 8,
    rand_seg: bool = False,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the segment index for per-sequence lengths.

    Returns:
        seq_idx: [n_segments] int32 — owning sequence of each segment
        starts:  [n_segments] int32 — frame offset within the sequence
        nsegs:   [n_seqs] int32 — segment count per sequence
    """
    lens = np.asarray(lens, dtype=np.int64)
    if rand_seg:
        if rng is None:
            rng = np.random.default_rng()
        nsegs = np.maximum(lens // seg_shift, 0).astype(np.int32)
        nsegs = np.where(lens >= seg_len, nsegs, 0).astype(np.int32)
        seq_idx = np.repeat(np.arange(len(lens), dtype=np.int32), nsegs)
        max_start = np.repeat((lens - seg_len).clip(min=0), nsegs)
        starts = (rng.random(len(seq_idx)) * (max_start + 1)).astype(np.int32)
    else:
        nsegs = np.where(lens >= seg_len, (lens - seg_len) // seg_shift + 1, 0).astype(np.int32)
        seq_idx = np.repeat(np.arange(len(lens), dtype=np.int32), nsegs)
        within = np.concatenate([np.arange(n, dtype=np.int32) for n in nsegs]) if len(lens) else np.zeros(0, np.int32)
        starts = within * seg_shift
    return seq_idx.astype(np.int32), starts.astype(np.int32), nsegs


@dataclass
class SegmentDataset:
    """A feature store plus its segment index.

    Equivalent capability to reference ``NumpyDataset`` / ``KaldiDataset``
    (datasets.py:188-274): item ``i`` is ``(seq_idx, [seg_len, dim] feature
    slice, nsegs-of-that-sequence)``.
    """

    store: FeatureStore
    seg_len: int = 20
    seg_shift: int = 8
    rand_seg: bool = False
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed) if self.rand_seg else None
        self.seq_idx, self.starts, self.nsegs = make_segments(
            self.store.lens, self.seg_len, self.seg_shift, self.rand_seg, rng
        )

    def resample_segments(self, seed: int) -> None:
        """Redraw random segment starts (rand_seg mode), e.g. per epoch."""
        if self.rand_seg:
            rng = np.random.default_rng(seed)
            self.seq_idx, self.starts, self.nsegs = make_segments(
                self.store.lens, self.seg_len, self.seg_shift, True, rng
            )

    def __len__(self) -> int:
        return len(self.seq_idx)

    @property
    def num_seqs(self) -> int:
        return self.store.num_seqs

    def __getitem__(self, i: int) -> tuple[int, np.ndarray, int]:
        s = int(self.seq_idx[i])
        feat = self.store.gather_segments(
            self.seq_idx[i : i + 1], self.starts[i : i + 1], self.seg_len
        )[0]
        return s, feat, int(self.nsegs[s])


def chunk_skip_indices(seq_idx: np.ndarray, spb: int = 16,
                       skip: int = 8) -> np.ndarray:
    """Global indices of every ``skip``-th chunk of ``spb`` consecutive
    windows of each sequence — chunk 0 is always kept, so every sequence
    retains at least ``min(spb, nsegs)`` windows.

    The host mirror of the device MAP pass's subsampling
    (train/device_step.py make_device_map_pass_chunked: ``cps[k] =
    ceil(ceil(nseg/spb)/skip)``): the MAP table a hierarchical round
    produces is an initialization the round's Adam steps immediately
    refine, z2 is a sequence-level factor present in every segment, and
    adjacent windows overlap ``(seg_len - seg_shift)`` frames — so a
    stride-``skip`` burst sample changes the estimate negligibly while
    cutting the encode + host->device transfer by that factor. Assumes the
    sequence-major segment ordering ``make_segments`` emits.
    """
    seq_idx = np.asarray(seq_idx)
    n = len(seq_idx)
    if skip <= 1 or n == 0:
        return np.arange(n)
    seq_start = np.zeros(n, dtype=np.int64)
    change = np.flatnonzero(np.diff(seq_idx)) + 1
    seq_start[change] = change
    np.maximum.accumulate(seq_start, out=seq_start)
    j = np.arange(n) - seq_start  # window index within its sequence
    return np.flatnonzero((j // spb) % skip == 0)
