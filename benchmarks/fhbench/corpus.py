"""The seeded feature corpus of a traffic mix, made in memory.

One generator for every mix (the parameters are the mix's ``corpus``):
``sequences`` per split with lengths in ``frames`` (inclusive), ``feat_dim``
features a frame, each sequence ``offset_std * N(0, I)`` (what z2 should
find) plus, frame by frame, ``noise_std * N(0, 1)`` and a drift that adds
``drift_std * N(0, 1)`` a frame (what z1 should find). The set of lengths is
fixed by ``lengths_seed``; the run's seed orders it and draws the values,
so every seed does the same amount of work. The values are drawn on the
device in blocks of whole sequences and copied into one host array per
split; nothing is written to disk.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

BLOCK_FRAMES = 1 << 21  # frames drawn per block (at 80 features, 671 MB)
SPLITS = ("train", "dev")


@dataclass
class Split:
    keys: list
    lens: np.ndarray
    offsets: np.ndarray
    frames: np.ndarray  # [total, feat_dim] float32

    def arrays(self) -> dict:
        """``{key: [len, feat_dim]}`` views of the frames."""
        return {k: self.frames[o:o + n]
                for k, o, n in zip(self.keys, self.offsets, self.lens)}


def lengths(spec: dict) -> np.ndarray:
    """The split's fixed set of sequence lengths, before the seed orders
    it."""
    lo, hi = spec["frames"]
    rng = np.random.default_rng(spec.get("lengths_seed", 0))
    return rng.integers(lo, hi + 1, spec["sequences"])


def make_split(name: str, spec: dict, corpus: dict, seed: int,
               device: torch.device) -> Split:
    D = corpus["feat_dim"]
    tag = SPLITS.index(name) + 1
    order_rng = np.random.default_rng([seed, tag])
    lens = order_rng.permutation(lengths(spec)).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    total = int(lens.sum())
    frames = np.empty((total, D), np.float32)
    g = torch.Generator(device=device)
    g.manual_seed((seed * 7919 + tag) % (1 << 63))
    out = torch.from_numpy(frames)
    first = 0
    while first < len(lens):
        last = first + 1
        while (last < len(lens) and offsets[last] + lens[last]
               - offsets[first] <= BLOCK_FRAMES):
            last += 1
        a, b = int(offsets[first]), int(offsets[last - 1] + lens[last - 1])
        seq = torch.from_numpy(np.repeat(np.arange(last - first),
                                         lens[first:last])).to(device)
        x = corpus["noise_std"] * torch.randn((b - a, D), generator=g,
                                              device=device)
        x += corpus["offset_std"] * torch.randn(
            (last - first, D), generator=g, device=device)[seq]
        if corpus.get("drift_std", 0.0):
            step = corpus["drift_std"] * torch.randn(
                (b - a, D), generator=g, device=device)
            walk = torch.cumsum(step, 0)
            starts = torch.from_numpy(offsets[first:last] - a).to(device)
            # each sequence's walk starts afresh at its first frame
            base = walk[starts] - step[starts]
            x += walk - base[seq]
        out[a:b].copy_(x)
        first = last
    keys = [f"{name}_{i:05d}" for i in range(len(lens))]
    return Split(keys, lens, offsets, frames)


def make_corpus(corpus: dict, seed: int, device: torch.device) -> dict:
    """``{"train": Split, "dev": Split}`` of the mix's ``corpus`` for
    ``seed``."""
    return {name: make_split(name, corpus[name], corpus, seed, device)
            for name in SPLITS}
