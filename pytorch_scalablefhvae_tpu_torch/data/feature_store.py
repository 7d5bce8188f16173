"""Packed in-memory feature store.

The reference's datasets re-open one ``.npy`` file (or seek into a Kaldi ark)
per *segment* fetch (datasets.py:214-223, 254-262) — hundreds of file opens
per batch. An accelerator needs the host to produce fixed-shape batches faster than the
device consumes them, so this store packs every kept utterance into one
contiguous ``[total_frames, dim]`` float32 array plus per-sequence offsets;
a batch of segments is then a single vectorized gather.

Supports both reference on-disk formats (SURVEY.md §9): ``feats.scp``
pointing at per-utterance ``.npy`` files (numpy backend) or at
``ark:offset`` rxspecifiers (kaldi backend), with ``len.scp`` for lengths.
Mean/variance normalization matches the reference's JSON cache schema
``{"mean": [[...]], "std": [[...]]}`` (datasets.py:107-129).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np

from pytorch_scalablefhvae_tpu_torch.utils import kaldi_ark
from pytorch_scalablefhvae_tpu_torch.utils.manifest import read_scp


def _is_rxspecifier(v: str) -> bool:
    """Classify a feats.scp value as a Kaldi ``archive:offset`` rxspecifier.

    Classification is by FORMAT, not archive existence: a missing/moved
    archive must surface as a clear FileNotFoundError naming the archive
    (kaldi_ark raises it), not silently demote to a plain-file open of the
    colon-suffixed pseudo-path. The one existence check left is the rare
    literal file whose NAME contains ``:digits`` — that stays a plain path.
    """
    if ":" not in v or v.endswith(".npy"):
        return False
    path, _, off = v.rpartition(":")
    if not off.isdigit() or not path:
        return False
    return not Path(v).exists()


def _load_feat(path_or_rx: str) -> np.ndarray:
    if _is_rxspecifier(path_or_rx):
        return kaldi_ark.load_mat(path_or_rx)
    with open(path_or_rx, "rb") as f:
        return np.load(f)


# archives at or under this size use the C++ bulk reader (one native pass,
# whole archive resident briefly); larger ones stream record-by-record so
# peak memory stays bounded by one utterance
_NATIVE_ARK_BYTES = 1 << 30


def _iter_one_ark(ark: str):
    """Yield (key, float32 matrix, rxspecifier byte offset) from one
    archive: native bulk read for small archives, pure-Python sequential
    streaming for big ones."""
    try:
        if Path(ark).stat().st_size <= _NATIVE_ARK_BYTES:
            from pytorch_scalablefhvae_tpu_torch.native.binding import native_read_ark_packed

            keys, data, offsets, file_offs = native_read_ark_packed(
                ark, with_file_offsets=True)
            for i, k in enumerate(keys):
                yield k, data[offsets[i] : offsets[i + 1]], int(file_offs[i])
            return
    except Exception:
        pass  # toolchain unavailable or read failure: python fallback below
    for k, mat, off in kaldi_ark.iter_ark_offsets(ark):
        yield k, np.asarray(mat, dtype=np.float32), off


def _stream_feats(keep: list[str], feats):
    """Yield ``(key, float32 matrix)`` for every kept feature, one at a time.

    Ark-backed manifests are read with one sequential pass per archive (the
    C++ bulk reader when the archive is small enough to buffer, else a
    streaming record-by-record read — no per-record seeks either way);
    ``.npy`` entries load individually. Order is arbitrary — the caller
    writes each matrix at its own precomputed offset — so peak memory is one
    archive buffer at most, never the whole split."""
    seen: set[str] = set()
    # records are matched against the scp's AUTHORITATIVE (archive, byte
    # offset) binding, not by key alone: after a partial re-extraction a
    # stale record with the same key — in another referenced archive OR
    # earlier in the same one — must never win
    by_ark: dict[str, dict[str, int]] = {}
    for k in keep:
        v = str(feats[k])
        if _is_rxspecifier(v):
            path, _, off = v.rpartition(":")
            by_ark.setdefault(path, {})[k] = int(off)
    for ark in sorted(by_ark):
        wanted = by_ark[ark]
        for k, mat, off in _iter_one_ark(ark):
            if wanted.get(k) == off and k not in seen:
                seen.add(k)
                yield k, np.asarray(mat, dtype=np.float32)
    for k in keep:
        if k not in seen:
            # .npy entries, plus any ark key the sequential pass missed —
            # loaded by the scp's exact path:offset rxspecifier
            yield k, np.asarray(_load_feat(str(feats[k])), dtype=np.float32)


class FeatureStore:
    """Contiguous packed features for one dataset split."""

    def __init__(
        self,
        feat_scp: str | Path,
        len_scp: str | Path,
        min_len: int = 1,
        mvn_path: str | Path | None = None,
        sequence_list: Sequence[str] | None = None,
        verbose: bool = True,
        pack_cache: str | Path | None = None,
    ):
        """``pack_cache``: optional path prefix; the packed ``[total_frames,
        dim]`` array is persisted there once and memory-mapped on later
        constructions — corpus-scale splits (LibriSpeech-960 is ~110 GB
        packed) need not fit in, or be re-packed into, host RAM."""
        feats = read_scp(feat_scp)
        lens = read_scp(len_scp, dtype=int, keep_keys=feats.keys())

        if sequence_list is not None:
            missing = [k for k in sequence_list if k in feats and k not in lens]
            if missing:
                raise ValueError(
                    f"Sequences present in feats.scp but missing from len.scp: "
                    f"{missing[:5]}{'...' if len(missing) > 5 else ''}"
                )
            # min_len applies to explicit lists too (datasets.py:84 semantics)
            keep = [k for k in sequence_list if k in feats and lens[k] >= min_len]
        else:
            # reference filter: keep sequences no shorter than min_len
            # (datasets.py:84). Coverage check first: a truncated/partial
            # len.scp would otherwise surface as a bare KeyError
            missing = [k for k in feats if k not in lens]
            if missing:
                raise ValueError(
                    f"Sequences present in feats.scp but missing from "
                    f"len.scp: {missing[:5]}"
                    f"{'...' if len(missing) > 5 else ''}"
                )
            keep = [k for k in feats if lens[k] >= min_len]
        if len(set(keep)) != len(keep):
            # a duplicated key (user-edited sequence lists) would leave the
            # EARLIER duplicate's pack rows uninitialized: seq2idx maps the
            # key to its last index and _stream_feats yields each key once,
            # so np.empty garbage would silently serve as features
            from collections import Counter

            dups = [k for k, c in Counter(keep).items() if c > 1]
            raise ValueError(
                f"duplicate sequence keys: {dups[:5]}"
                f"{'...' if len(dups) > 5 else ''}")
        if verbose:
            print(f"FeatureStore: {len(keep)} out of {len(feats)} kept, min_len = {min_len}")

        self.seq_keys: list[str] = keep
        self.seq2idx = {k: i for i, k in enumerate(keep)}
        self.lens = np.array([lens[k] for k in keep], dtype=np.int64)

        offsets = np.zeros(len(keep) + 1, dtype=np.int64)
        np.cumsum(self.lens, out=offsets[1:])
        self.seq_starts = offsets[:-1].copy()
        total = int(offsets[-1])

        self.mvn_params: dict | None = None
        cache = Path(pack_cache) if pack_cache is not None else None
        meta_path = cache.with_suffix(".meta.json") if cache is not None else None
        bin_path = cache.with_suffix(".bin") if cache is not None else None

        if cache is not None and meta_path.exists():
            # memmap an existing pack cache (stores MVN-applied data when the
            # cache was built with an mvn_path; meta records which)
            meta = json.loads(meta_path.read_text())
            if meta["keys"] != keep:
                raise ValueError(
                    f"pack cache {cache} was built for a different sequence set"
                )
            if meta["total"] != total:
                raise ValueError(
                    f"pack cache {cache} is stale: built for {meta['total']} "
                    f"total frames, len.scp now gives {total} (re-extract or "
                    "delete the cache)"
                )
            if (meta.get("mvn_params") is None) != (mvn_path is None):
                raise ValueError(
                    f"pack cache {cache} was built with "
                    f"{'no ' if meta.get('mvn_params') is None else ''}MVN but "
                    "this request differs; delete the cache to rebuild"
                )
            if mvn_path is not None:
                # the cached data was normalized with meta's stats — a
                # DIFFERENT stats file at mvn_path (regenerated after
                # re-extraction, or simply another run's) must not be
                # silently ignored; and when the file is absent, write it
                # from meta so downstream consumers of the mvn JSON
                # (reference schema parity) find it where they expect
                _mvn_path = Path(mvn_path)
                if _mvn_path.exists():
                    on_disk = json.loads(_mvn_path.read_text())
                    for leg in ("mean", "std"):
                        if not np.allclose(
                                np.asarray(on_disk[leg], np.float64),
                                np.asarray(meta["mvn_params"][leg],
                                           np.float64)):
                            raise ValueError(
                                f"pack cache {cache} was normalized with "
                                f"different MVN stats than {mvn_path} now "
                                f"holds; delete the cache to rebuild")
                else:
                    _mvn_path.parent.mkdir(parents=True, exist_ok=True)
                    _mvn_path.write_text(json.dumps(meta["mvn_params"]))
            self.dim = meta["dim"]
            self.mvn_params = meta.get("mvn_params")
            self.data = np.memmap(bin_path, dtype=np.float32, mode="r",
                                  shape=(total, self.dim))
            return

        # ---- streaming pack build (BASELINE config 4: corpus-scale splits) --
        # Each utterance is written at its precomputed offset as it decodes;
        # nothing of split size is ever duplicated (the previous build kept a
        # list of all matrices AND their concatenation live at once — ~2x
        # 110 GB for LibriSpeech-960). MVN statistics accumulate during the
        # same pass; normalization is applied chunk-wise in place afterwards.
        mvn_path = Path(mvn_path) if mvn_path is not None else None
        need_stats = mvn_path is not None and not mvn_path.exists()
        sums = sumsq = None
        dest = None
        for k, mat in _stream_feats(keep, feats):
            i = self.seq2idx[k]
            if mat.shape[0] != self.lens[i]:
                raise ValueError(
                    f"len.scp disagrees with features for {k}: "
                    f"{self.lens[i]} vs {mat.shape[0]}"
                )
            if dest is None:
                self.dim = mat.shape[1]
                if cache is not None:
                    cache.parent.mkdir(parents=True, exist_ok=True)
                    dest = np.memmap(bin_path, dtype=np.float32, mode="w+",
                                     shape=(total, self.dim))
                else:
                    dest = np.empty((total, self.dim), dtype=np.float32)
                sums = np.zeros(self.dim, dtype=np.float64)
                sumsq = np.zeros(self.dim, dtype=np.float64)
            s = self.seq_starts[i]
            dest[s : s + mat.shape[0]] = mat
            if need_stats:
                sums += mat.sum(axis=0, dtype=np.float64)
                sumsq += (mat.astype(np.float64) ** 2).sum(axis=0)
        if dest is None:
            self.dim = 0
            dest = np.zeros((0, 0), dtype=np.float32)

        if mvn_path is not None:
            if mvn_path.exists():
                self.mvn_params = json.loads(mvn_path.read_text())
            else:
                n = max(float(total), 1.0)
                mean = sums / n if sums is not None else np.zeros((0,))
                var = sumsq / n - mean**2 if sumsq is not None else np.zeros((0,))
                std = np.sqrt(np.maximum(var, 1e-12))
                self.mvn_params = {"mean": [mean.tolist()], "std": [std.tolist()]}
                mvn_path.parent.mkdir(parents=True, exist_ok=True)
                mvn_path.write_text(json.dumps(self.mvn_params))
            self._apply_mvn_inplace(dest)

        self.data = dest
        if cache is not None and isinstance(dest, np.memmap):
            dest.flush()
            meta_path.write_text(json.dumps(
                {"keys": keep, "dim": self.dim, "total": total,
                 "mvn_params": self.mvn_params}
            ))
            self.data = np.memmap(bin_path, dtype=np.float32, mode="r",
                                  shape=(total, self.dim))

    @classmethod
    def from_arrays(
        cls,
        feats: dict[str, np.ndarray],
        mvn_params: dict | None = None,
        apply_mvn: bool = False,
    ) -> "FeatureStore":
        """Build a store directly from in-memory ``{key: [T, dim]}`` arrays —
        the manifest-less path for serving/encoding fresh audio and for
        synthetic benchmarks. ``apply_mvn`` normalizes with ``mvn_params``
        (stats are never computed here; pass the training run's)."""
        st = object.__new__(cls)
        st.seq_keys = list(feats)
        st.seq2idx = {k: i for i, k in enumerate(st.seq_keys)}
        st.lens = np.array([len(feats[k]) for k in st.seq_keys], dtype=np.int64)
        offsets = np.zeros(len(st.seq_keys) + 1, dtype=np.int64)
        np.cumsum(st.lens, out=offsets[1:])
        st.seq_starts = offsets[:-1].copy()
        st.dim = next(iter(feats.values())).shape[1] if feats else 0
        st.data = (
            np.concatenate([np.asarray(feats[k], np.float32) for k in st.seq_keys])
            if feats else np.zeros((0, 0), np.float32)
        )
        st.mvn_params = mvn_params
        if apply_mvn and mvn_params is not None:
            st._apply_mvn_inplace(st.data)
        return st

    # ---- MVN (reference datasets.py:100-136 semantics, JSON schema parity) --

    def _apply_mvn_inplace(self, dest: np.ndarray, chunk: int = 1 << 20) -> None:
        """Normalize ``dest`` in place, one bounded chunk at a time (the
        destination may be a memmap far larger than host RAM)."""
        mean = np.asarray(self.mvn_params["mean"], dtype=np.float32).reshape(1, -1)
        std = np.asarray(self.mvn_params["std"], dtype=np.float32).reshape(1, -1)
        for i in range(0, dest.shape[0], chunk):
            block = dest[i : i + chunk]
            np.subtract(block, mean, out=block)
            np.divide(block, std, out=block)

    def apply_mvn(self, feats: np.ndarray) -> np.ndarray:
        """Normalize external features with this store's MVN statistics."""
        if self.mvn_params is None:
            return feats
        mean = np.asarray(self.mvn_params["mean"], dtype=np.float32).reshape(1, -1)
        std = np.asarray(self.mvn_params["std"], dtype=np.float32).reshape(1, -1)
        return (feats - mean) / std

    def undo_mvn(self, feats: np.ndarray) -> np.ndarray:
        if self.mvn_params is None:
            return feats
        mean = np.asarray(self.mvn_params["mean"], dtype=np.float32).reshape(1, -1)
        std = np.asarray(self.mvn_params["std"], dtype=np.float32).reshape(1, -1)
        return feats * std + mean

    # ---- access ----

    @property
    def num_seqs(self) -> int:
        return len(self.seq_keys)

    def sequence(self, i: int) -> np.ndarray:
        s = self.seq_starts[i]
        return self.data[s : s + self.lens[i]]

    def gather_segments(self, seq_idx: np.ndarray, starts: np.ndarray, seg_len: int) -> np.ndarray:
        """Vectorized fetch of ``[B, seg_len, dim]`` segment features."""
        abs_starts = self.seq_starts[seq_idx] + starts
        idx = abs_starts[:, None] + np.arange(seg_len)[None, :]
        return self.data[idx]

    def subset(self, keys: Sequence[str],
               materialize: bool = False) -> "FeatureStore":
        """View restricted to ``keys`` (hierarchical sampling: each round
        trains against a sampled subset of sequences with local indices
        0..K-1; train_model.py:424-436 intent, B10 fixed).

        Default: zero-copy — ``data`` is the SHARED packed buffer and
        ``seq_starts`` index into it (round subsets of an already-staged
        pack read device memory directly). ``materialize=True`` instead gathers the
        subset's rows into a fresh CONTIGUOUS pack with local seq_starts —
        what per-round device staging needs when the full pack does not fit
        device memory (the round's sub-pack is uploaded each round)."""
        idx = np.asarray([self.seq2idx[k] for k in keys], dtype=np.int64)
        sub = object.__new__(FeatureStore)
        sub.seq_keys = list(keys)
        sub.seq2idx = {k: i for i, k in enumerate(keys)}
        sub.lens = self.lens[idx]
        sub.dim = self.dim
        if materialize:
            rows = int(sub.lens.sum())
            buf = np.empty((rows, self.dim), self.data.dtype)
            starts = np.zeros(len(idx), dtype=self.seq_starts.dtype)
            at = 0
            for j, i in enumerate(idx):
                n = int(self.lens[i])
                s = int(self.seq_starts[i])
                starts[j] = at
                buf[at : at + n] = self.data[s : s + n]
                at += n
            sub.data = buf
            sub.seq_starts = starts
        else:
            sub.data = self.data  # shared packed buffer
            sub.seq_starts = self.seq_starts[idx]
        sub.mvn_params = self.mvn_params
        return sub
