"""Feature-extraction drivers: wav.scp -> features + manifests.

Covers both reference backends with identical on-disk results:

- ``numpy`` backend (prepare_numpy_data.py:53-129): librosa-semantics fbank or
  spec per utterance, one ``.npy`` per utterance + ``feats.scp``/``len.scp``;
- ``kaldi`` backend (prepare_kaldi_data.py:10-82): Kaldi-semantics fbank per
  ``misc/fbank.conf`` written to a binary ``feats.ark`` + ``feats.scp`` +
  ``len.scp``. The extraction itself runs in-process — the native C++
  extractor when built (native/fbank.cc), else the NumPy mirror — instead of
  shelling out to an external Kaldi checkout.

The port's own copy of the JAX package's ``features/extract.py``;
``prepare_jax`` keeps its name (it serves the config value
``extractor: "jax"``) and runs the batched chain of ``features/dsp_torch.py``
on a torch device.
"""

from __future__ import annotations

import time
import zlib
from pathlib import Path

import numpy as np

from pytorch_scalablefhvae_tpu_torch.features import dsp_numpy
from pytorch_scalablefhvae_tpu_torch.features.kaldi_fbank import (
    fbank_kwargs_from_conf,
    kaldi_fbank,
    parse_fbank_conf,
)
from pytorch_scalablefhvae_tpu_torch.utils.audio_io import read_audio
from pytorch_scalablefhvae_tpu_torch.utils.kaldi_ark import ArkWriter
from pytorch_scalablefhvae_tpu_torch.utils.manifest import read_scp


def generate_feat(
    ftype: str,
    y: np.ndarray,
    sr: int,
    win_t: float = 0.025,
    hop_t: float = 0.010,
    n_mels: int = 80,
    window: str = "hamming",
    preemphasis: float = 0.97,
    mel_norm: str | None = "slaney",
    log_floor_mel: float = -20.0,
    log_floor_spec: float = -50.0,
) -> np.ndarray:
    """One utterance -> (frames, bins); reference generate_feat parity
    (prepare_numpy_data.py:14-50, n_fft = sr * win_t). Defaults match the
    reference; the extras expose FeatureConfig's full surface so the config
    never lies about what ran."""
    n_fft = int(sr * win_t)
    if ftype == "fbank":
        return dsp_numpy.log_melspec(
            y, sr, n_fft=n_fft, hop_t=hop_t, win_t=win_t, n_mels=n_mels,
            window=window, preemphasis=preemphasis, norm_mel=mel_norm,
            log_floor=log_floor_mel,
        )
    if ftype == "spec":
        return dsp_numpy.log_spectrogram(
            y, sr, n_fft=n_fft, hop_t=hop_t, win_t=win_t,
            window=window, preemphasis=preemphasis, log_floor=log_floor_spec,
        )
    raise ValueError(f"Unknown feature type {ftype!r}")


def _numpy_worker(job):
    """Pool worker: decode + featurize + save one utterance.

    Top-level (picklable); returns (seq, npy_path, n_frames, sr) so the
    parent writes manifests in order. ``expect_sr`` is the split's locked
    sample rate (established by the parent from the first utterance):
    mismatches raise BEFORE featurizing/saving, matching the sequential
    path's behavior — no wrong-rate ``.npy`` ever reaches disk.
    """
    seq, path, np_path, ftype, sample_rate, expect_sr, win_t, hop_t, n_mels, kw = job
    y, sr = read_audio(path, sample_rate)
    if expect_sr is not None and sr != expect_sr:
        raise ValueError(f"Inconsistent sample rate ({expect_sr} != {sr}).")
    feat = generate_feat(ftype, y, sr, win_t, hop_t, n_mels, **kw)
    with open(np_path, "wb") as nf:
        np.save(nf, feat)
    return seq, np_path, len(feat), sr


def prepare_numpy(
    dataset: str,
    set_name: str,
    dataset_dir: str | Path,
    output_dir: str | Path | None = None,
    ftype: str = "fbank",
    sample_rate: int | None = None,
    win_t: float = 0.025,
    hop_t: float = 0.010,
    n_mels: int = 80,
    verbose: bool = True,
    num_workers: int = 0,
    **feat_kwargs,
) -> tuple[int, tuple[Path, Path, Path]]:
    """NumPy-backend extraction for one split; returns
    (count, (wav_scp, feats_scp, len_scp)) like the reference.

    ``num_workers > 1`` fans the per-utterance decode+FFT+mel work over a
    process pool (the capability of the reference's ``Pool(3)``,
    preprocess_data.py:45 — but over utterances, which load-balances;
    extraction is CPU-bound in the FFT on multi-core hosts). The default
    stays sequential: on a single-core host a pool only adds
    serialization overhead.
    """
    set_path = Path(output_dir or dataset_dir) / set_name
    wav_path = set_path / "wav.scp"
    feat_path = set_path / "feats.scp"
    len_path = set_path / "len.scp"
    if not wav_path.exists():
        raise ValueError(f"The wav.scp file at {wav_path} does not exist!")
    set_path.mkdir(parents=True, exist_ok=True)

    start = time.time()
    count = 0
    locked_sr = sample_rate
    entries = read_scp(wav_path).items()
    entries = list(entries)
    if num_workers and num_workers > 1 and entries:
        import multiprocessing as mp

        with open(feat_path, "w") as ff, open(len_path, "w") as lf:
            # first utterance runs in-process to LOCK the split's sample
            # rate before any worker featurizes (the sequential path's
            # raise-before-compute semantics)
            seq, np_path, n_frames, sr = _numpy_worker(
                (entries[0][0], entries[0][1],
                 set_path / f"{entries[0][0]}.npy", ftype, sample_rate,
                 locked_sr, win_t, hop_t, n_mels, feat_kwargs))
            if locked_sr is None:
                locked_sr = sr
            ff.write(f"{seq} {np_path}\n")
            lf.write(f"{seq} {n_frames}\n")
            count += 1
            jobs = [
                (seq, path, set_path / f"{seq}.npy", ftype, sample_rate,
                 locked_sr, win_t, hop_t, n_mels, feat_kwargs)
                for seq, path in entries[1:]
            ]
            with mp.Pool(num_workers) as pool:
                # imap preserves manifest order
                for seq, np_path, n_frames, sr in pool.imap(
                        _numpy_worker, jobs, chunksize=8):
                    ff.write(f"{seq} {np_path}\n")
                    lf.write(f"{seq} {n_frames}\n")
                    count += 1
    else:
        # sequential path runs the SAME worker body per entry (one
        # decode/featurize/save definition; the first utterance locks the
        # split's sample rate exactly as in the pool branch)
        with open(feat_path, "w") as ff, open(len_path, "w") as lf:
            for seq, path in entries:
                seq, np_path, n_frames, sr = _numpy_worker(
                    (seq, path, set_path / f"{seq}.npy", ftype, sample_rate,
                     locked_sr, win_t, hop_t, n_mels, feat_kwargs))
                if locked_sr is None:
                    locked_sr = sr
                ff.write(f"{seq} {np_path}\n")
                lf.write(f"{seq} {n_frames}\n")
                count += 1
    if verbose:
        print(f"{set_name}: {count} utterances in {time.time() - start:.2f}s (numpy/{ftype})")
    return count, (wav_path, feat_path, len_path)


def prepare_jax(
    dataset: str,
    set_name: str,
    dataset_dir: str | Path,
    output_dir: str | Path | None = None,
    ftype: str = "fbank",
    sample_rate: int | None = None,
    win_t: float = 0.025,
    hop_t: float = 0.010,
    n_mels: int = 80,
    batch_size: int = 32,
    verbose: bool = True,
    buffer_samples: int = 64 * 1024 * 1024,
    device: str = "cuda",
    **feat_kwargs,
) -> tuple[int, tuple[Path, Path, Path]]:
    """Accelerator-backed batched extraction (same outputs as prepare_numpy).

    Streams utterances in length-sorted batches through the batched
    STFT+mel chain (features/dsp_torch.py) on ``device``: signals are padded
    into a small set of bucketed shapes, on a CUDA device the log-mel runs in
    the fused kernel (ops/fbank_cuda.py), and results are written back
    as the standard per-utterance ``.npy`` + manifests. This is the
    "streaming feature extraction" path for corpus-scale preprocessing: host
    memory is bounded by ``buffer_samples`` of decoded audio (default ~256 MB
    float32) regardless of split size — audio decodes into a macro-chunk,
    each chunk is length-sorted and batch-extracted, and every result writes
    to disk before the next chunk loads (LibriSpeech-960 would otherwise
    need ~220 GB of decoded audio + ~110 GB of features resident at once).
    """
    from pytorch_scalablefhvae_tpu_torch.features.dsp_torch import (
        featurize_signals,
    )

    set_path = Path(output_dir or dataset_dir) / set_name
    wav_path = set_path / "wav.scp"
    feat_path = set_path / "feats.scp"
    len_path = set_path / "len.scp"
    if not wav_path.exists():
        raise ValueError(f"The wav.scp file at {wav_path} does not exist!")
    set_path.mkdir(parents=True, exist_ok=True)

    entries = list(read_scp(wav_path).items())
    start = time.time()
    locked_sr = sample_rate
    frame_counts: dict[str, int] = {}  # small: one int per utterance

    def write_one(seq: str, feat: np.ndarray) -> None:
        with open(set_path / f"{seq}.npy", "wb") as nf:
            np.save(nf, feat)
        frame_counts[seq] = len(feat)

    def flush_chunk(loaded: dict[str, np.ndarray]) -> None:
        # each result is written as its batch completes (the sink), so peak
        # memory is the chunk's audio + one batch of features
        featurize_signals(loaded, locked_sr, ftype=ftype, win_t=win_t,
                          hop_t=hop_t, n_mels=n_mels, batch_size=batch_size,
                          sink=write_one, device=device, **feat_kwargs)
        loaded.clear()

    pending: dict[str, np.ndarray] = {}
    pending_samples = 0
    for seq, path in entries:
        y, sr = read_audio(path, sample_rate)
        if locked_sr is None:
            locked_sr = sr
        elif locked_sr != sr:
            raise ValueError(f"Inconsistent sample rate ({locked_sr} != {sr}).")
        pending[seq] = y
        pending_samples += len(y)
        if pending_samples >= buffer_samples:
            flush_chunk(pending)
            pending_samples = 0
    if pending:
        flush_chunk(pending)

    count = 0
    with open(feat_path, "w") as ff, open(len_path, "w") as lf:
        for seq, _ in entries:  # preserve manifest order
            ff.write(f"{seq} {set_path / f'{seq}.npy'}\n")
            lf.write(f"{seq} {frame_counts[seq]}\n")
            count += 1
    if verbose:
        print(f"{set_name}: {count} utterances in {time.time() - start:.2f}s (jax/{ftype})")
    return count, (wav_path, feat_path, len_path)


_NATIVE_FBANK_CACHE: object = "unset"  # per-process memo, incl. failures


def _native_fbank():
    """Return the C++ extractor entry point if the shared lib builds+loads.

    ``load_native()`` is invoked HERE (the build runs lazily at first load,
    not at import), so a failed g++ compile or a missing toolchain falls
    back to the Python Kaldi mirror instead of crashing prepare_kaldi.
    The outcome — INCLUDING failure — is memoized per process: the pool
    path calls this per utterance, and an unmemoized broken toolchain
    would re-spawn the failing g++ subprocess for every job."""
    global _NATIVE_FBANK_CACHE
    if _NATIVE_FBANK_CACHE != "unset":
        return _NATIVE_FBANK_CACHE
    try:
        from pytorch_scalablefhvae_tpu_torch.native.binding import (
            load_native,
            native_fbank,
        )

        load_native()
        _NATIVE_FBANK_CACHE = native_fbank
    except Exception:
        _NATIVE_FBANK_CACHE = None
    return _NATIVE_FBANK_CACHE


def _kaldi_worker(job):
    """Pool worker: decode + Kaldi-semantics fbank for one utterance.

    Returns the feature matrix; the parent serializes ark writes (one
    archive). The native extractor loads lazily per process.
    """
    seq, path, sample_rate, conf_kwargs, seed, use_native = job
    y, sr = read_audio(path, sample_rate)
    conf_sr = conf_kwargs.get("sr")
    if conf_sr is not None and int(conf_sr) != int(sr):
        raise ValueError(
            f"Sample rate mismatch for '{seq}': fbank conf expects "
            f"{conf_sr} Hz but {path} is {sr} Hz"
        )
    kwargs = dict(conf_kwargs)
    kwargs.setdefault("sr", sr)
    native = _native_fbank() if use_native else None
    if native is not None:
        return seq, native(y, seed=seed, **kwargs)
    return seq, kaldi_fbank(y, seed=seed, **kwargs)


def prepare_kaldi(
    dataset_dir: str | Path,
    set_name: str,
    fbank_conf: str | Path = "./misc/fbank.conf",
    kaldi_root: str | Path | None = None,  # accepted for CLI parity; unused
    sample_rate: int | None = None,
    verbose: bool = True,
    use_native: bool = True,
    dither_seed: int = 0,
    num_workers: int = 0,
) -> tuple[int, tuple[Path, Path, Path, Path]]:
    """Kaldi-backend extraction for one split; returns
    (count, (dataset_dir, feats_ark, feats_scp, len_scp)) like the reference
    (prepare_kaldi_data.py:82).

    ``num_workers > 1`` fans decode+fbank over a process pool (reference
    ``Pool(3)`` capability, prepare_kaldi_data.py:124); the single ark is
    written by the parent in manifest order, so outputs are byte-identical
    to the sequential path (per-utterance dither streams are seeded by key).
    """
    set_dir = Path(dataset_dir) / set_name
    wav_scp = set_dir / "wav.scp"
    feat_ark = set_dir / "feats.ark"
    feat_scp = set_dir / "feats.scp"
    len_scp = set_dir / "len.scp"
    if not wav_scp.exists():
        raise ValueError(f"The wav.scp file at {wav_scp} does not exist!")

    conf_kwargs = fbank_kwargs_from_conf(parse_fbank_conf(str(fbank_conf)))

    if num_workers and num_workers > 1:
        import multiprocessing as mp

        jobs = [
            (seq, path, sample_rate, conf_kwargs,
             (zlib.crc32(seq.encode()) + dither_seed) % (2**31), use_native)
            for seq, path in read_scp(wav_scp).items()
        ]
        start = time.time()
        count = 0
        with mp.Pool(num_workers) as pool, \
                ArkWriter(feat_ark, feat_scp) as writer, \
                open(len_scp, "w") as lf:
            for seq, feat in pool.imap(_kaldi_worker, jobs, chunksize=8):
                writer.write(seq, feat)
                lf.write(f"{seq} {len(feat)}\n")
                count += 1
                if verbose and count % 200 == 0:
                    print(f"{set_name.capitalize():7} processed {count} "
                          f"utterances in {time.time() - start:.2f} seconds")
        if verbose:
            print(f"{set_name.capitalize()} feature computation completed in "
                  f"{time.time() - start:.2f} seconds")
        return count, (Path(dataset_dir), feat_ark, feat_scp, len_scp)

    native = _native_fbank() if use_native else None

    start = time.time()
    count = 0
    with ArkWriter(feat_ark, feat_scp) as writer, open(len_scp, "w") as lf:
        conf_sr = conf_kwargs.get("sr")
        for seq, path in read_scp(wav_scp).items():
            y, sr = read_audio(path, sample_rate)
            if conf_sr is not None and int(conf_sr) != int(sr):
                # Kaldi parity: compute-fbank-feats errors out on a
                # sample-frequency mismatch rather than silently computing
                # wrong frame/mel geometry
                raise ValueError(
                    f"Sample rate mismatch for '{seq}': fbank conf expects "
                    f"{conf_sr} Hz but {path} is {sr} Hz; resample the audio "
                    f"or fix --sample-frequency in the conf"
                )
            kwargs = dict(conf_kwargs)
            kwargs.setdefault("sr", sr)
            # per-utterance deterministic dither stream: stable across
            # interpreter runs (Python's hash() is salted per process)
            seed = (zlib.crc32(seq.encode()) + dither_seed) % (2**31)
            if native is not None:
                feat = native(y, seed=seed, **kwargs)
            else:
                feat = kaldi_fbank(y, seed=seed, **kwargs)
            writer.write(seq, feat)
            lf.write(f"{seq} {len(feat)}\n")
            count += 1
            if verbose and count % 200 == 0:
                print(f"{set_name.capitalize():7} processed {count} utterances "
                      f"in {time.time() - start:.2f} seconds")
    if verbose:
        print(f"{set_name.capitalize()} feature computation completed in "
              f"{time.time() - start:.2f} seconds")
    return count, (Path(dataset_dir), feat_ark, feat_scp, len_scp)
