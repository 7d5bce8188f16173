"""Preprocessing orchestrator: corpus prep + per-split feature extraction.

Reference parity: ``preprocess_data(args) -> paths_dict``
(preprocess_data.py:14-73) — dispatches TIMIT vs LibriSpeech corpus prep,
extracts features for train/dev/test, and returns the per-split paths dict
with the same keys (``wav_pth``/``feat_pth``/``len_pth`` and ``feat_ark`` for
the kaldi format). Splits run sequentially here: extraction is in-process and
the host pipeline is I/O-bound, so the reference's ``Pool(3)`` adds nothing
on typical runners.

The port's own copy of the JAX package's ``features/pipeline.py``; ``device``
names the torch device of the ``jax`` extractor (``cuda`` or ``cpu``) and the
host extractors ignore it.
"""

from __future__ import annotations

from pathlib import Path

from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
from pytorch_scalablefhvae_tpu_torch.corpus.librispeech import process_librispeech
from pytorch_scalablefhvae_tpu_torch.corpus.synthetic import make_synthetic_corpus
from pytorch_scalablefhvae_tpu_torch.corpus.timit import process_timit
from pytorch_scalablefhvae_tpu_torch.features.extract import prepare_jax, prepare_kaldi, prepare_numpy

SPLITS = ("train", "dev", "test")


def dataset_directory(config: ExperimentConfig, root: str | Path = ".") -> Path:
    """Output dir name parity with reference utils.py:32-42."""
    return Path(root) / config.base_string()


def preprocess_data(
    config: ExperimentConfig,
    root: str | Path = ".",
    fbank_conf: str | Path = "./misc/fbank.conf",
    device: str = "cuda",
) -> dict[str, dict[str, Path]]:
    dcfg, fcfg = config.data, config.features
    out_dir = dataset_directory(config, root)

    if dcfg.dataset == "timit":
        if dcfg.raw_data_dir is None:
            raise ValueError("raw_data_dir is required to preprocess timit")
        process_timit(Path(dcfg.raw_data_dir).resolve(), out_dir)
    elif dcfg.dataset == "librispeech":
        if dcfg.raw_data_dir is None:
            raise ValueError("raw_data_dir is required to preprocess librispeech")
        process_librispeech(
            Path(dcfg.raw_data_dir).resolve(), out_dir, fcfg.data_format,
            dcfg.train_list, dcfg.dev_list, dcfg.test_list,
        )
    elif dcfg.dataset == "synthetic":
        make_synthetic_corpus(
            out_dir,
            num_speakers=dcfg.synthetic_speakers,
            utts_per_speaker=dcfg.synthetic_utts,
        )
    else:
        raise ValueError(f"Unknown dataset {dcfg.dataset!r}")

    paths: dict[str, dict[str, Path]] = {}
    for split in SPLITS:
        if fcfg.data_format == "numpy":
            prep = prepare_jax if fcfg.extractor == "jax" else prepare_numpy
            worker_kw = (
                # accelerator-batched already; route the fused-kernel choice
                {"fbank_pallas": getattr(fcfg, "fbank_pallas", "auto"),
                 "device": device}
                if fcfg.extractor == "jax"
                else {"num_workers": fcfg.num_workers}
            )
            _, (wav_pth, feat_pth, len_pth) = prep(
                dcfg.dataset, split, out_dir,
                ftype=fcfg.feat_type,
                **worker_kw,
                sample_rate=fcfg.sample_rate,
                win_t=fcfg.win_t,
                hop_t=fcfg.hop_t,
                n_mels=fcfg.n_mels,
                window=fcfg.window,
                preemphasis=fcfg.preemphasis,
                mel_norm=fcfg.mel_norm,
                log_floor_mel=fcfg.log_floor_mel,
                log_floor_spec=fcfg.log_floor_spec,
            )
            paths[split] = {"wav_pth": wav_pth, "feat_pth": feat_pth, "len_pth": len_pth}
        else:
            _, (_, feat_ark, feat_pth, len_pth) = prepare_kaldi(
                out_dir, split, fbank_conf, sample_rate=fcfg.sample_rate,
                dither_seed=fcfg.dither_seed, num_workers=fcfg.num_workers,
            )
            paths[split] = {
                "wav_pth": out_dir / split / "wav.scp",
                "feat_ark": feat_ark,
                "feat_pth": feat_pth,
                "len_pth": len_pth,
            }
    return paths


def split_manifests(config: ExperimentConfig, root: str | Path = ".") -> dict[str, dict[str, Path]]:
    """Locate manifests for an already-preprocessed dataset
    (train_model.py:347-370 parity)."""
    out_dir = dataset_directory(config, root)
    paths = {}
    for split in SPLITS:
        paths[split] = {
            "feat_pth": out_dir / split / "feats.scp",
            "len_pth": out_dir / split / "len.scp",
        }
    return paths
