"""LibriSpeech corpus preparation.

Recursively discovers ``.flac`` (or ``.wav``) audio under the configured
subset directories and emits per-split ``wav.scp`` manifests — capability
parity with the reference (preprocess_librispeech.py:13-112), with B17 fixed
(test split defaults to test-clean + test-other).

Unlike the reference, FLAC files are *not* eagerly transcoded: the feature
extractor decodes on the fly (utils/audio_io.py). Pass ``convert=True`` to
pre-convert to WAV (the reference's behavior for the Kaldi path,
preprocess_librispeech.py:57-70).
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path

from pytorch_scalablefhvae_tpu_torch.utils.audio_io import read_flac, write_wav

DEFAULT_TRAIN = ("train-clean-100",)
DEFAULT_DEV = ("dev-clean", "dev-other")
DEFAULT_TEST = ("test-clean", "test-other")


def find_audios(directory: Path, exts=(".flac", ".wav")) -> list[tuple[str, str]]:
    """Sorted (utt_id, path) pairs for audio files under ``directory``
    (preprocess_librispeech.py:13-28 parity).

    One path per utterance id: a ``convert=True`` run writes a ``.wav``
    next to each ``.flac``, so a later run finds BOTH under the same uid —
    without dedup the scp would list every utterance twice (doubling the
    split count and letting directory order pick which line wins
    downstream). The ``.wav`` wins deterministically (it is the already-
    decoded product of the flac beside it)."""
    by_uid: dict[str, str] = {}
    for root, _, files in sorted(os.walk(directory)):
        for file in files:
            if not file.lower().endswith(tuple(exts)):
                continue
            uid = os.path.splitext(file)[0]
            path = os.path.join(root, file)
            prev = by_uid.get(uid)
            if prev is None or (prev.lower().endswith(".flac")
                                and path.lower().endswith(".wav")):
                by_uid[uid] = path
    return sorted(by_uid.items(), key=lambda x: x[0])


def write_split_scp(
    root_dir: Path, out_path: Path, subset_list, convert: bool = False
) -> int:
    out_path.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with open(out_path, "w") as f:
        for subset in subset_list:
            subset_dir = root_dir / subset
            if not subset_dir.exists():
                # a typo'd or unmounted subset must not silently produce an
                # empty manifest that only fails later as an obscure
                # empty-dataset error
                warnings.warn(
                    f"LibriSpeech subset directory {subset_dir} does not "
                    f"exist; skipping it"
                )
                continue
            for uid, path in find_audios(subset_dir):
                if convert and path.lower().endswith(".flac"):
                    y, sr = read_flac(path)
                    path = os.path.splitext(path)[0] + ".wav"
                    write_wav(path, y, sr)
                f.write(f"{uid} {path}\n")
                n += 1
    return n


def process_librispeech(
    raw_data_dir: str | Path,
    output_dir: str | Path,
    data_format: str = "numpy",
    train_list=None,
    dev_list=None,
    test_list=None,
) -> dict[str, Path]:
    """Generate train/dev/test ``wav.scp`` files for LibriSpeech."""
    raw_data_dir = Path(raw_data_dir)
    output_dir = Path(output_dir)
    train_list = tuple(train_list) if train_list else DEFAULT_TRAIN
    dev_list = tuple(dev_list) if dev_list else DEFAULT_DEV
    test_list = tuple(test_list) if test_list else DEFAULT_TEST

    print("Generating scp files...")
    convert = data_format == "kaldi"  # Kaldi path expects WAV input
    scps = {}
    for split, subsets in (("train", train_list), ("dev", dev_list), ("test", test_list)):
        scp = output_dir / split / "wav.scp"
        n = write_split_scp(raw_data_dir, scp, subsets, convert=convert)
        if n == 0:
            raise ValueError(
                f"LibriSpeech split '{split}' has zero utterances: none of "
                f"the subsets {subsets} under {raw_data_dir} contained audio"
            )
        print(f"  {split}: {n} utterances from {subsets}")
        scps[split] = scp
    print("Generated scp files")
    return scps
