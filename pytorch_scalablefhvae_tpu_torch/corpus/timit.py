"""TIMIT corpus preparation.

Walks the raw TIMIT tree, partitions by speaker lists, converts
SPHERE-headered ``.WAV`` files to RIFF WAV, and emits per-split ``wav.scp``
manifests keyed ``<spk>_<utt>`` — capability parity with the reference
(preprocess_timit.py:9-66), with its defects fixed: parent directories are
created for the scp *files* (B13), and the default speaker lists ship in
``misc/`` (they were referenced but missing in the reference repo).
"""

from __future__ import annotations

import os
from pathlib import Path

from pytorch_scalablefhvae_tpu_torch.utils.audio_io import is_sphere, read_sphere, write_wav

def _spk_list(name: str) -> Path:
    """Resolve a speaker list: the repo's ``misc/`` when running from a
    checkout (reference-layout parity), else the copy shipped inside the
    package (so non-editable installs work too)."""
    repo = Path(__file__).resolve().parents[2] / "misc" / name
    if repo.exists():
        return repo
    return Path(__file__).resolve().parent / "data" / name


DEFAULT_DEV_SPK = _spk_list("timit_dev_spk.list")
DEFAULT_TEST_SPK = _spk_list("timit_test_spk.list")


def process_timit(
    raw_data_dir: str | Path,
    output_dir: str | Path,
    dev_spk_path: str | Path = DEFAULT_DEV_SPK,
    test_spk_path: str | Path = DEFAULT_TEST_SPK,
) -> dict[str, Path]:
    """Generate train/dev/test ``wav.scp`` files for TIMIT.

    Speakers in the dev/test lists go to those splits; all other speakers
    (conventionally the 462-speaker training partition) go to train.
    """
    raw_data_dir = Path(raw_data_dir)
    output_dir = Path(output_dir)

    with open(dev_spk_path) as f:
        dt_spks = {line.strip().lower() for line in f if line.strip()}
    with open(test_spk_path) as f:
        tt_spks = {line.strip().lower() for line in f if line.strip()}

    wav_dir = output_dir / "wav"
    wav_dir.mkdir(parents=True, exist_ok=True)
    scps = {se: output_dir / se / "wav.scp" for se in ("train", "dev", "test")}
    for p in scps.values():
        p.parent.mkdir(parents=True, exist_ok=True)  # B13: parent, not the file

    handles = {se: open(p, "w") for se, p in scps.items()}
    try:
        for root, _, fnames in sorted(os.walk(raw_data_dir)):
            spk = Path(root).name.lower()
            if spk in dt_spks:
                split = "dev"
            elif spk in tt_spks:
                split = "test"
            else:
                split = "train"
            for fname in sorted(fnames):
                if not fname.lower().endswith(".wav"):
                    continue
                src = Path(root) / fname
                uttid = f"{spk}_{os.path.splitext(fname)[0]}"
                dst = wav_dir / f"{spk}_{fname}"
                if is_sphere(src):
                    y, sr = read_sphere(src)
                    write_wav(dst, y, sr)
                else:  # already RIFF; reference always rewrote — copy suffices
                    dst.write_bytes(src.read_bytes())
                handles[split].write(f"{uttid} {dst}\n")
    finally:
        for h in handles.values():
            h.close()

    print("Converted to wav and dumped .scp files")
    return scps
