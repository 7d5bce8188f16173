"""Synthetic test corpus generator.

Generates a tiny deterministic WAV corpus (per-"speaker" harmonic tones +
noise) with train/dev/test ``wav.scp`` manifests, used by the integration
tests and the benchmark when no real corpus is mounted (SURVEY.md §4:
"integration: tiny synthetic corpus → preprocess → train").
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pytorch_scalablefhvae_tpu_torch.utils.audio_io import write_wav
from pytorch_scalablefhvae_tpu_torch.utils.manifest import write_scp


def make_synthetic_corpus(
    output_dir: str | Path,
    num_speakers: int = 4,
    utts_per_speaker: int = 3,
    sr: int = 16000,
    min_seconds: float = 0.4,
    max_seconds: float = 0.9,
    seed: int = 0,
) -> dict[str, Path]:
    """Create WAVs + manifests; returns per-split wav.scp paths."""
    output_dir = Path(output_dir)
    rng = np.random.default_rng(seed)
    wav_dir = output_dir / "wav"
    wav_dir.mkdir(parents=True, exist_ok=True)

    # Factorized generation so the two latents have distinct ground truth:
    # - "content": a shared inventory of phone-like formant pairs; each
    #   utterance is a random sequence of them (varies within an utterance);
    # - "speaker": a voice drawn ONCE per speaker from a seeded per-speaker
    #   stream — fundamental frequency, spectral tilt, and a vocal-tract
    #   length warp on the formants — constant across the speaker's
    #   utterances (the sequence-level factor z2 should capture). Drawing
    #   the three dimensions independently keeps voices separable at large
    #   speaker counts (the quality harness runs 64 speakers, chance 1/64)
    #   without the old linear f0 ramp marching past Nyquist.
    n_phones = 10
    phone_formants = [
        (rng.uniform(300, 900), rng.uniform(1200, 2600)) for _ in range(n_phones)
    ]

    def voice(speaker: int) -> tuple[float, float, float]:
        vr = np.random.default_rng(100003 * seed + 17 * speaker + 1)
        return (
            float(vr.uniform(85.0, 255.0)),  # f0
            float(vr.uniform(0.5, 0.85)),    # per-harmonic amplitude decay
            float(vr.uniform(0.85, 1.2)),    # vocal-tract length warp
        )

    def render(speaker: int, dur: float) -> np.ndarray:
        f0_s, tilt, warp = voice(speaker)
        f0 = f0_s + rng.uniform(-2, 2)
        n = int(sr * dur)
        t = np.arange(n) / sr
        y = np.zeros(n)
        pos = 0
        while pos < n:
            seg_n = int(sr * rng.uniform(0.12, 0.3))
            f1, f2 = phone_formants[rng.integers(0, n_phones)]
            sl = slice(pos, min(pos + seg_n, n))
            ts = t[sl]
            seg = np.zeros(len(ts))
            for h in range(1, 24):
                fh = f0 * h
                if fh > sr / 2 - 200:
                    break
                # source-filter: harmonic source shaped by two formant
                # peaks, warped by the speaker's vocal-tract length factor
                gain = tilt**h * (
                    1.0 / (1.0 + ((fh - f1 * warp) / 180.0) ** 2)
                    + 0.6 / (1.0 + ((fh - f2 * warp) / 260.0) ** 2)
                )
                seg += gain * np.sin(2 * np.pi * fh * ts + rng.uniform(0, np.pi))
            env = np.hanning(len(seg)) ** 0.3  # soften segment boundaries
            y[sl] += seg * env
            pos += seg_n
        y += 0.01 * rng.standard_normal(n)
        return (0.8 * y / np.max(np.abs(y))).astype(np.float32)

    entries: dict[str, dict[str, str]] = {"train": {}, "dev": {}, "test": {}}
    for s in range(num_speakers):
        for u in range(utts_per_speaker):
            y = render(s, rng.uniform(min_seconds, max_seconds))
            uttid = f"spk{s}_utt{u}"
            path = wav_dir / f"{uttid}.wav"
            write_wav(path, y, sr)
            split = "train" if u < utts_per_speaker - 2 else ("dev" if u == utts_per_speaker - 2 else "test")
            if utts_per_speaker < 3:
                split = "train"
            entries[split][uttid] = str(path)

    scps = {}
    for split, d in entries.items():
        scps[split] = write_scp(output_dir / split / "wav.scp", d)
    return scps
