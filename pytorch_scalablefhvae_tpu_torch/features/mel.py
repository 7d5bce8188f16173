"""Mel filterbank construction (Slaney and HTK variants).

The reference obtained Slaney-normalized filterbanks from
``librosa.feature.melspectrogram(..., norm="slaney")`` (utils.py:261-268) and
HTK-scale banks from Kaldi (misc/fbank.conf). Both variants are implemented
here from the published formulas so either feature path can be reproduced
without those dependencies.
"""

from __future__ import annotations

import numpy as np

# Slaney auditory-toolbox mel scale (librosa htk=False default).
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP  # = 15.0
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel_slaney(f):
    f = np.asanyarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mel = np.where(log_region, _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP, mel)
    return mel


def mel_to_hz_slaney(m):
    m = np.asanyarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    f = np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)
    return f


def hz_to_mel_htk(f):
    return 1127.0 * np.log1p(np.asanyarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (np.exp(np.asanyarray(m, dtype=np.float64) / 1127.0) - 1.0)


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
    norm: str | None = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank of shape (n_mels, 1 + n_fft // 2).

    With ``htk=False, norm="slaney"`` this matches ``librosa.filters.mel``
    numerically (the semantics used at reference utils.py:261-268).
    """
    if fmax is None:
        fmax = sr / 2.0
    to_mel, to_hz = (hz_to_mel_htk, mel_to_hz_htk) if htk else (hz_to_mel_slaney, mel_to_hz_slaney)

    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2)
    hz_pts = to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"Unsupported mel norm {norm!r}")
    return weights.astype(dtype)


def kaldi_mel_bins(
    sr: int,
    n_fft: int,
    n_mels: int = 80,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi-style HTK-scale mel bins of shape (n_mels, n_fft // 2 + 1).

    Kaldi computes triangle weights in *mel* space on FFT-bin center
    frequencies (kaldi/src/feat/mel-computations.cc semantics), with
    ``high_freq <= 0`` meaning an offset from Nyquist. Peak value of each
    triangle is 1 (no area normalization).
    """
    nyquist = sr / 2.0
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    mel_low = hz_to_mel_htk(low_freq)
    mel_high = hz_to_mel_htk(high_freq)
    mel_delta = (mel_high - mel_low) / (n_mels + 1)

    fftfreqs = np.arange(n_fft // 2 + 1) * (sr / n_fft)
    mel_freqs = hz_to_mel_htk(fftfreqs)

    weights = np.zeros((n_mels, n_fft // 2 + 1), dtype=np.float64)
    for m in range(n_mels):
        left = mel_low + m * mel_delta
        center = mel_low + (m + 1) * mel_delta
        right = mel_low + (m + 2) * mel_delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        weights[m] = np.clip(np.minimum(up, down), 0.0, None)
    return weights.astype(np.float32)
