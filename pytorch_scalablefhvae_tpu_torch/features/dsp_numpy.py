"""Host (NumPy) DSP path: STFT, log-spectrogram, log-mel fbank, energy VAD.

Functionally equivalent to the reference's ``AudioUtils`` (utils.py:155-300),
which delegated to librosa. Semantics reproduced here:

- pre-emphasis ``y[t] = x[t] - r * x[t-1]`` with ``y[0] = x[0]``
  (utils.py:181-182);
- librosa-style centered STFT: the signal is reflect-padded by ``n_fft // 2``
  on both sides, framed at ``hop`` with a periodic window zero-padded to
  ``n_fft`` (librosa.core.stft defaults, utils.py:185-187);
- log-magnitude spectrogram with a -50 floor applied after the log
  (utils.py:219-223);
- log-mel with Slaney-normalized filters and a -20 floor (utils.py:257-272);
- energy VAD with threshold ``th_ratio * mean(rms)`` (utils.py:274-300; the
  reference called the removed ``librosa.feature.rmse`` — defect B16 — so the
  RMS is computed directly here).

Output layout: (frames, bins) — already transposed for the segment pipeline
(the reference transposed after the fact, prepare_numpy_data.py:35-49).
"""

from __future__ import annotations

import numpy as np

from pytorch_scalablefhvae_tpu_torch.features.mel import mel_filterbank


def periodic_window(name: str, length: int) -> np.ndarray:
    """Periodic (DFT-even) window, matching scipy ``fftbins=True``."""
    n = np.arange(length, dtype=np.float64)
    if name == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / length)
    if name in ("hann", "hanning"):  # one config field feeds both the
        # numpy/jax and the Kaldi-semantics pipelines, so both aliases work
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)
    if name in ("rect", "rectangular", "boxcar", "none"):
        return np.ones(length)
    if name == "povey":
        # Kaldi's default window (used by the kaldi-semantics path)
        return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))) ** 0.85
    raise ValueError(f"Unsupported window {name!r}")


def preemphasize(y: np.ndarray, coeff: float = 0.97) -> np.ndarray:
    if coeff <= 1e-12:
        return np.asarray(y, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    return y - coeff * np.concatenate([[0.0], y[:-1]])


def frame_signal(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Slice a 1-D signal into overlapping frames, shape (n_frames, frame_length)."""
    n_frames = 1 + (len(y) - frame_length) // hop_length
    if n_frames <= 0:
        return np.zeros((0, frame_length), dtype=y.dtype)
    stride = y.strides[0]
    return np.lib.stride_tricks.as_strided(
        y, shape=(n_frames, frame_length), strides=(hop_length * stride, stride)
    ).copy()


def stft_complex(
    y: np.ndarray,
    sr: int,
    n_fft: int = 400,
    hop_t: float = 0.010,
    win_t: float = 0.025,
    window: str = "hamming",
    preemphasis: float = 0.97,
    center: bool = True,
) -> np.ndarray:
    """Complex STFT, shape (n_frames, 1 + n_fft // 2)."""
    hop = int(sr * hop_t)
    win = int(sr * win_t)
    y = preemphasize(y, preemphasis)
    if center:
        pad = n_fft // 2
        if len(y) <= pad:  # degenerate short signal: zero-pad reflect base
            y = np.pad(y, (pad, pad), mode="constant")
        else:
            y = np.pad(y, (pad, pad), mode="reflect")
    w = periodic_window(window, win)
    if win < n_fft:  # center-pad window to n_fft (librosa util.pad_center)
        lpad = (n_fft - win) // 2
        w = np.pad(w, (lpad, n_fft - win - lpad))
    frames = frame_signal(y, n_fft, hop)
    return np.fft.rfft(frames * w[None, :], n=n_fft, axis=1)


def stft_mag(
    y: np.ndarray,
    sr: int,
    n_fft: int = 400,
    hop_t: float = 0.010,
    win_t: float = 0.025,
    window: str = "hamming",
    preemphasis: float = 0.97,
    center: bool = True,
) -> np.ndarray:
    """Magnitude STFT, shape (n_frames, 1 + n_fft // 2)."""
    return np.abs(
        stft_complex(y, sr, n_fft, hop_t, win_t, window, preemphasis, center)
    )


def log_spectrogram(
    y: np.ndarray,
    sr: int,
    n_fft: int = 400,
    hop_t: float = 0.010,
    win_t: float = 0.025,
    window: str = "hamming",
    preemphasis: float = 0.97,
    log: bool = True,
    log_floor: float = -50.0,
) -> np.ndarray:
    """(Log-)magnitude spectrogram; reference ``AudioUtils.rstft`` parity."""
    spec = stft_mag(y, sr, n_fft, hop_t, win_t, window, preemphasis)
    if log:
        with np.errstate(divide="ignore"):
            spec = np.log(spec)
        spec[spec < log_floor] = log_floor
    return spec.astype(np.float32)


def log_melspec(
    y: np.ndarray,
    sr: int,
    n_fft: int = 400,
    hop_t: float = 0.010,
    win_t: float = 0.025,
    window: str = "hamming",
    preemphasis: float = 0.97,
    n_mels: int = 80,
    log: bool = True,
    norm_mel: str | None = "slaney",
    log_floor: float = -20.0,
) -> np.ndarray:
    """Log-mel filterbank features; reference ``AudioUtils.to_melspec`` parity.

    Note: the reference passes a *magnitude* (power=1) spectrogram into
    ``librosa.feature.melspectrogram`` via ``S=`` (utils.py:257-268), so the
    mel projection is applied to magnitudes, not power — reproduced here.
    """
    spec = stft_mag(y, sr, n_fft, hop_t, win_t, window, preemphasis)
    fb = mel_filterbank(sr, n_fft, n_mels=n_mels, htk=False, norm=norm_mel, dtype=np.float64)
    mel = spec @ fb.T
    if log:
        with np.errstate(divide="ignore"):
            mel = np.log(mel)
        mel[mel < log_floor] = log_floor
    return mel.astype(np.float32)


def energy_vad(
    y: np.ndarray,
    sr: int,
    hop_t: float = 0.010,
    win_t: float = 0.025,
    th_ratio: float = 1.04 / 2,
) -> np.ndarray:
    """RMS-energy voice-activity detection (fixes reference defect B16)."""
    hop = int(sr * hop_t)
    win = int(sr * win_t)
    pad = win // 2
    yp = np.pad(np.asarray(y, dtype=np.float64), (pad, pad), mode="constant")
    frames = frame_signal(yp, win, hop)
    e = np.sqrt(np.mean(frames**2, axis=1))
    th = th_ratio * np.mean(e)
    return (e > th).astype(np.int64)
