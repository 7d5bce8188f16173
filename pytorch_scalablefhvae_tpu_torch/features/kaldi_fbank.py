"""Kaldi-semantics log-mel fbank extraction (NumPy mirror of the C++ path).

The reference shells out to Kaldi's C++ ``compute-fbank-feats`` configured by
``misc/fbank.conf`` (prepare_kaldi_data.py:38-46): hamming window, no energy,
16 kHz, dither 1, 80 mel bins, htk-compat. This module is the canonical spec
of that pipeline for this framework; ``native/fbank.cc`` implements the same
algorithm in C++ for the fast host path, and the two are tested for bit-level
agreement.

Kaldi semantics reproduced (kaldi/src/feat/feature-window.{h,cc} and
feature-fbank.cc behavior):

- waveform in int16 sample units (Kaldi does not normalize to [-1, 1]);
- snip_edges framing: ``n_frames = (len - win) // hop + 1``, frame ``t``
  starts at ``t * hop``;
- per-frame processing order: dither -> DC-offset removal -> (energy) ->
  pre-emphasis within the frame -> symmetric window;
- zero-pad to the next power of two, power spectrum ``|X|^2``;
- HTK-scale triangular mel bins (low 20 Hz, high = Nyquist), peak height 1;
- ``log(max(mel_energy, eps_float32))``.

``htk_compat`` only repositions the energy coefficient; with
``use_energy=false`` (the conf) it does not change the output.

Deviation from Kaldi (documented): dither uses a *seeded* generator so
extraction is reproducible; pass ``dither=0`` for determinism-by-construction.
"""

from __future__ import annotations

import numpy as np

from pytorch_scalablefhvae_tpu_torch.features.mel import kaldi_mel_bins

_EPS_F32 = float(np.finfo(np.float32).eps)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def symmetric_window(name: str, length: int) -> np.ndarray:
    n = np.arange(length, dtype=np.float64)
    a = 2.0 * np.pi / (length - 1)
    if name == "hamming":
        return 0.54 - 0.46 * np.cos(a * n)
    if name in ("hanning", "hann"):  # accept both aliases: one config
        # field feeds both the Kaldi and the numpy/jax pipelines
        return 0.5 - 0.5 * np.cos(a * n)
    if name == "povey":
        return (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    if name == "rectangular":
        return np.ones(length)
    if name == "blackman":
        return 0.42 - 0.5 * np.cos(a * n) + 0.08 * np.cos(2.0 * a * n)
    raise ValueError(f"Unsupported Kaldi window type {name!r}")


def kaldi_fbank(
    y: np.ndarray,
    sr: int = 16000,
    *,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    n_mels: int = 80,
    window_type: str = "hamming",
    dither: float = 1.0,
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
    use_power: bool = True,
    use_log_fbank: bool = True,
    round_to_power_of_two: bool = True,
    input_scale: float = 32768.0,
    seed: int | None = 0,
) -> np.ndarray:
    """Compute Kaldi-parity fbank features, shape (n_frames, n_mels).

    ``y`` is float in [-1, 1] (this framework's canonical audio form); it is
    rescaled by ``input_scale`` to Kaldi's int16 units before processing.
    """
    y = np.asarray(y, dtype=np.float64) * input_scale
    win = int(sr * frame_length_ms / 1000.0)
    hop = int(sr * frame_shift_ms / 1000.0)
    n_frames = (len(y) - win) // hop + 1
    if n_frames <= 0:
        return np.zeros((0, n_mels), dtype=np.float32)
    n_fft = next_pow2(win) if round_to_power_of_two else win

    starts = np.arange(n_frames) * hop
    frames = y[starts[:, None] + np.arange(win)[None, :]]

    if dither != 0.0:
        rng = np.random.default_rng(seed)
        frames = frames + dither * rng.standard_normal(frames.shape)

    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)

    if preemphasis != 0.0:
        pre = np.empty_like(frames)
        pre[:, 1:] = frames[:, 1:] - preemphasis * frames[:, :-1]
        pre[:, 0] = frames[:, 0] - preemphasis * frames[:, 0]
        frames = pre

    frames = frames * symmetric_window(window_type, win)[None, :]

    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    power = np.abs(spec) ** 2 if use_power else np.abs(spec)

    bins = kaldi_mel_bins(sr, n_fft, n_mels=n_mels, low_freq=low_freq, high_freq=high_freq)
    mel = power @ bins.T.astype(np.float64)

    if use_log_fbank:
        mel = np.log(np.maximum(mel, _EPS_F32))
    return mel.astype(np.float32)


def parse_fbank_conf(path: str) -> dict:
    """Parse a Kaldi-style ``--key=value`` conf file (misc/fbank.conf)."""
    opts: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if not line.startswith("--"):
                raise ValueError(f"Malformed conf line: {line!r}")
            key, _, val = line[2:].partition("=")
            opts[key.replace("-", "_")] = val
    return opts


# conf options kaldi_fbank implements, plus the accepted-and-inert ones.
# Anything else RAISES: silently dropping e.g. --snip-edges=false (which
# changes the framing geometry) would extract with different semantics
# than the conf on disk claims, the exact drift the conf exists to prevent.
_CONF_SUPPORTED = {
    "window_type", "sample_frequency", "dither", "num_mel_bins",
    "frame_length", "frame_shift", "low_freq", "high_freq",
    "preemphasis_coefficient", "remove_dc_offset", "use_energy",
    "htk_compat",  # no output effect when use-energy=false
}


def fbank_kwargs_from_conf(conf: dict) -> dict:
    """Map parsed conf options onto :func:`kaldi_fbank` keyword args.

    Unsupported options raise (see ``_CONF_SUPPORTED``) — a conf setting
    this extractor cannot honor must fail loudly, not produce features
    that silently differ from what the conf requests.
    """
    def as_bool(v):
        return str(v).lower() in ("true", "1", "yes")

    unsupported = sorted(set(conf) - _CONF_SUPPORTED)
    if unsupported:
        raise NotImplementedError(
            f"fbank conf options not supported by this extractor: "
            f"{unsupported} (supported: {sorted(_CONF_SUPPORTED)})")
    mapping = {}
    if "window_type" in conf:
        mapping["window_type"] = conf["window_type"]
    if "sample_frequency" in conf:
        mapping["sr"] = int(float(conf["sample_frequency"]))
    if "dither" in conf:
        mapping["dither"] = float(conf["dither"])
    if "num_mel_bins" in conf:
        mapping["n_mels"] = int(conf["num_mel_bins"])
    if "frame_length" in conf:
        mapping["frame_length_ms"] = float(conf["frame_length"])
    if "frame_shift" in conf:
        mapping["frame_shift_ms"] = float(conf["frame_shift"])
    if "low_freq" in conf:
        mapping["low_freq"] = float(conf["low_freq"])
    if "high_freq" in conf:
        mapping["high_freq"] = float(conf["high_freq"])
    if "preemphasis_coefficient" in conf:
        mapping["preemphasis"] = float(conf["preemphasis_coefficient"])
    if "remove_dc_offset" in conf:
        mapping["remove_dc_offset"] = as_bool(conf["remove_dc_offset"])
    if "use_energy" in conf and as_bool(conf["use_energy"]):
        raise NotImplementedError("use-energy=true is not supported (conf uses false)")
    # htk-compat has no output effect when use-energy=false; accept and ignore.
    return mapping
