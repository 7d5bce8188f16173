"""On-device DSP path: batched STFT + mel projection in torch.

Counterpart of ``pytorch_scalablefhvae_tpu/features/dsp_jax.py`` and what the
config value ``extractor: "jax"`` runs in this package. Numerically
equivalent to :mod:`dsp_numpy` (the librosa-semantics path of reference
utils.py:155-272), batched over utterances: ``[B, T]`` -> ``[B, F, n_bins]``.

- callers pad signals to a common length and pass the true lengths; frames
  beyond a signal's own count come back zero;
- the centred reflect pad is one gather over the extended signal, the
  framing an ``unfold`` view of it made contiguous (``[B, F, n_fft]``,
  ``n_fft / hop`` times the signal's bytes);
- the fbank + log configuration goes through
  ``ops/fbank_cuda.fused_logmel_frames``: on a CUDA device the hand-written
  kernel (window, DFT, magnitude, mel and log without a round trip to device
  memory), on the CPU its plain version. ``feat_type="spec"``, ``log=False``
  and ``use_fft=True`` are plain torch ops (``torch.fft.rfft`` for the last).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pytorch_scalablefhvae_tpu_torch.features.dsp_numpy import periodic_window
from pytorch_scalablefhvae_tpu_torch.features.mel import mel_filterbank
from pytorch_scalablefhvae_tpu_torch.ops.fbank_cuda import fused_logmel_frames
from pytorch_scalablefhvae_tpu_torch.utils.device import resolve_device


def _rdft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin matrices of shape (n_fft, n_fft // 2 + 1), float32."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _spectral_consts(sr: int, n_fft: int, win: int, window: str,
                     n_mels: int, norm_mel: str | None, need_mel: bool,
                     device: torch.device):
    """Device-resident window / DFT bases / mel filterbank, cached per
    configuration and device: uploaded once and reused by every batch (the
    same tensors go to every caller; nothing writes to them).

    Returns ``(w [n_fft], C [n_fft, K], S [n_fft, K], fb [M, K], fb_t
    [K, M])``, float32; ``fb_t`` is the contiguous transpose the fused kernel
    reads. The spec path gets an empty ``[0, K]`` bank.
    """
    w = periodic_window(window, win)
    if win < n_fft:
        lpad = (n_fft - win) // 2
        w = np.pad(w, (lpad, n_fft - win - lpad))
    C, S = _rdft_matrices(n_fft)
    if need_mel:
        fb = np.asarray(
            mel_filterbank(sr, n_fft, n_mels=n_mels, htk=False, norm=norm_mel),
            np.float32)
    else:
        fb = np.zeros((0, n_fft // 2 + 1), np.float32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return put(w), put(C), put(S), put(fb), put(fb.T)


def batched_features(
    y,
    lengths,
    *,
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
    feat_type: str = "fbank",
    use_fft: bool = False,
    fbank_pallas: str = "auto",
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compute fbank/spec features for a padded batch of signals.

    Args:
        y: ``[B, T_max]`` float32 padded signals (array or tensor).
        lengths: ``[B]`` integer true signal lengths.
        device: ``"cuda"`` (raises without a GPU) or ``"cpu"``.

    Returns:
        feats: ``[B, F_max, n_bins]`` on ``device`` (frames beyond a signal's
            frame count are zero), and ``n_frames``: ``[B]`` int32 per-signal
            frame counts (librosa centered convention: ``1 + length // hop``).

    ``fbank_pallas``: "never" | "always" | "auto", the saved runs' name for
    the fused log-mel kernel's gate (ops/fbank_cuda.py). It applies to the
    fbank+log non-FFT configuration only. ``auto`` and ``always`` launch the
    kernel on a CUDA device and run its plain version on the CPU; ``never``
    names the plain chain, which a CUDA device refuses: there is no knob
    that picks the plain chain on the card.
    """
    if feat_type not in ("fbank", "spec"):
        raise ValueError(f"Unknown feat_type {feat_type!r}")
    if fbank_pallas not in ("never", "always", "auto"):
        raise ValueError(f"Unknown fbank_pallas {fbank_pallas!r}")
    dev = resolve_device(device)
    fused = bool(feat_type == "fbank" and log and not use_fft)
    if fused and fbank_pallas == "never" and dev.type == "cuda":
        raise NotImplementedError(
            "--fbank-pallas never: on --device cuda the jax extractor always "
            "runs the fused log-mel kernel; its plain version runs on "
            "--device cpu")
    win = int(sr * win_t)
    w, C, S, fb, fb_t = _spectral_consts(
        sr, n_fft, win, window, n_mels, norm_mel, feat_type == "fbank", dev)

    with torch.no_grad():
        y = torch.as_tensor(y, dtype=torch.float32).to(dev)
        lengths = torch.as_tensor(lengths).to(dev, torch.long)
        B, T = y.shape
        hop = int(sr * hop_t)
        pad = n_fft // 2

        # pre-emphasis (reference utils.py:181-182)
        if preemphasis > 1e-12:
            y = y - preemphasis * torch.nn.functional.pad(y[:, :-1], (1, 0))
        # zero out beyond true length UNCONDITIONALLY: the reflect gather and
        # the short-row constant extension below both read the [len, T) tail
        # and must see zeros, not whatever the batch assembly padded with
        L = lengths[:, None]
        y = torch.where(torch.arange(T, device=dev)[None, :] < L, y,
                        y.new_zeros(()))

        # librosa centered frame count: 1 + (L + 2*(n_fft//2) - n_fft) // hop.
        # For even n_fft this is 1 + L // hop; for odd n_fft the pad is one
        # sample short of n_fft, giving 1 + (L - 1) // hop — the host
        # (dsp_numpy reflect) path computes exactly this, and the two
        # extractors must emit identical len.scp counts
        extra = 2 * pad - n_fft  # 0 (even n_fft) or -1 (odd)
        n_frames_max = 1 + (T + extra) // hop
        n_frames = 1 + torch.div(lengths + extra, hop, rounding_mode="floor")

        # centered reflect pad: one reflection around each signal's *true*
        # end, then clip, as a per-row gather over the extended signal
        i = (torch.arange(T + 2 * pad, device=dev)[None, :] - pad).abs()
        i = torch.where(i > L - 1, 2 * (L - 1) - i, i).clamp(0, T - 1)
        y_ext = torch.gather(y, 1, i)  # [B, T + 2 * pad]
        # rows shorter than the pad need MULTIPLE reflections, which the
        # single-fold-then-clip above turns into edge replication; the host
        # path (dsp_numpy.stft_complex) zero-pads such degenerate signals
        # instead, and the two extractors must emit identical features. y is
        # already zero-masked beyond each row's length, so the constant
        # extension is a plain pad
        y_ext = torch.where(L <= pad,
                            torch.nn.functional.pad(y, (pad, pad)), y_ext)

        # frame f = y_ext[f*hop : f*hop + n_fft]: a strided view, n_frames_max
        # of them
        frames = y_ext.unfold(1, n_fft, hop)  # [B, n_frames_max, n_fft]
        frame_mask = (torch.arange(n_frames_max, device=dev)[None, :]
                      < n_frames[:, None])[:, :, None]

        if fused:
            out = fused_logmel_frames(
                frames.reshape(B * n_frames_max, n_fft), w, C, S, fb_t,
                log_floor=log_floor,
            ).reshape(B, n_frames_max, fb.shape[0])
            out = torch.where(frame_mask, out, out.new_zeros(()))
            return out, n_frames.to(torch.int32)

        frames = frames * w[None, None, :]
        if use_fft:
            spec = torch.fft.rfft(frames, n=n_fft, dim=-1).abs()
        else:
            re = frames @ C
            im = frames @ S
            spec = torch.sqrt(re * re + im * im + 1e-30)
        out = spec @ fb.T if feat_type == "fbank" else spec
        if log:
            out = torch.log(out.clamp(min=1e-38)).clamp(min=float(log_floor))
        out = torch.where(frame_mask, out, out.new_zeros(()))
        return out, n_frames.to(torch.int32)


def featurize_signals(
    signals: dict[str, "np.ndarray"],
    sr: int,
    *,
    ftype: str = "fbank",
    win_t: float = 0.025,
    hop_t: float = 0.010,
    n_mels: int = 80,
    batch_size: int = 32,
    window: str = "hamming",
    preemphasis: float = 0.97,
    mel_norm: str | None = "slaney",
    log_floor_mel: float = -20.0,
    log_floor_spec: float = -50.0,
    fbank_pallas: str = "auto",
    device: str | torch.device = "cuda",
    sink=None,
) -> dict[str, "np.ndarray"]:
    """Batched featurization of in-memory signals -> ``{key: [T, dim]}``.

    The single shared implementation of the bucketing/padding loop used by
    both preprocessing (extract.prepare_jax) and serving (eval/encode), with
    the same defaults as the host path (generate_feat), so train-time and
    serve-time features cannot drift. Utterances are length-sorted and
    padded into pow2 buckets from 16,384 samples, so a corpus runs at a
    handful of shapes. Each batch ends on one copy of its features to the
    host.

    ``sink``: optional ``(key, feat) -> None`` callback; when given, each
    result is handed off as its batch completes and nothing accumulates
    (the streaming-extraction path: peak memory is one batch of features,
    not the chunk). Returns ``{}`` in that mode.
    """
    dev = resolve_device(device)
    order = sorted(signals, key=lambda k: len(signals[k]))
    out: dict[str, np.ndarray] = {}
    i = 0
    while i < len(order):
        keys = order[i : i + batch_size]
        i += batch_size
        T = 16384
        while T < max(len(signals[k]) for k in keys):
            T *= 2
        batch = np.zeros((len(keys), T), np.float32)
        lengths = np.zeros(len(keys), np.int32)
        for j, k in enumerate(keys):
            batch[j, : len(signals[k])] = signals[k]
            lengths[j] = len(signals[k])
        feats, n_frames = batched_features(
            batch, lengths, sr=sr, n_fft=int(sr * win_t),
            hop_t=hop_t, win_t=win_t, n_mels=n_mels, feat_type=ftype,
            window=window, preemphasis=preemphasis, norm_mel=mel_norm,
            log_floor=log_floor_mel if ftype == "fbank" else log_floor_spec,
            fbank_pallas=fbank_pallas, device=dev,
        )
        n_frames = n_frames.cpu().numpy()
        feats = feats.cpu().numpy()
        for j, k in enumerate(keys):
            # a copy: the batch's buffer is not kept alive by one utterance
            feat = feats[j, : n_frames[j]].astype(np.float32)
            if sink is not None:
                sink(k, feat)
            else:
                out[k] = feat
    return out
