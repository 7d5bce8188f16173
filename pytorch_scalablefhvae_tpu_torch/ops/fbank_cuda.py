"""Fused log-mel filterbank of raw frames.

Counterpart of ``pytorch_scalablefhvae_tpu/ops/fbank_pallas.py``
(``fused_logmel_frames``). :func:`fused_logmel_frames` runs
``csrc/fbank_logmel.cu`` for CUDA tensors and its plain version,
:func:`logmel_frames_reference`, for CPU tensors; the kernel's launches are
counted in ``fused_logmel_frames.launches``.

Per frame: analysis window, real DFT as two products against cos/sin bases,
magnitude, mel projection (a third product) and floored log, all float32.
The kernel keeps the windowed frame, the spectra and the magnitude on the
chip and writes only the ``[N, M]`` log-mel.

Inference only, as the TPU kernel was: feature extraction is never
differentiated, there is no backward kernel, and an input that requires a
gradient raises rather than silently training through zeros. The plain
version is ordinary torch ops and differentiates like any.
"""

from __future__ import annotations

import torch

from pytorch_scalablefhvae_tpu_torch.ops import _build


NAMES = ("frames", "window", "cos_basis", "sin_basis", "mel_fb_t")


def _check(*tensors):
    frames, _, cos_basis, _, mel_fb_t = tensors
    if frames.dim() != 2 or cos_basis.dim() != 2 or mel_fb_t.dim() != 2:
        raise ValueError(
            f"frames must be [N, n_fft], cos_basis [n_fft, K] and mel_fb_t "
            f"[K, M]; got {[tuple(t.shape) for t in tensors]}")
    n_fft, k = cos_basis.shape
    shapes = ((frames.shape[0], n_fft), (n_fft,), (n_fft, k), (n_fft, k),
              (k, mel_fb_t.shape[1]))
    for name, t, shape in zip(NAMES, tensors, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32; got {t.dtype}")
        if t.device != frames.device:
            raise ValueError(f"{name} is on {t.device}, frames on "
                             f"{frames.device}")


def logmel_frames_reference(frames, window, cos_basis, sin_basis, mel_fb_t,
                            log_floor: float = -20.0):
    """Plain version of :func:`fused_logmel_frames`: the same chain in torch
    ops (float32 products, no TF32; ``utils/device.py`` turns it off)."""
    _check(frames, window, cos_basis, sin_basis, mel_fb_t)
    f = frames * window[None, :]
    re = f @ cos_basis
    im = f @ sin_basis
    mag = torch.sqrt(re * re + im * im + 1e-30)
    mel = mag @ mel_fb_t
    return torch.log(mel.clamp(min=1e-38)).clamp(min=float(log_floor))


def fused_logmel_frames(frames, window, cos_basis, sin_basis, mel_fb_t,
                        log_floor: float = -20.0):
    """``[N, n_fft]`` raw (un-windowed) frames -> ``[N, M]`` floored log-mel.

    ``window [n_fft]`` (already centre-padded to n_fft), ``cos_basis`` /
    ``sin_basis [n_fft, K]`` real-DFT bases, ``mel_fb_t [K, M]`` the mel
    filterbank transposed, all float32 on the frames' device. CUDA tensors
    must be contiguous; a tile that needs more shared memory than a block
    may take (``n_fft + K`` over about 1,600 rows) raises.
    """
    tensors = (frames, window, cos_basis, sin_basis, mel_fb_t)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "fused_logmel_frames is inference-only: it has no backward "
            "kernel. Differentiate through logmel_frames_reference, or call "
            "it under torch.no_grad()")
    if frames.device.type == "cpu":
        return logmel_frames_reference(*tensors, log_floor)
    _check(*tensors)
    dev = frames.device
    if dev.type != "cuda":
        raise ValueError(f"fused_logmel_frames runs on CUDA tensors, not {dev}")
    for name, t in zip(NAMES, tensors):
        if not t.is_contiguous():
            raise ValueError(f"fused_logmel_frames takes a contiguous {name}")
    lib = _build.library()
    n, n_fft = frames.shape
    k, m = mel_fb_t.shape
    need = lib.sfhvae_fbank_logmel_smem(n_fft, k)
    if need > lib.sfhvae_fbank_logmel_max_smem():
        raise ValueError(
            f"n_fft {n_fft} with {k} bins needs {need} bytes of shared "
            f"memory a block, over the {lib.sfhvae_fbank_logmel_max_smem()} "
            f"a block may take")
    out = torch.empty((n, m), device=dev, dtype=torch.float32)
    if n == 0:
        return out
    code = lib.sfhvae_fbank_logmel(
        frames.data_ptr(), window.data_ptr(), cos_basis.data_ptr(),
        sin_basis.data_ptr(), mel_fb_t.data_ptr(), out.data_ptr(), n, n_fft,
        k, m, float(log_floor), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "fused_logmel_frames")
    fused_logmel_frames.launches += 1
    return out


fused_logmel_frames.launches = 0
