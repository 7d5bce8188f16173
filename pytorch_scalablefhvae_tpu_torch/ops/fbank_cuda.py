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

import functools

import torch

from pytorch_scalablefhvae_tpu_torch.ops import _build


NAMES = ("frames", "window", "cos_basis", "sin_basis", "mel_fb_t")
TILE_ROWS = (64, 32, 16)  # the kernel's block sizes in frames, tallest first
ROW_STEP = 8              # a tile's height is a multiple of this


def logmel_geometry(N: int, n_sms: int,
                    max_rows: int = TILE_ROWS[0]) -> tuple[int, int]:
    """``(rows, blocks)``: the frames of a kernel tile for ``N`` frames on a
    card of ``n_sms`` SMs, and the number of tiles. The tiles fill the
    fewest waves of ``n_sms`` blocks that ``max_rows``-frame tiles would
    (``max_rows``: the tallest block whose shared memory this ``n_fft``
    takes), each as short as those waves allow, in steps of 8 frames: the
    busiest SM gets the fewest frames a whole number of waves can give it.
    A frame's bits do not depend on the choice."""
    waves = -(-max(N, 1) // (max_rows * n_sms))
    per_block = -(-max(N, 1) // (waves * n_sms))
    rows = min(max_rows, -(-per_block // ROW_STEP) * ROW_STEP)
    return rows, -(-max(N, 1) // rows)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    must be contiguous; a shape whose 16-frame block needs more shared
    memory than a block may take (at ``n_fft // 2 + 1`` bins, an ``n_fft``
    over 1,088) raises.
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
    rows = logmel_rows(frames.shape[0], dev, *cos_basis.shape,
                       mel_fb_t.shape[1])
    # the kernel takes the frames, the bases and the bank in by bulk copies
    # from 16-byte boundaries: a view that starts off one is copied first
    tensors = tuple(t if i == 1 or t.data_ptr() % 16 == 0 else t.clone()
                    for i, t in enumerate(tensors))
    out = _launch(*tensors, log_floor, rows)
    if frames.shape[0]:
        fused_logmel_frames.launches += 1
    return out


def logmel_rows(N: int, dev: torch.device, n_fft: int = 400, K: int = 201,
                M: int = 80) -> int:
    """The tile height :func:`fused_logmel_frames` launches ``N`` frames
    with: :func:`logmel_geometry` on this device, within the tallest tile
    whose shared memory and threads a block may take; raises if none
    fits (a 16-frame block's shared memory runs out before its threads)."""
    lib = _build.library()
    limit = lib.sfhvae_fbank_logmel_max_smem()
    fits = [r for r in TILE_ROWS
            if lib.sfhvae_fbank_logmel_threads(K, r) > 0
            and lib.sfhvae_fbank_logmel_smem(n_fft, K, M, r) <= limit]
    if not fits:
        need = lib.sfhvae_fbank_logmel_smem(n_fft, K, M, TILE_ROWS[-1])
        raise ValueError(
            f"n_fft {n_fft} with {K} bins needs {need} bytes of shared "
            f"memory a block, over the {limit} a block may take")
    return logmel_geometry(N, _sm_count(dev.index or 0), fits[0])[0]


def _launch(frames, window, cos_basis, sin_basis, mel_fb_t, log_floor, rows):
    """Launch ``csrc/fbank_logmel.cu`` with tiles of ``rows`` frames on
    checked CUDA tensors (uncounted: the entry counts its own)."""
    lib = _build.library()
    n, n_fft = frames.shape
    k, m = mel_fb_t.shape
    out = torch.empty((n, m), device=frames.device, dtype=torch.float32)
    if n == 0:
        return out
    code = lib.sfhvae_fbank_logmel(
        frames.data_ptr(), window.data_ptr(), cos_basis.data_ptr(),
        sin_basis.data_ptr(), mel_fb_t.data_ptr(), out.data_ptr(), n, n_fft,
        k, m, float(log_floor), rows,
        torch.cuda.current_stream(frames.device).cuda_stream)
    _build.check(code, "fused_logmel_frames")
    return out


fused_logmel_frames.launches = 0
