"""Chunked windowed-segment gather from a packed feature store.

Counterpart of ``pytorch_scalablefhvae_tpu/ops/window_gather_pallas.py``
(``windowed_chunk_gather``). :func:`windowed_chunk_gather` runs
``csrc/window_gather.cu`` for CUDA tensors and its plain version,
:func:`windowed_chunk_gather_reference`, for CPU tensors; the kernel's
launches are counted in ``windowed_chunk_gather.launches``, those on
bfloat16 rows in ``launches_bf16`` besides.

Chunk ``c`` covers the ``spb`` windows of ``seg_len`` rows that start at
``chunk_starts[c] + stride * w``; they lie in one contiguous region of
``(spb - 1) * stride + seg_len`` rows, which the kernel copies once. Rows
outside ``[0, N)`` read as zero in both versions. The staged store carries
``STORE_TAIL_SLACK`` zero rows past its last frame, so a region that runs
past the last sequence reads zeros either way, as the TPU kernel relied on.
The store is float32, or bfloat16 where the split was staged at
``--transfer-dtype bfloat16``; the kernel moves rows as bytes, 16 or 4 at a
time, so both take the same path (a bfloat16 row needs an even ``D``), and
the windows come back in the store's dtype.
"""

from __future__ import annotations

import torch

from pytorch_scalablefhvae_tpu_torch.ops import _build


DTYPES = (torch.float32, torch.bfloat16)


def _check(store, chunk_starts, spb, seg_len, stride):
    if store.dim() != 2 or store.dtype not in DTYPES:
        raise ValueError(f"the store must be a [N, D] float32 or bfloat16 "
                         f"tensor; got {store.dtype} {tuple(store.shape)}")
    if chunk_starts.dim() != 1 or chunk_starts.is_floating_point():
        raise ValueError(f"chunk_starts must be a 1-D integer tensor; got "
                         f"{chunk_starts.dtype} {tuple(chunk_starts.shape)}")
    if min(spb, seg_len, stride) < 1:
        raise ValueError(f"spb {spb}, seg_len {seg_len} and stride {stride} "
                         f"must be positive")


def windowed_chunk_gather_reference(store, chunk_starts, spb: int,
                                    seg_len: int, stride: int):
    """Plain version of :func:`windowed_chunk_gather`: one index tensor of
    every window row, rows outside the store zero."""
    _check(store, chunk_starts, spb, seg_len, stride)
    n, d = store.shape
    dev = store.device
    idx = (chunk_starts.to(dev, torch.long)[:, None, None]
           + stride * torch.arange(spb, device=dev)[None, :, None]
           + torch.arange(seg_len, device=dev)[None, None, :])
    if n == 0:
        out = store.new_zeros((*idx.shape, d))
    else:
        inside = (idx >= 0) & (idx < n)
        out = torch.where(inside[..., None], store[idx.clamp(0, n - 1)],
                          store.new_zeros(()))
    return out.reshape(-1, seg_len, d)


def windowed_chunk_gather(store, chunk_starts, spb: int, seg_len: int,
                          stride: int):
    """``[C * spb, seg_len, D]``: window ``w`` of chunk ``c`` is
    ``store[chunk_starts[c] + stride * w : ... + seg_len]``, rows outside
    the store zero, in the store's dtype. ``store [N, D]`` float32 or
    bfloat16, ``chunk_starts [C]`` integer.
    """
    if store.device.type == "cpu":
        return windowed_chunk_gather_reference(store, chunk_starts, spb,
                                               seg_len, stride)
    _check(store, chunk_starts, spb, seg_len, stride)
    dev = store.device
    if dev.type != "cuda":
        raise ValueError(f"windowed_chunk_gather runs on CUDA tensors, not "
                         f"{dev}")
    if not store.is_contiguous():
        raise ValueError("windowed_chunk_gather takes a contiguous store")
    if chunk_starts.device != dev:
        raise ValueError(f"chunk_starts is on {chunk_starts.device}, not {dev}")
    lib = _build.library()
    n, d = store.shape
    row_bytes = d * store.element_size()
    reg_bytes = ((spb - 1) * stride + seg_len) * row_bytes
    if reg_bytes > lib.sfhvae_window_gather_max_smem():
        raise ValueError(
            f"a chunk region of {reg_bytes} bytes exceeds the "
            f"{lib.sfhvae_window_gather_max_smem()} bytes of shared memory a "
            f"block may take; lower spb")
    starts32 = chunk_starts.to(torch.int32).contiguous()
    c = starts32.shape[0]
    out = torch.empty((c * spb, seg_len, d), device=dev, dtype=store.dtype)
    if c == 0:
        return out
    vec = copy_bytes(row_bytes, store.data_ptr(), out.data_ptr())
    code = lib.sfhvae_window_gather(
        store.data_ptr(), starts32.data_ptr(), out.data_ptr(), n, row_bytes,
        c, spb, seg_len, stride, vec,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "windowed_chunk_gather")
    windowed_chunk_gather.launches += 1
    if store.dtype == torch.bfloat16:
        windowed_chunk_gather.launches_bf16 += 1
    return out


windowed_chunk_gather.launches = 0
windowed_chunk_gather.launches_bf16 = 0


def copy_bytes(row_bytes: int, *ptrs: int) -> int:
    """The kernel's copy width: 16 or 4 bytes, the wider where it divides a
    row and every pointer. A row or an address that 4 does not divide (a
    bfloat16 row of an odd width, a view off a 4-byte boundary) raises."""
    for vec in (16, 4):
        if row_bytes % vec == 0 and all(p % vec == 0 for p in ptrs):
            return vec
    raise ValueError(
        f"windowed_chunk_gather copies 16 or 4 bytes at a time: a row of "
        f"{row_bytes} bytes at addresses {[p % 16 for p in ptrs]} mod 16 takes "
        f"neither (bfloat16 rows need an even width and a store on a 4-byte "
        f"boundary)")
