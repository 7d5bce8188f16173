"""A hierarchical round's rows gathered from the host store into the staged
buffer.

No counterpart in the JAX package, whose loop materialises each round's
sub-pack on the host and uploads it (its ``train/loop.py``).
:func:`host_store` holds a packed store's rows for the gather: on a GPU it
page-locks them and maps them into the device's address space, once per
array for as long as the array lives (a memory-mapped store, whose file
pages CUDA may refuse to lock, is first copied into host memory).
:func:`stage_gather` then runs ``csrc/stage_gather.cu`` for a CUDA buffer,
which reads the rows over the host link, and its plain version,
:func:`stage_gather_reference`, for a CPU buffer; the kernel's launches are
counted in ``stage_gather.launches``.

A run ``(src, dst, n)`` of the ``[R, 3]`` int64 runs table copies store rows
``[src, src + n)`` to buffer rows ``[dst, dst + n)``: float32 as they are,
bfloat16 rounded to nearest even, the bits of ``data/device_store.py``
``host_rows``. The runs must lie inside the store and the buffer
(``data/device_store.py`` ``gather_runs`` makes them so); rows of the buffer
that no run names are left as they are.
"""

from __future__ import annotations

import ctypes
import warnings
import weakref
from typing import NamedTuple

import numpy as np
import torch

from pytorch_scalablefhvae_tpu_torch.ops import _build

DTYPES = (torch.float32, torch.bfloat16)

# id of a held array -> its HostStore: a process-wide cache, as the
# registration is, that lives as long as the array (its finalizer)
_held: dict = {}


class NotMapped(Exception):
    """The store cannot be held for the gather; the message says why."""


class HostStore(NamedTuple):
    """A packed ``[rows, D]`` float32 store held for :func:`stage_gather`:
    ``rows``, a CPU tensor over the held rows (on a GPU, page-locked), and
    ``ptr``, the device address of those rows where they are mapped (0 on
    the CPU)."""

    rows: torch.Tensor
    ptr: int


def lockable(data: np.ndarray) -> np.ndarray:
    """``data``'s rows in memory that can be page-locked: the array itself,
    or, for a memory-mapped store (an H100 host refuses to page-lock a
    file's pages: CUDA error 801), a copy of it in host memory. Raises
    :class:`NotMapped` where the copy does not fit in host memory."""
    if not isinstance(data, np.memmap):
        return data
    try:
        rows = np.empty(data.shape, np.float32)
        np.copyto(rows, data)
    except MemoryError as e:
        raise NotMapped(f"copying the {data.nbytes / 1e9:.2f} GB "
                        f"memory-mapped store into host memory failed: "
                        f"{e}") from e
    return rows


def host_store(data: np.ndarray, device: torch.device) -> HostStore:
    """``data`` held for gathers into a buffer on ``device``: on a GPU its
    rows (:func:`lockable`) page-locked and mapped (read-only where the
    array is), once for as long as ``data`` lives, so later calls over the
    same array pay nothing. Raises :class:`NotMapped` for an array that is
    not a C-contiguous 2-D float32 array, for a device other than the CPU
    or a GPU, and where the rows cannot be held (not enough host memory to
    copy or page-lock them)."""
    device = torch.device(device)
    if not (isinstance(data, np.ndarray) and data.dtype == np.float32
            and data.ndim == 2 and data.flags.c_contiguous):
        raise NotMapped(
            f"the store is not a C-contiguous [rows, D] float32 array "
            f"({type(data).__name__} {getattr(data, 'dtype', None)})")
    if device.type == "cpu" or data.size == 0:
        with warnings.catch_warnings():
            # a memory-mapped store is read-only, and only read here
            warnings.simplefilter("ignore", UserWarning)
            return HostStore(torch.from_numpy(data), 0)
    if device.type != "cuda":
        raise NotMapped(f"the gather runs on CUDA or CPU buffers, not "
                        f"{device}")
    key = id(data)
    held = _held.get(key)
    if held is None:
        rows = lockable(data)
        lib = _build.library()
        out = ctypes.c_void_p()
        with torch.cuda.device(device):
            code = lib.sfhvae_host_register(
                rows.ctypes.data, rows.nbytes, int(not rows.flags.writeable),
                ctypes.byref(out))
        if code != 0:
            msg = lib.sfhvae_cuda_error_string(code).decode()
            raise NotMapped(f"page-locking the {rows.nbytes / 1e9:.2f} GB "
                            f"store failed: CUDA error {code} ({msg})")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            held = _held[key] = HostStore(torch.from_numpy(rows), out.value)
        # the process's exit releases it; at the array's end, unregister
        # before numpy frees the rows (a copy lives in the cache until then)
        weakref.finalize(data, _release, key,
                         rows.ctypes.data).atexit = False
    return held


def _release(key: int, host_ptr: int) -> None:
    _build.library().sfhvae_host_unregister(host_ptr)
    _held.pop(key, None)


def _check(host: HostStore, runs: torch.Tensor, out: torch.Tensor) -> None:
    if out.dim() != 2 or out.dtype not in DTYPES or not out.is_contiguous():
        raise ValueError(f"the buffer must be a contiguous [N, D] float32 or "
                         f"bfloat16 tensor; got {out.dtype} "
                         f"{tuple(out.shape)}")
    if out.shape[1] != host.rows.shape[1]:
        raise ValueError(f"the buffer's rows are {out.shape[1]} wide, the "
                         f"store's {host.rows.shape[1]}")
    if (runs.dim() != 2 or runs.shape[1] != 3 or runs.dtype != torch.long
            or runs.device != out.device):
        raise ValueError(f"runs must be an [R, 3] int64 tensor on the "
                         f"buffer's device {out.device}; got {runs.dtype} "
                         f"{tuple(runs.shape)} on {runs.device}")


def stage_gather_reference(host: HostStore, runs: torch.Tensor,
                           out: torch.Tensor) -> None:
    """Plain version of :func:`stage_gather`: one slice copy a run, through
    the CPU (rows converted there as ``host_rows`` converts them)."""
    _check(host, runs, out)
    for src, dst, n in runs.tolist():
        out[dst:dst + n].copy_(host.rows[src:src + n].to(out.dtype))


def stage_gather(host: HostStore, runs: torch.Tensor,
                 out: torch.Tensor) -> None:
    """``out[dst:dst + n] = store[src:src + n]`` for each run ``(src, dst,
    n)`` of ``runs [R, 3]`` (int64, on ``out``'s device), in ``out``'s dtype
    (float32 or bfloat16), on the current stream: one launch reads the rows
    over the host link from the mapped store ``host``
    (:func:`host_store`)."""
    if out.device.type == "cpu":
        stage_gather_reference(host, runs, out)
        return
    _check(host, runs, out)
    n_runs, dim = runs.shape[0], out.shape[1]
    if n_runs == 0:
        return
    dev = out.device
    if dev.type != "cuda" or not host.ptr:
        raise ValueError(f"stage_gather runs on a CUDA buffer from a mapped "
                         f"store; got {dev} and a store "
                         f"{'mapped' if host.ptr else 'not mapped'}")
    runs = runs.contiguous()
    vec = 4 if (dim % 4 == 0 and host.ptr % 16 == 0
                and out.data_ptr() % (4 * out.element_size()) == 0) else 1
    code = _build.library().sfhvae_stage_gather(
        host.ptr, runs.data_ptr(), n_runs, out.data_ptr(), dim,
        int(out.dtype == torch.bfloat16), vec,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "stage_gather")
    stage_gather.launches += 1


stage_gather.launches = 0
