"""Per-column affine uint8 quantization for staged feature stores.

Wire format for the ``transfer_dtype="int8"`` staging tier: a feature block
``x [rows, dim]`` ships as ``q [rows, dim] uint8`` plus per-column
``scale [dim]`` / ``offset [dim]`` float32, with

    x_hat = q * scale + offset,   q = round((x - offset) / scale)

where ``offset = col_min`` and ``scale = (col_max - col_min) / 255``. This is
the same compression family Kaldi ships fbank features in on disk
(``CompressedMatrix``: per-column affine byte codes — the reference's own
Kaldi toolchain emits it via compress=true ark options; see
reference prepare_kaldi_data.py:38-46 for where those arks originate),
applied here to the host->device link instead of the filesystem: 4x fewer
wire bytes than float32, 2x fewer than bfloat16. On a link-bound rig the
streaming tier's throughput scales directly with wire bytes (SCALING.md,
"the wire is the wall"), so int8 is the fastest staging dtype this framework
offers.

Accuracy: log-mel features after MVN span a few sigma per column; 255 levels
put the worst-case rounding error at ``scale/2`` — about 1-2% of a column's
range, comparable to the dither the extractors already inject
(misc/fbank.conf dither=1). The dequantized values are BIT-DETERMINISTIC
given the block, so equivalence tests can replay the exact same training
trajectory through the host path by dequantizing on the host
(tests/test_stream_data.py).

Columns are quantized independently (per-mel-bin dynamic range varies ~20 dB
across the bank); a degenerate column (max == min) gets scale 0 and
reconstructs exactly.
"""

from __future__ import annotations

import numpy as np


def quantize_columns(x: np.ndarray, block_rows: int = 1 << 20,
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quantize ``x [rows, dim]`` to (q uint8, scale f32 [dim], offset f32 [dim]).

    ``rows == 0`` is allowed (empty blocks quantize to empty q, zero params).

    Runs in ``block_rows`` row blocks with float32 arithmetic throughout:
    the whole-pack caller (data/device_store.py) quantizes corpora that may
    only exist as a memmap, so the transient footprint must stay O(block)
    beyond the uint8 output — a single full-width float temporary (let alone
    the float64 ones a naive ``(x - lo) / scale`` upcasts to) would dwarf
    the pack itself at exactly the scale this tier targets. The quant params
    are computed in (and applied as) the same float32 the device step
    dequantizes with, so host and device reconstructions stay bit-identical.
    """
    x = np.asarray(x)
    if x.size == 0:
        dim = x.shape[1] if x.ndim == 2 else 0
        return (np.zeros(x.shape, np.uint8), np.zeros(dim, np.float32),
                np.zeros(dim, np.float32))
    rows, dim = x.shape
    lo = np.full(dim, np.inf, np.float32)
    hi = np.full(dim, -np.inf, np.float32)
    for b in range(0, rows, block_rows):
        blk = np.asarray(x[b : b + block_rows], dtype=np.float32)
        np.minimum(lo, blk.min(axis=0), out=lo)
        np.maximum(hi, blk.max(axis=0), out=hi)
    scale = (hi - lo) / np.float32(255.0)
    # degenerate columns (constant value): scale 0, q 0, offset reconstructs
    safe = np.where(scale > 0, scale, np.float32(1.0))
    q = np.empty((rows, dim), np.uint8)
    for b in range(0, rows, block_rows):
        # astype always copies: tmp is mutated in place and must never
        # alias the caller's pack
        tmp = x[b : b + block_rows].astype(np.float32)
        tmp -= lo
        tmp /= safe
        np.rint(tmp, out=tmp)
        np.clip(tmp, 0, 255, out=tmp)
        q[b : b + block_rows] = tmp.astype(np.uint8)
    q[:, scale <= 0] = 0
    return q, scale.astype(np.float32), lo.astype(np.float32)


def dequantize(q: np.ndarray, scale: np.ndarray, offset: np.ndarray) -> np.ndarray:
    """Host mirror of the in-graph dequant: ``q * scale + offset`` in f32.

    Must stay bit-identical to the device step's
    ``take(q).astype(f32) * scale + offset`` (train/device_step.py) — the
    trajectory-equivalence tests feed THIS function's output through the
    host loader and require the same parameter trajectory.
    """
    return (q.astype(np.float32) * np.asarray(scale, np.float32)
            + np.asarray(offset, np.float32))
