"""Kaldi binary archive (.ark/.scp) float-matrix I/O.

The reference reads features through ``kaldiio`` (datasets.py:9,258,268) and
produces archives with Kaldi's C++ ``compute-fbank-feats``
(prepare_kaldi_data.py:38-46). This module implements the same on-disk format
natively so archives interoperate both ways:

    record  := key ' ' '\\0B' 'FM ' '\\x04' rows(int32 LE) '\\x04' cols(int32 LE) data(f32, row-major)
    scp     := lines of "key path:offset" where offset addresses the '\\0B'.

A C++ fast path for bulk reading lives in ``native/``; this pure-Python
implementation is the reference/fallback and handles writing.
"""

from __future__ import annotations

import struct
from collections import OrderedDict
from pathlib import Path
from typing import Iterable, Iterator, Mapping

import numpy as np

_BINARY_MARKER = b"\x00B"
_DTYPE_TOKEN = {np.dtype("float32"): b"FM ", np.dtype("float64"): b"DM "}
_TOKEN_DTYPE = {b"FM ": np.dtype("<f4"), b"DM ": np.dtype("<f8")}


def _write_matrix(f, mat: np.ndarray) -> None:
    mat = np.ascontiguousarray(mat)
    if mat.ndim != 2:
        raise ValueError(f"Expected 2-D matrix, got shape {mat.shape}")
    token = _DTYPE_TOKEN.get(np.dtype(mat.dtype))
    if token is None:
        mat = mat.astype(np.float32)
        token = b"FM "
    f.write(token)
    f.write(b"\x04" + struct.pack("<i", mat.shape[0]))
    f.write(b"\x04" + struct.pack("<i", mat.shape[1]))
    f.write(mat.astype(_TOKEN_DTYPE[token], copy=False).tobytes())


def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise ValueError(
            f"Truncated Kaldi matrix record (wanted {n} bytes, got {len(b)})")
    return b


def _read_matrix(f) -> np.ndarray:
    token = _read_exact(f, 3)
    if token not in _TOKEN_DTYPE:
        raise ValueError(f"Unsupported Kaldi matrix token {token!r}")
    dtype = _TOKEN_DTYPE[token]
    # explicit length-checked reads + ValueError, never `assert f.read(...)`
    # (python -O strips asserts INCLUDING their reads, silently corrupting
    # the stream position) and never bare struct.unpack on a short read
    m1 = _read_exact(f, 1)
    rows = struct.unpack("<i", _read_exact(f, 4))[0]
    m2 = _read_exact(f, 1)
    cols = struct.unpack("<i", _read_exact(f, 4))[0]
    if m1 != b"\x04" or m2 != b"\x04":
        raise ValueError(
            f"Malformed Kaldi matrix header (size markers {m1!r}/{m2!r})")
    if rows < 0 or cols <= 0:
        raise ValueError(f"Malformed Kaldi matrix dims {rows}x{cols}")
    data = np.frombuffer(
        _read_exact(f, rows * cols * dtype.itemsize), dtype=dtype)
    return data.reshape(rows, cols)


class ArkWriter:
    """Streaming writer producing paired feats.ark / feats.scp files."""

    def __init__(self, ark_path: str | Path, scp_path: str | Path | None = None):
        self.ark_path = Path(ark_path)
        self.ark_path.parent.mkdir(parents=True, exist_ok=True)
        self._ark = open(self.ark_path, "wb")
        self._scp = None
        if scp_path is not None:
            self._scp = open(scp_path, "w")

    def write(self, key: str, mat: np.ndarray) -> None:
        self._ark.write(key.encode() + b" ")
        offset = self._ark.tell()
        self._ark.write(_BINARY_MARKER)
        _write_matrix(self._ark, mat)
        if self._scp is not None:
            self._scp.write(f"{key} {self.ark_path}:{offset}\n")

    def close(self) -> None:
        self._ark.close()
        if self._scp is not None:
            self._scp.close()

    def __enter__(self) -> "ArkWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_ark(
    ark_path: str | Path,
    mats: Mapping[str, np.ndarray] | Iterable[tuple[str, np.ndarray]],
    scp_path: str | Path | None = None,
) -> None:
    items = mats.items() if isinstance(mats, Mapping) else mats
    with ArkWriter(ark_path, scp_path) as w:
        for k, m in items:
            w.write(k, m)


def load_mat(rxspecifier: str) -> np.ndarray:
    """Random-access read of one matrix from "path:offset" (kaldiio parity)."""
    path, _, offset = rxspecifier.rpartition(":")
    with open(path, "rb") as f:
        f.seek(int(offset))
        marker = f.read(2)
        if marker != _BINARY_MARKER:
            raise ValueError(f"Expected binary marker at {rxspecifier}, got {marker!r}")
        return _read_matrix(f)


def iter_ark(ark_path: str | Path) -> Iterator[tuple[str, np.ndarray]]:
    """Sequentially iterate (key, matrix) records of an archive."""
    for key, mat, _ in iter_ark_offsets(ark_path):
        yield key, mat


def iter_ark_offsets(
    ark_path: str | Path,
) -> Iterator[tuple[str, np.ndarray, int]]:
    """Like :func:`iter_ark` but also yields each record's byte offset —
    the position of the binary marker, i.e. exactly the offset an
    rxspecifier (``path:offset``) written by :class:`ArkWriter` binds to.
    Lets callers match records against the scp's AUTHORITATIVE offsets,
    so a stale duplicate key in the same archive cannot win."""
    with open(ark_path, "rb") as f:
        while True:
            key_bytes = bytearray()
            while True:
                c = f.read(1)
                if not c:
                    if key_bytes:
                        # EOF mid-key is corruption (a clean archive ends
                        # exactly at a key start), not a silent end
                        raise ValueError(
                            f"Truncated ark record key {bytes(key_bytes)!r} "
                            f"at end of {ark_path}")
                    return
                if c == b" ":
                    break
                key_bytes += c
            offset = f.tell()
            marker = f.read(2)
            if marker != _BINARY_MARKER:
                raise ValueError(f"Non-binary ark record for key {key_bytes!r}")
            yield key_bytes.decode(), _read_matrix(f), offset


def read_ark(ark_path: str | Path) -> "OrderedDict[str, np.ndarray]":
    return OrderedDict(iter_ark(ark_path))
