"""ctypes bindings for the native host components.

Builds ``libsfhvae_native.so`` from the C++ sources on first use (g++ is
assumed; pybind11 is not, hence the C ABI + ctypes). The build
is cached next to the sources; ``rebuild=True`` or deleting the .so forces a
recompile.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SOURCES = [_DIR / "fbank.cc", _DIR / "ark.cc"]
_LIB_PATH = _DIR / "libsfhvae_native.so"

_WINDOW_CODES = {"hamming": 0, "povey": 1, "hanning": 2, "hann": 2,
                 "rectangular": 3, "blackman": 4}

_lib = None


def build_native(rebuild: bool = False, sanitize: bool = False) -> Path:
    """Compile the shared library; ``sanitize=True`` builds an ASan/UBSan
    variant (used by the sanitizer test tier, SURVEY.md §5).

    The compile targets a per-process temp name and lands with an atomic
    ``os.replace``: feature-extraction pool workers can all hit a stale
    .so simultaneously, and racing g++ writes to one output path would let
    a worker ``CDLL`` a half-written file.
    """
    import os

    sources = [s for s in _SOURCES if s.exists()]
    out = _DIR / ("libsfhvae_native_asan.so" if sanitize else _LIB_PATH.name)
    if not sources:
        # source-less install (prebuilt .so shipped without the .cc files)
        if out.exists():
            return out
        raise FileNotFoundError(
            f"native sources missing under {_DIR} and no prebuilt {out.name}")
    if out.exists() and not rebuild:
        newest_src = max(s.stat().st_mtime for s in sources)
        if out.stat().st_mtime >= newest_src:
            return out
    cmd = ["g++", "-O2" if sanitize else "-O3", "-march=native", "-shared",
           "-fPIC", "-std=c++17"]
    if sanitize:
        cmd += ["-fsanitize=address,undefined", "-fno-omit-frame-pointer", "-g"]
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd += [*[str(s) for s in sources], "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load_native(rebuild: bool = False) -> ctypes.CDLL:
    global _lib
    if _lib is None or rebuild:
        lib = ctypes.CDLL(str(build_native(rebuild=rebuild)))
        lib.fbank_num_frames.restype = ctypes.c_int
        lib.fbank_num_frames.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ]
        lib.ark_scan.restype = ctypes.c_int
        lib.ark_scan.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ark_read_packed.restype = ctypes.c_int64
        lib.ark_read_packed.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.fbank_compute.restype = ctypes.c_int
        lib.fbank_compute.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_int,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
    return _lib


def native_fbank(
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
    round_to_power_of_two: bool = True,  # accepted for parity; always pow2
    input_scale: float = 32768.0,
    seed: int | None = 0,
) -> np.ndarray:
    """Drop-in C++ replacement for ``features.kaldi_fbank.kaldi_fbank``."""
    lib = load_native()
    y = np.ascontiguousarray(y, dtype=np.float32)
    n_frames = lib.fbank_num_frames(len(y), sr, frame_length_ms, frame_shift_ms)
    out = np.zeros((max(n_frames, 0), n_mels), dtype=np.float32)
    if n_frames <= 0:
        return out
    rc = lib.fbank_compute(
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(y), sr,
        frame_length_ms, frame_shift_ms,
        n_mels, _WINDOW_CODES[window_type], dither,
        preemphasis, int(remove_dc_offset),
        low_freq, high_freq,
        int(use_power), int(use_log_fbank),
        input_scale, int(seed or 0),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc < 0:
        raise RuntimeError(f"native fbank_compute failed with code {rc}")
    return out


def native_read_ark_packed(
    path, with_file_offsets: bool = False
) -> tuple[list[str], np.ndarray, np.ndarray] | tuple[
        list[str], np.ndarray, np.ndarray, np.ndarray]:
    """Bulk-read an entire ark file in one C++ pass.

    Returns (keys, data [total_rows, cols] float32, row_offsets [n+1]
    int64); with ``with_file_offsets`` also each record's rxspecifier byte
    offset [n] int64 (the \\0B-marker position), so callers can match
    records against the scp's authoritative ``path:offset`` bindings.
    """
    lib = load_native()
    pb = str(path).encode()
    n_mats = ctypes.c_int64()
    total_rows = ctypes.c_int64()
    cols = ctypes.c_int32()
    rc = lib.ark_scan(pb, ctypes.byref(n_mats), ctypes.byref(total_rows), ctypes.byref(cols))
    if rc != 0:
        raise RuntimeError(f"ark_scan({path}) failed with code {rc}")
    n, rows, c = n_mats.value, total_rows.value, max(cols.value, 0)
    data = np.zeros((rows, c), dtype=np.float32)
    offsets = np.zeros(n + 1, dtype=np.int64)
    file_offsets = np.zeros(max(n, 1), dtype=np.int64)
    keys_cap = 64 * max(n, 1)
    keys_buf = ctypes.create_string_buffer(keys_cap)
    got = lib.ark_read_packed(
        pb,
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        file_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        keys_buf, keys_cap,
        # buffer capacities from the sizing pass: the file can grow
        # between ark_scan and this read (appending re-extraction); the
        # C side stops at these bounds instead of overrunning the heap.
        # expected_cols guards the row WIDTH the same way — `data` is
        # allocated rows x c, and a wider record (archive atomically
        # replaced with more mel bins, same counts) would overrun it
        ctypes.c_int64(n), ctypes.c_int64(rows), ctypes.c_int32(c),
    )
    if got == -2:
        raise RuntimeError(
            f"ark_read_packed({path}): record width changed between the "
            f"sizing and read passes (archive replaced by a re-extraction "
            f"with a different feature dim?); retry the pack build")
    if got == -5:
        raise RuntimeError(
            f"ark_read_packed({path}): archive grew between the sizing "
            f"and read passes (concurrent writer?); retry the pack build")
    if got == -3:
        raise RuntimeError(
            f"ark_read_packed({path}) failed with code -3 "
            f"(truncated record payload: the archive ends mid-matrix)")
    if got < 0:
        raise RuntimeError(
            f"ark_read_packed({path}) failed with code {got} "
            f"(corrupt or unsupported record header mid-archive)")
    if got != n:
        raise RuntimeError(f"ark_read_packed({path}) read {got} of {n} records")
    keys = keys_buf.value.decode().splitlines()
    if len(keys) != n:
        raise RuntimeError(f"ark key buffer overflow for {path}")
    if with_file_offsets:
        return keys, data, offsets, file_offsets[:n]
    return keys, data, offsets
