"""Audio file readers: RIFF WAV, NIST SPHERE, and (gated) FLAC.

The reference pulled in librosa/sphfile/pydub for decoding
(prepare_numpy_data.py:108, preprocess_timit.py:59-60,
preprocess_librispeech.py:35-37); none of those are dependencies here, so the
decoders are implemented directly. Output is float32 mono in [-1, 1], matching
``librosa.load(..., mono=True)`` scaling for 16-bit PCM.
"""

from __future__ import annotations

import shutil
import subprocess
import wave
from pathlib import Path

import numpy as np


def _pcm_to_float(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    if data.dtype in (np.float32, np.float64):
        return data.astype(np.float32)
    raise ValueError(f"Unsupported PCM dtype {data.dtype}")


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a RIFF WAV file (path or file object) ->
    (float32 mono samples in [-1,1], sample_rate)."""
    src = str(path) if isinstance(path, (str, Path)) else path
    with wave.open(src, "rb") as w:
        sr = w.getframerate()
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2")
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4")
    elif sampwidth == 1:
        data = np.frombuffer(raw, dtype=np.uint8)
    else:
        raise ValueError(f"Unsupported WAV sample width {sampwidth} in {path}")
    y = _pcm_to_float(data)
    if n_channels > 1:
        y = y.reshape(-1, n_channels).mean(axis=1)
    return y, sr


def write_wav(path: str | Path, y: np.ndarray, sr: int) -> Path:
    """Write float32 [-1,1] mono samples as 16-bit PCM WAV."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pcm = np.clip(np.asarray(y, dtype=np.float64) * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return path


def read_sphere(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a NIST SPHERE file (TIMIT's native format).

    Parses the 1024-byte ASCII header (``NIST_1A`` magic) and decodes 16-bit
    PCM payloads; equivalent capability to the reference's ``sphfile``
    dependency (preprocess_timit.py:59-60).
    """
    with open(path, "rb") as f:
        magic = f.read(8)
        if not magic.startswith(b"NIST_1A"):
            raise ValueError(f"{path} is not a NIST SPHERE file")
        header_size = int(f.read(8).strip())
        header = f.read(header_size - 16).decode("ascii", errors="replace")
        fields: dict[str, str] = {}
        for line in header.splitlines():
            parts = line.split(None, 2)
            if len(parts) == 3 and parts[1].startswith("-"):
                fields[parts[0]] = parts[2]
        sr = int(fields.get("sample_rate", "16000"))
        n_channels = int(fields.get("channel_count", "1"))
        sample_bytes = int(fields.get("sample_n_bytes", "2"))
        fmt = fields.get("sample_byte_format", "01")
        coding = fields.get("sample_coding", "pcm")
        # only PLAIN pcm decodes as raw samples: LDC corpora commonly ship
        # "pcm,embedded-shorten-v2.00", whose payload is a shorten
        # bitstream — frombuffer'ing it would yield silent garbage
        if coding.strip().lower() != "pcm" or sample_bytes != 2:
            raise ValueError(
                f"Unsupported SPHERE coding {coding!r} in {path} "
                f"(only uncompressed 16-bit 'pcm' is supported; "
                f"shorten-compressed files need 'sph2pipe' conversion)")
        f.seek(header_size)
        raw = f.read()
    dtype = "<i2" if fmt == "01" else ">i2"
    data = np.frombuffer(raw, dtype=dtype)
    # normalize byte order to NATIVE int16: a '>i2' array fails
    # _pcm_to_float's dtype check (np.dtype('>i2') != np.int16 — byte order
    # is part of the dtype, and ascontiguousarray does not change it)
    data = data.astype(np.int16, copy=False)
    y = _pcm_to_float(np.ascontiguousarray(data))
    if n_channels > 1:
        y = y.reshape(-1, n_channels).mean(axis=1)
    return y, sr


def is_sphere(path: str | Path) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(7) == b"NIST_1A"
    except OSError:
        return False


def read_flac(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode FLAC via the ``flac``/``ffmpeg`` CLI if present.

    LibriSpeech ships FLAC (preprocess_librispeech.py:21-28). Pure-Python FLAC
    decoding is out of scope; this shells out to a system decoder and raises a
    clear error when none is available.
    """
    import io

    path = Path(path)
    # both decoders emit a WAV container so the sample rate rides the
    # header — no separate ffprobe probe (whose empty output once fell
    # back to a silent, geometrically wrong 16 kHz assumption), and the
    # parse/convert/downmix path is read_wav's, not a duplicate
    if shutil.which("ffmpeg"):
        wav_bytes = subprocess.run(
            ["ffmpeg", "-v", "error", "-i", str(path), "-f", "wav", "-"],
            capture_output=True,
            check=True,
        ).stdout
        return read_wav(io.BytesIO(wav_bytes))
    if shutil.which("flac"):
        wav_bytes = subprocess.run(
            ["flac", "-sdc", str(path)], capture_output=True, check=True
        ).stdout
        return read_wav(io.BytesIO(wav_bytes))
    raise RuntimeError(
        f"No FLAC decoder available for {path}: install 'flac' or 'ffmpeg', "
        "or convert the corpus to WAV first."
    )


def read_audio(path: str | Path, sample_rate: int | None = None) -> tuple[np.ndarray, int]:
    """Dispatch on container; optionally resample (polyphase, scipy)."""
    path = Path(path)
    if path.suffix.lower() == ".flac":
        y, sr = read_flac(path)
    elif is_sphere(path):
        y, sr = read_sphere(path)
    else:
        y, sr = read_wav(path)
    if sample_rate is not None and sample_rate != sr:
        y = resample(y, sr, sample_rate)
        sr = sample_rate
    return y, sr


def resample(y: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (scipy.signal.resample_poly)."""
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(y, sr_out // g, sr_in // g).astype(np.float32)
