"""Build the port's CUDA sources (``csrc/*.cu``) and load them with ctypes.

``nvcc`` compiles every source (``*.cu``, which include the ``*.cuh``
headers beside them) for ``sm_90a`` (Hopper) at first use, one ``nvcc -c``
per source, all started together, and links the objects into one shared
library with a plain C interface. The library lands in
``build/torch_kernels/<hash>/`` of the checkout, keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
in milliseconds. nvcc's ``-Xptxas -v`` report (registers, shared memory,
spills per kernel) is kept beside it as ``build.log``.

Pointers and the stream cross as ``c_void_p``; every C entry returns the
``cudaError_t`` of its launch, and :func:`check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libsfhvae_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "sfhvae_lstm2_threads": (_I, [_I]),
    "sfhvae_lstm2_fwd_fma": (_I, [_P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _I, _I, _I, _I, _I, _P]),
    "sfhvae_lstm2_tc_takes": (_I, [_I, _I]),
    "sfhvae_lstm2_fwd_cluster_rows": (_I, [_I]),
    "sfhvae_lstm2_fwd": (_I, [_P, _P, _L, _L] + [_P] * 9 + [_I] * 4 + [_P]),
    "sfhvae_lstm2_fwd_chain_probe": (_I, [_P] * 8 + [_I] * 3 + [_P]),
    "sfhvae_lstm2_bwd_chunk_rows": (_I, []),
    "sfhvae_lstm2_bwd": (_I, [_P, _P, _L, _L] + [_P] * 15 + [_I]
                         + [_P] * 8 + [_I] * 6 + [_P]),
    "sfhvae_lstm2_bwd_fma_chunk_rows": (_I, []),
    "sfhvae_lstm2_bwd_fma": (_I, [_P, _P, _L, _L] + [_P] * 17 + [_I]
                             + [_P] * 7 + [_I] * 5 + [_P]),
    "sfhvae_disc_max_dim": (_I, []),
    "sfhvae_disc_fwd": (_I, [_P] * 3 + [_I] + [_P] * 3 + [_I] * 8
                        + [ctypes.c_float, _P]),
    "sfhvae_disc_partials": (_I, [_P] * 3 + [_I] + [_P] * 4 + [_I] * 9
                             + [ctypes.c_float, _P]),
    "sfhvae_disc_fwd_probe": (_I, [_P] * 3 + [_I, _P] + [_I] * 8
                              + [ctypes.c_float, _I, _P]),
    "sfhvae_disc_bwd": (_I, [_P] * 3 + [_I] + [_P] * 6 + [_I] * 9
                        + [ctypes.c_float, _P]),
    "sfhvae_window_gather_max_smem": (_I, []),
    "sfhvae_window_gather": (_I, [_P, _P, _P, _L] + [_I] * 6 + [_P]),
    "sfhvae_host_register": (_I, [_P, _L, _I, ctypes.POINTER(_P)]),
    "sfhvae_host_unregister": (_I, [_P]),
    "sfhvae_stage_gather": (_I, [_P, _P, _I, _P, _I, _I, _I, _P]),
    "sfhvae_fbank_logmel_smem": (_L, [_I] * 4),
    "sfhvae_fbank_logmel_max_smem": (_I, []),
    "sfhvae_fbank_logmel_threads": (_I, [_I, _I]),
    "sfhvae_fbank_logmel_probe": (_I, [_P] * 6 + [_L, _I, _I, _I,
                                                  ctypes.c_float, _I, _I,
                                                  _P]),
    "sfhvae_fbank_logmel": (_I, [_P] * 6 + [_L, _I, _I, _I, ctypes.c_float,
                                            _I, _P]),
    "sfhvae_cuda_error_string": (ctypes.c_char_p, [_I]),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from csrc/ at first use")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _run(cmd: list[str]) -> str:
    """Run one nvcc command; its stderr, or a raise with it on failure."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}")
    return proc.stderr


def build() -> Path:
    """Compile ``csrc/*.cu`` unless this exact build exists: every source
    compiles in its own ``nvcc -c``, all at once, then one link; raises with
    nvcc's stderr when a step fails."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    srcs = sources()
    # nvcc tells an object from other inputs by its ".o" suffix
    objs = [out.with_name(f".{s.stem}.{os.getpid()}.o") for s in srcs]
    nvcc = _nvcc()
    try:
        with ThreadPoolExecutor(len(srcs)) as pool:
            logs = list(pool.map(_run, [
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                for s, o in zip(srcs, objs)]))
        _run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])
        (out.parent / "build.log").write_text("".join(logs))
        os.replace(tmp, out)
    finally:
        for p in (tmp, *objs):
            p.unlink(missing_ok=True)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(code: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if code != 0:
        msg = library().sfhvae_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
