"""The card a run measures: the check that it is there, what the result line
says of it, and the check that no JAX module was loaded."""

from __future__ import annotations

import subprocess
import sys

import torch

# top-level module names a run of the port must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_scalablefhvae_tpu")


class NoDevice(RuntimeError):
    """The cell asks for more CUDA devices than this machine has."""


def require_cards(count: int) -> None:
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < count:
        raise NoDevice(f"the cell needs {count} CUDA devices, this machine "
                       f"has {torch.cuda.device_count()}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w() -> float | None:
    """The card's power limit as ``nvidia-smi`` reads it, where it can."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(device: torch.device, count: int) -> dict:
    """The result line's ``device``; ``memory_peak_bytes`` is the peak of
    this process's allocations on the card so far."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit_w": power_limit_w()}
