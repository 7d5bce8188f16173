"""The port imports no jax, and reaches the CPU only when asked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pytorch_scalablefhvae_tpu_torch.utils.device import resolve_device

PORT_MODULES = [
    "pytorch_scalablefhvae_tpu_torch.cli.main",
    "pytorch_scalablefhvae_tpu_torch.config",
    "pytorch_scalablefhvae_tpu_torch.data.device_store",
    "pytorch_scalablefhvae_tpu_torch.eval.serve",
    "pytorch_scalablefhvae_tpu_torch.eval.encode",
    "pytorch_scalablefhvae_tpu_torch.eval.evaluate",
    "pytorch_scalablefhvae_tpu_torch.models.fhvae",
    "pytorch_scalablefhvae_tpu_torch.train.checkpoint",
    "pytorch_scalablefhvae_tpu_torch.train.step",
    "pytorch_scalablefhvae_tpu_torch.train.device_step",
    "pytorch_scalablefhvae_tpu_torch.train.loop",
    "pytorch_scalablefhvae_tpu_torch.train.driver",
    "pytorch_scalablefhvae_tpu_torch.train.metrics",
    "pytorch_scalablefhvae_tpu_torch.ops.lstm_cuda",
    "pytorch_scalablefhvae_tpu_torch.ops.discriminative",
    "pytorch_scalablefhvae_tpu_torch.ops.window_gather",
]


def test_port_imports_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'optax', 'orbax'))\n"
              "assert not bad, bad\n")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py drives the port alone: no jax, and nothing of the JAX
    package except through the port."""
    src = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    names = []
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "pytorch_scalablefhvae_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "optax", "orbax",
                        "pytorch_scalablefhvae_tpu"}, sorted(roots)


def test_cuda_request_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("mps")
