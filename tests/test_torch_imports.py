"""The port imports no jax, nothing of the JAX package and not JAX's
``ml_dtypes`` (bfloat16 arrays are made by torch), and reaches the CPU only
when asked."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pytorch_scalablefhvae_tpu_torch.utils.device import resolve_device

PORT = Path(__file__).resolve().parents[1] / "pytorch_scalablefhvae_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "ml_dtypes",
             "pytorch_scalablefhvae_tpu"}
PORT_FILES = sorted(str(p.relative_to(PORT.parent)) for p in PORT.rglob("*.py"))

PORT_MODULES = [
    "pytorch_scalablefhvae_tpu_torch.cli.args",
    "pytorch_scalablefhvae_tpu_torch.cli.main",
    "pytorch_scalablefhvae_tpu_torch.config",
    "pytorch_scalablefhvae_tpu_torch.corpus.librispeech",
    "pytorch_scalablefhvae_tpu_torch.corpus.synthetic",
    "pytorch_scalablefhvae_tpu_torch.corpus.timit",
    "pytorch_scalablefhvae_tpu_torch.data.device_store",
    "pytorch_scalablefhvae_tpu_torch.data.feature_store",
    "pytorch_scalablefhvae_tpu_torch.data.loader",
    "pytorch_scalablefhvae_tpu_torch.data.quantize",
    "pytorch_scalablefhvae_tpu_torch.data.segments",
    "pytorch_scalablefhvae_tpu_torch.data.stream_store",
    "pytorch_scalablefhvae_tpu_torch.features.dsp_numpy",
    "pytorch_scalablefhvae_tpu_torch.features.dsp_torch",
    "pytorch_scalablefhvae_tpu_torch.features.extract",
    "pytorch_scalablefhvae_tpu_torch.features.kaldi_fbank",
    "pytorch_scalablefhvae_tpu_torch.features.mel",
    "pytorch_scalablefhvae_tpu_torch.features.pipeline",
    "pytorch_scalablefhvae_tpu_torch.native.binding",
    "pytorch_scalablefhvae_tpu_torch.utils.audio_io",
    "pytorch_scalablefhvae_tpu_torch.utils.kaldi_ark",
    "pytorch_scalablefhvae_tpu_torch.utils.manifest",
    "pytorch_scalablefhvae_tpu_torch.eval.serve",
    "pytorch_scalablefhvae_tpu_torch.eval.encode",
    "pytorch_scalablefhvae_tpu_torch.eval.evaluate",
    "pytorch_scalablefhvae_tpu_torch.eval.probes",
    "pytorch_scalablefhvae_tpu_torch.models.fhvae",
    "pytorch_scalablefhvae_tpu_torch.models.simple_fhvae",
    "pytorch_scalablefhvae_tpu_torch.compat",
    "pytorch_scalablefhvae_tpu_torch.train.checkpoint",
    "pytorch_scalablefhvae_tpu_torch.train.step",
    "pytorch_scalablefhvae_tpu_torch.train.device_step",
    "pytorch_scalablefhvae_tpu_torch.train.graphs",
    "pytorch_scalablefhvae_tpu_torch.train.loop",
    "pytorch_scalablefhvae_tpu_torch.train.rounds",
    "pytorch_scalablefhvae_tpu_torch.train.driver",
    "pytorch_scalablefhvae_tpu_torch.train.metrics",
    "pytorch_scalablefhvae_tpu_torch.train.orbax_backend",
    "pytorch_scalablefhvae_tpu_torch.train.trace",
    "pytorch_scalablefhvae_tpu_torch.train.plots",
    "pytorch_scalablefhvae_tpu_torch.ops.lstm_cuda",
    "pytorch_scalablefhvae_tpu_torch.ops.discriminative",
    "pytorch_scalablefhvae_tpu_torch.ops.stage_gather",
    "pytorch_scalablefhvae_tpu_torch.ops.window_gather",
    "pytorch_scalablefhvae_tpu_torch.ops.fbank_cuda",
    "pytorch_scalablefhvae_tpu_torch.parallel.mesh",
    "pytorch_scalablefhvae_tpu_torch.parallel.sharded_step",
    "pytorch_scalablefhvae_tpu_torch.parallel.launch",
]


def import_roots(path: Path) -> set[str]:
    """The top-level package of every ``import`` / ``from`` in a file,
    wherever it stands (module level or inside a function)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return {n.split(".")[0] for n in names}


def test_port_imports_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              f"{sorted(FORBIDDEN)!r})\n"
              "assert not bad, bad\n")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py drives the port alone: no jax, and nothing of the JAX
    package except through the port."""
    roots = import_roots(PORT.parent / "chip_smoke.py")
    assert "pytorch_scalablefhvae_tpu_torch" in roots
    assert not roots & FORBIDDEN, sorted(roots)


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_nothing_of_jax_or_the_jax_package(rel):
    """Every file of the port, not only the modules a path happens to load:
    no ``import``/``from`` whose root is jax, its companions or the JAX
    package, not even of a module there that imports no jax."""
    assert not import_roots(PORT.parent / rel) & FORBIDDEN


def test_port_modules_list_covers_every_module():
    have = {m.replace(".", "/") + ".py" for m in PORT_MODULES}
    skip = ("__init__.py", "ops/_build.py", "utils/device.py",
            "eval/latents.py", "models/base.py", "models/layers.py")
    missing = [f for f in PORT_FILES if f not in have and not f.endswith(skip)]
    assert not missing, missing


def test_cuda_request_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("mps")
