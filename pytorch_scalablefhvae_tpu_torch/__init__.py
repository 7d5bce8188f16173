"""PyTorch/CUDA port of the ScalableFHVAE framework, for one NVIDIA H100.

The JAX package ``pytorch_scalablefhvae_tpu`` is the reference; module names
here mirror it so each counterpart is easy to find. The port imports
``torch`` and never ``jax``, and nothing of the JAX package: its host layer
(config, CLI flags, corpus prep, host feature extractors and their native
C++ library, segment data, audio and manifest I/O) is its own copy under
the same relative names, held equal to the original by
``tests/test_torch_host_layer.py``.

Every Pallas kernel on a ported path is a kernel written by hand for Hopper
(``csrc/``, built at first use by ``ops/_build.py``). Each wrapper launches
its kernel for a CUDA tensor and runs its plain PyTorch version only for a
CPU tensor. What is ported so far, and what is not, is in ``ROADMAP.md``.
"""

__version__ = "0.1.0"
