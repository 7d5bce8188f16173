"""PyTorch/CUDA port of the ScalableFHVAE framework, for one NVIDIA H100.

The JAX package ``pytorch_scalablefhvae_tpu`` is the reference; module names
here mirror it so each counterpart is easy to find. The port imports
``torch`` and never ``jax``. Its framework-free host layer (config, corpus,
features, segment data, audio and manifest I/O) is shared by import from the
JAX package, whose modules there import no jax; ``config`` re-exports the
experiment dataclasses.

Every Pallas kernel on a ported path is a kernel written by hand for Hopper
(``csrc/``, built at first use by ``ops/_build.py``). Each wrapper launches
its kernel for a CUDA tensor and runs its plain PyTorch version only for a
CPU tensor. What is ported so far, and what is not, is in ``ROADMAP.md``.
"""

__version__ = "0.1.0"
