"""Experiment configuration: counterpart of ``config.py``.

The dataclasses are the JAX package's own, which import no jax: one
``config.json`` means the same run to both packages, and an experiment
trained by either loads in the other.
"""

from pytorch_scalablefhvae_tpu.config import (
    DataConfig,
    ExperimentConfig,
    FeatureConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)

__all__ = ["DataConfig", "ExperimentConfig", "FeatureConfig", "ModelConfig",
           "OptimConfig", "TrainConfig"]
