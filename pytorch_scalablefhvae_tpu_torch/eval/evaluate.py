"""Experiment loading: counterpart of ``eval/evaluate.py:load_experiment``.

The split evaluation (``evaluate_experiment``) is not yet ported
(ROADMAP.md).
"""

from __future__ import annotations

from pathlib import Path

import torch

from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
from pytorch_scalablefhvae_tpu_torch.models.base import build_model
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt


def load_experiment(exp_dir, step: int = -1,
                    device: torch.device | str = "cpu"):
    """Config + model (with the checkpoint's weights, on ``device``) from an
    experiment directory. ``step=-1`` loads the best checkpoint, otherwise
    the ``step``-th epoch checkpoint. Returns ``(config, model, meta)``;
    the model is in eval mode."""
    exp_dir = Path(exp_dir)
    config = ExperimentConfig.load(exp_dir / "config.json")
    ckpt_file = (ckpt.find_best_checkpoint(exp_dir) if step == -1
                 else ckpt.find_epoch_checkpoint(exp_dir, step))
    meta = ckpt.read_checkpoint_meta(ckpt_file)
    model = build_model(
        config.model.model_type, meta["model_params"][0], config.model,
        meta.get("num_seqs", 1),
        feat_dim=meta.get("feat_dim", config.features.n_mels))
    model.to(device)
    meta = ckpt.load_params(ckpt_file, model)
    return config, model.eval(), meta
