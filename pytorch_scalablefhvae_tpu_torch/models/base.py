"""Shared FHVAE machinery: counterpart of ``models/base.py``.

ELBO assembly, the discriminative objective's dispatch, the mu2-table
selection rule, the training loss and the model factory. The math is the
JAX package's (its docstrings give the derivations and the reference's
defects it fixes); only the tensor library differs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pytorch_scalablefhvae_tpu_torch.models.layers import kld, log_gauss
from pytorch_scalablefhvae_tpu_torch.ops import discriminative as _disc


class FHVAEOutputs(NamedTuple):
    """Per-segment model outputs (field order as in the JAX package)."""

    lower_bound: torch.Tensor  # [B]
    log_qy: torch.Tensor  # [B] discriminative log q(y|z2)
    log_px_z: torch.Tensor  # [B]
    neg_kld_z1: torch.Tensor  # [B]
    neg_kld_z2: torch.Tensor  # [B]
    log_pmu2: torch.Tensor  # [B]
    z1_mu: torch.Tensor  # [B, z1_dim]
    z2_mu: torch.Tensor  # [B, z2_dim]
    x_mu: torch.Tensor  # [B, T, F] reconstruction mean
    x_logvar: torch.Tensor  # [B, T, F]


def discriminative_log_qy(z2_mu, mu2_table, seq_idx, pz2_logvar: float,
                          num_real: int | None = None,
                          mesh=None) -> torch.Tensor:
    """log q(y | z2): the streaming CUDA kernel for CUDA tensors, its plain
    version for CPU tensors (``ops/discriminative.py``). Rows at or past
    ``num_real`` are padding and leave the log-sum-exp unchanged. With a
    ``mesh``, ``mu2_table`` is this rank's row shard of the table: the kernel
    streams the shard and the model group merges the partials."""
    if mesh is not None:
        return _disc.discriminative_log_qy_sharded(
            z2_mu, mu2_table, seq_idx, float(pz2_logvar), mesh, num_real)
    return _disc.discriminative_log_qy(z2_mu, mu2_table, seq_idx,
                                       float(pz2_logvar), num_real)


def assemble_elbo(x, mu2, z1_mu, z1_logvar, z2_mu, z2_logvar, x_mu, x_logvar,
                  nsegs, *, pz2_logvar: float, frame_axes=(1, 2)):
    """Per-segment ELBO terms ``(lower_bound, log_px_z, neg_kld_z1,
    neg_kld_z2, log_pmu2)``.

    ``lower_bound = log p(x|z) - KL(q(z1)||p(z1)) - KL(q(z2)||p(z2|mu2))
    + log p(mu2) / nsegs``. ``frame_axes`` are the (time, feature) axes of
    ``x``/``x_mu``/``x_logvar``: ``(1, 2)`` batch-major, ``(0, 2)`` for the
    recurrent model's time-major ``[T, B, F]`` path.
    """
    log_pmu2 = log_gauss(mu2, 0.0, 0.0).sum(-1)
    neg_kld_z2 = -kld(z2_mu, z2_logvar, mu2, pz2_logvar).sum(-1)
    neg_kld_z1 = -kld(z1_mu, z1_logvar, 0.0, 0.0).sum(-1)
    log_px_z = log_gauss(x, x_mu, x_logvar).sum(dim=frame_axes)
    lower_bound = log_px_z + neg_kld_z1 + neg_kld_z2 + log_pmu2 / nsegs
    return lower_bound, log_px_z, neg_kld_z1, neg_kld_z2, log_pmu2


def resolve_mu2_scoring(model, mu2_table: torch.Tensor | None):
    """``(table, num_real, mesh)``: the mu2 table a forward scores against,
    its real-row count, and the mesh it is sharded over or ``None``.

    Without an override the learned table scores with the model's real
    sequence count (rows past it are padding) and, in a mesh run, through
    the model's mesh: the model then holds only its rank's row shard. An
    override table (a split's MAP estimates) is unpadded and replicated:
    every rank scores its batch rows against all of it with the single-table
    kernel. (The JAX package drops to its jnp form there only because a bare
    Pallas call has no GSPMD partitioning rule; ranks that each launch their
    own kernel have no such limit.)
    """
    if mu2_table is None:
        return model.mu2_table, model.num_seqs, model.shard_mesh
    return mu2_table, mu2_table.shape[0], None


# the exact key set of the metrics dict loss_from_outputs returns
METRIC_KEYS = ("loss", "lower_bound", "log_qy", "log_px_z",
               "neg_kld_z1", "neg_kld_z2", "log_pmu2")


def loss_from_outputs(out: FHVAEOutputs, weight: torch.Tensor, alpha: float,
                      mesh=None):
    """Training loss ``-mean(lower_bound + alpha * log_qy)`` over the rows
    with weight 1; returns ``(loss, metrics)`` with keys ``METRIC_KEYS``.
    With a ``mesh``, ``out`` and ``weight`` are this rank's batch rows and
    the mean divides by the whole batch's weight (summed over the data
    group): every value is then this rank's part, and the parts of a data
    group add up to the batch's."""
    total = weight.sum() if mesh is None else mesh.data_sum(weight.sum())
    denom = torch.clamp(total, min=1.0)

    def wmean(v):
        return (v * weight).sum() / denom

    metrics = {"loss": -wmean(out.lower_bound + alpha * out.log_qy)}
    for k in METRIC_KEYS[1:]:
        metrics[k] = wmean(getattr(out, k))
    return metrics["loss"], metrics


def build_model(model_type: str, input_size: int, cfg, num_seqs: int,
                feat_dim: int | None = None, generator=None):
    """Model factory over ``ModelConfig.model_type``."""
    from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
    from pytorch_scalablefhvae_tpu_torch.models.simple_fhvae import (
        SimpleFHVAE,
    )

    models = {"simple_fhvae": SimpleFHVAE, "fhvae": FHVAE}
    if model_type not in models:
        raise ValueError(f"Unknown model_type {model_type!r}")
    return models[model_type].from_config(
        input_size, cfg, num_seqs, feat_dim=feat_dim or 80,
        generator=generator)
