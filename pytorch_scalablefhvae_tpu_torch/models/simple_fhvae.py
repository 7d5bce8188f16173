"""SimpleFHVAE: the MLP factorized hierarchical VAE, as an ``nn.Module``.

Counterpart of ``models/simple_fhvae.py``, the model the reference
repository implements:

- z2 encoder: ``flatten(x)`` -> ReLU MLP (``z2_hus``) -> Gaussian head;
- z1 encoder: ``[flatten(x), z2]`` -> ReLU MLP (``z1_hus``) -> Gaussian head;
- decoder: ``[z1, z2]`` -> ReLU MLP (``x_hus``) -> Gaussian head over the
  flattened segment, reshaped to ``[B, T, F]``;
- the per-sequence mu2 table with the discriminative segment objective.

Parameters keep the JAX tree names (``z2_pre.layers.0.w``, ``z2_gauss.mu.w``,
``mu2_table``, ...), so JAX weights load without a special case
(``train/checkpoint.py``). The MLP products are ``torch.matmul`` (the JAX
package's ``jnp.dot``, outside any kernel); ``log_qy`` goes through
``models/base.py``, so a CUDA tensor scores with the discriminative kernels
and a mesh run through the sharded one.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pytorch_scalablefhvae_tpu_torch.models import layers
from pytorch_scalablefhvae_tpu_torch.models.base import (
    FHVAEOutputs,
    assemble_elbo,
    discriminative_log_qy,
    resolve_mu2_scoring,
)
from pytorch_scalablefhvae_tpu_torch.parallel.mesh import gather_rows


class SimpleFHVAE(nn.Module):
    """MLP FHVAE; the public surface of the port's ``FHVAE``."""

    model_type = "simple_fhvae"

    def __init__(self, input_size: int, z1_hus=(128, 128), z2_hus=(128, 128),
                 z1_dim: int = 16, z2_dim: int = 16, x_hus=(128, 128),
                 num_seqs: int = 1, pz2_std: float = 0.5,
                 mu2_init_std: float = 1.0, compute_dtype: str = "float32",
                 feat_dim: int = 80,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.input_size = input_size
        self.z1_hus, self.z2_hus, self.x_hus = (tuple(z1_hus), tuple(z2_hus),
                                                tuple(x_hus))
        self.z1_dim, self.z2_dim = z1_dim, z2_dim
        self.num_seqs = num_seqs
        # a mesh run pads the table to a multiple of its model axis and
        # keeps one row shard of it here (parallel.mesh.shard_model)
        self.num_seqs_padded = num_seqs
        self.shard_mesh = None
        self.pz2_std = pz2_std
        self.compute_dtype = compute_dtype
        self.feat_dim = feat_dim
        self.z2_pre = layers.MLP(input_size, z2_hus, g)
        self.z2_gauss = layers.GaussHead(z2_hus[-1], z2_dim, g)
        self.z1_pre = layers.MLP(input_size + z2_dim, z1_hus, g)
        self.z1_gauss = layers.GaussHead(z1_hus[-1], z1_dim, g)
        self.dec_pre = layers.MLP(z1_dim + z2_dim, x_hus, g)
        self.dec_gauss = layers.GaussHead(x_hus[-1], input_size, g)
        self.mu2_table = nn.Parameter(
            mu2_init_std * torch.randn((num_seqs, z2_dim), generator=g))

    @classmethod
    def from_config(cls, input_size: int, cfg, num_seqs: int,
                    feat_dim: int = 80, generator=None) -> "SimpleFHVAE":
        """From a ``ModelConfig``; its TPU-only and recurrent fields have no
        meaning here."""
        return cls(input_size, z1_hus=tuple(cfg.z1_hus),
                   z2_hus=tuple(cfg.z2_hus), z1_dim=cfg.z1_dim,
                   z2_dim=cfg.z2_dim, x_hus=tuple(cfg.x_hus),
                   num_seqs=num_seqs, pz2_std=cfg.pz2_std,
                   mu2_init_std=cfg.mu2_init_std,
                   compute_dtype=cfg.compute_dtype, feat_dim=feat_dim,
                   generator=generator)

    @property
    def pz2_logvar(self) -> float:
        return float(math.log(self.pz2_std ** 2))

    @property
    def table_rows(self) -> int:
        """Rows of the mu2 table held here: all of them, or a mesh rank's
        shard of the padded table."""
        return self.mu2_table.shape[0]

    def model_params(self) -> tuple:
        return (self.input_size, list(self.z1_hus), list(self.z2_hus),
                self.z1_dim, self.z2_dim, list(self.x_hus))

    def encode(self, x, sample: bool = False,
               generator: torch.Generator | None = None,
               noise: dict | None = None) -> dict:
        """Posteriors of both latents for ``x [B, T, F]`` (or ``[B, T *
        F]``); with ``sample`` the z2 draw, then the z1 draw, from ``noise``
        or ``generator``."""
        cdt, noise = self.compute_dtype, noise or {}
        flat = x.float().reshape(x.shape[0], -1)
        h2 = layers.mlp(self.z2_pre, flat, cdt)
        z2_mu, z2_logvar, z2 = layers.gauss_head(
            self.z2_gauss, h2, cdt, sample, eps=noise.get("z2"),
            generator=generator)
        h1 = layers.mlp(self.z1_pre, torch.cat([flat, z2], dim=-1), cdt)
        z1_mu, z1_logvar, z1 = layers.gauss_head(
            self.z1_gauss, h1, cdt, sample, eps=noise.get("z1"),
            generator=generator)
        return {"z1_mu": z1_mu, "z1_logvar": z1_logvar, "z1": z1,
                "z2_mu": z2_mu, "z2_logvar": z2_logvar, "z2": z2}

    def encode_z2(self, x) -> torch.Tensor:
        """Posterior mean of the sequence latent alone, ``[B, z2_dim]``: the
        z2 trunk and its ``mu`` head only."""
        flat = x.float().reshape(x.shape[0], -1)
        h2 = layers.mlp(self.z2_pre, flat, self.compute_dtype)
        return layers.dense(self.z2_gauss.mu, h2, self.compute_dtype)

    def decode(self, z1, z2, num_frames: int | None = None,
               sample: bool = False, generator=None):
        """The segment's Gaussian ``(x_mu, x_logvar, x_sample)``, each
        ``[B, T, F]``; ``T`` defaults to ``input_size // feat_dim``."""
        cdt = self.compute_dtype
        h = layers.mlp(self.dec_pre, torch.cat([z1, z2], dim=-1), cdt)
        x_mu, x_logvar, x_sample = layers.gauss_head(
            self.dec_gauss, h, cdt, sample, generator=generator)
        T = num_frames or self.input_size // self.feat_dim
        shape = (z1.shape[0], T, self.input_size // T)
        return tuple(a.reshape(shape) for a in (x_mu, x_logvar, x_sample))

    def apply(self, x, seq_idx, nsegs, sample: bool = False,
              mu2_table: torch.Tensor | None = None,
              generator: torch.Generator | None = None,
              noise: dict | None = None) -> FHVAEOutputs:
        """The full forward: latents, reconstruction, ELBO terms, log_qy.

        ``x [B, T, F]``, ``seq_idx [B]`` table rows, ``nsegs [B]`` segment
        counts of each row's sequence; ``mu2_table`` overrides the learned
        table (a split's MAP estimates). Noise, the mesh's table shard and
        out-of-table indices as in ``FHVAE.apply``; the decoder runs on the
        means' draws without sampling, as in the JAX model.
        """
        x = x.float()
        enc = self.encode(x, sample, generator, noise)
        x_mu, x_logvar, _ = self.decode(enc["z1"], enc["z2"],
                                        num_frames=x.shape[1])

        table, num_real, mesh = resolve_mu2_scoring(self, mu2_table)
        # JAX clamps an out-of-bounds gather; a served request may number
        # more utterances than the table has rows, and must still run
        if mesh is None:
            mu2 = table[seq_idx.long().clamp(0, table.shape[0] - 1)]
        else:
            mu2 = gather_rows(
                table, seq_idx.long().clamp(0, self.num_seqs_padded - 1), mesh)
        lower_bound, log_px_z, neg_kld_z1, neg_kld_z2, log_pmu2 = assemble_elbo(
            x, mu2, enc["z1_mu"], enc["z1_logvar"], enc["z2_mu"],
            enc["z2_logvar"], x_mu, x_logvar, nsegs,
            pz2_logvar=self.pz2_logvar, frame_axes=(1, 2))
        log_qy = discriminative_log_qy(enc["z2_mu"], table, seq_idx,
                                       self.pz2_logvar, num_real, mesh)
        return FHVAEOutputs(
            lower_bound=lower_bound, log_qy=log_qy, log_px_z=log_px_z,
            neg_kld_z1=neg_kld_z1, neg_kld_z2=neg_kld_z2, log_pmu2=log_pmu2,
            z1_mu=enc["z1_mu"], z2_mu=enc["z2_mu"], x_mu=x_mu,
            x_logvar=x_logvar)
