"""The MLP FHVAE of BurnhamG/PyTorch-ScalableFHVAE (``simple_fhvae.py``) in
plain PyTorch (float32, TF32 off), the reference the benchmark holds the
``simple_fhvae`` configuration's training and dev passes to.

z2's encoder is a ReLU MLP over the flattened segment; z1's reads the
flattened segment with z2 appended; the decoder's ReLU MLP reads ``[z1,
z2]`` and gives the flattened segment's Gaussian. ``prec`` as in
``reference/fhvae.py``; every product here is a dense one.
"""

from __future__ import annotations

import torch

from reference import common


class SimpleFHVAE:
    """The model's forward over a parameter dict; ``cfg`` holds the widths
    (``z1_hus``, ``z2_hus``, ``x_hus``, ``z1_dim``, ``z2_dim``,
    ``feat_dim``, ``seg_len``) and ``pz2_std``."""

    def __init__(self, cfg: dict):
        self.cfg = cfg

    def shapes(self, num_seqs: int) -> dict:
        """Every parameter's shape by name."""
        c = self.cfg
        d = c["seg_len"] * c["feat_dim"]
        z1, z2 = c["z1_dim"], c["z2_dim"]
        out = {}
        for mlp, d_in, hus in (("z2_pre", d, c["z2_hus"]),
                               ("z1_pre", d + z2, c["z1_hus"]),
                               ("dec_pre", z1 + z2, c["x_hus"])):
            for i, h in enumerate(hus):
                out[f"{mlp}.layers.{i}.w"] = (d_in, h)
                out[f"{mlp}.layers.{i}.b"] = (h,)
                d_in = h
        for head, d_in, dim in (("z2_gauss", c["z2_hus"][-1], z2),
                                ("z1_gauss", c["z1_hus"][-1], z1),
                                ("dec_gauss", c["x_hus"][-1], d)):
            for part in ("mu", "logvar"):
                out[f"{head}.{part}.w"] = (d_in, dim)
                out[f"{head}.{part}.b"] = (dim,)
        out["mu2_table"] = (num_seqs, z2)
        return out

    @staticmethod
    def mlp(params: dict, prefix: str, x: torch.Tensor, kind: str):
        i = 0
        while f"{prefix}.layers.{i}.w" in params:
            x = torch.relu(common.dense(params, f"{prefix}.layers.{i}", x,
                                        kind))
            i += 1
        return x

    def encode(self, params: dict, x: torch.Tensor, noise: dict | None,
               prec: dict | None = None) -> dict:
        kind = (prec or {}).get("dense", "fp32")
        noise = noise or {}
        flat = x.float().reshape(x.shape[0], -1)
        h2 = self.mlp(params, "z2_pre", flat, kind)
        z2_mu, z2_logvar, z2 = common.gauss_head(params, "z2_gauss", h2,
                                                 noise.get("z2"), kind)
        h1 = self.mlp(params, "z1_pre", torch.cat([flat, z2], dim=-1), kind)
        z1_mu, z1_logvar, z1 = common.gauss_head(params, "z1_gauss", h1,
                                                 noise.get("z1"), kind)
        return {"z1_mu": z1_mu, "z1_logvar": z1_logvar, "z1": z1,
                "z2_mu": z2_mu, "z2_logvar": z2_logvar, "z2": z2}

    def encode_z2(self, params: dict, x: torch.Tensor,
                  prec: dict | None = None) -> torch.Tensor:
        kind = (prec or {}).get("dense", "fp32")
        h2 = self.mlp(params, "z2_pre", x.float().reshape(x.shape[0], -1),
                      kind)
        return common.dense(params, "z2_gauss.mu", h2, kind)

    def forward(self, params: dict, x, seq_idx, nsegs, table=None,
                noise: dict | None = None, prec: dict | None = None) -> dict:
        kind = (prec or {}).get("dense", "fp32")
        table = params["mu2_table"] if table is None else table
        enc = self.encode(params, x, noise, prec)
        h = self.mlp(params, "dec_pre", torch.cat([enc["z1"], enc["z2"]],
                                                  dim=-1), kind)
        x_mu, x_logvar, _ = common.gauss_head(params, "dec_gauss", h, None,
                                              kind)
        x_mu, x_logvar = x_mu.reshape(x.shape), x_logvar.reshape(x.shape)
        mu2 = table[seq_idx.long()]
        out = common.elbo_terms(x.float(), x_mu, x_logvar, enc, mu2, nsegs,
                                self.cfg["pz2_std"])
        out["log_qy"] = common.log_qy(enc["z2_mu"], table, seq_idx,
                                      self.cfg["pz2_std"])
        return out


Model = SimpleFHVAE
