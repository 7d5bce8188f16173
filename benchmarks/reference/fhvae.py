"""The recurrent FHVAE in plain PyTorch (float32, TF32 off), the reference
the benchmark holds the ``fhvae`` configuration's training and dev passes
to.

Hsu & Glass's model: a two-layer LSTM encoder of the segment gives z2's
Gaussian; a second two-layer LSTM reads each frame with z2 appended and
gives z1's; a two-layer LSTM decoder reads ``[z1, z2]`` at every frame and
gives each frame's Gaussian. Each LSTM is written out as a loop over time
and layers; the cell is ``c = sigmoid(f) c + sigmoid(i) tanh(g)``, ``h =
sigmoid(o) tanh(c)`` on ``[x, h] @ w + b``.

``prec`` sets the operand precision of the products: ``{"lstm": ...,
"dense": ...}`` with the kinds of ``common.round_operand``; ``None`` is
float32 everywhere.
"""

from __future__ import annotations

import torch

from reference import common


def _prec(prec: dict | None) -> tuple[str, str]:
    prec = prec or {}
    return prec.get("lstm", "fp32"), prec.get("dense", "fp32")


class FHVAE:
    """The model's forward over a parameter dict; ``cfg`` holds the widths
    (``z1_hus``, ``z2_hus``, ``x_hus``, ``z1_dim``, ``z2_dim``,
    ``feat_dim``, ``seg_len``) and ``pz2_std``."""

    def __init__(self, cfg: dict):
        self.cfg = cfg

    def shapes(self, num_seqs: int) -> dict:
        """Every parameter's shape by name."""
        c = self.cfg
        F, z1, z2 = c["feat_dim"], c["z1_dim"], c["z2_dim"]
        out = {}
        for stack, d_in, hus in (("z2_lstm", F, c["z2_hus"]),
                                 ("z1_lstm", F + z2, c["z1_hus"]),
                                 ("dec_lstm", z1 + z2, c["x_hus"])):
            for i, h in enumerate(hus):
                out[f"{stack}.cells.{i}.w"] = (d_in + h, 4 * h)
                out[f"{stack}.cells.{i}.b"] = (4 * h,)
                d_in = h
        for head, d_in, dim in (("z2_gauss", c["z2_hus"][-1], z2),
                                ("z1_gauss", c["z1_hus"][-1], z1),
                                ("dec_gauss", c["x_hus"][-1], F)):
            for part in ("mu", "logvar"):
                out[f"{head}.{part}.w"] = (d_in, dim)
                out[f"{head}.{part}.b"] = (dim,)
        out["mu2_table"] = (num_seqs, z2)
        return out

    def lstm(self, params: dict, stack: str, xs: torch.Tensor, kind: str):
        """A stacked LSTM over time-major ``xs [T, B, D]``: the top layer's
        output at every step ``[T, B, H]``."""
        seq, i = xs, 0
        while f"{stack}.cells.{i}.w" in params:
            w = params[f"{stack}.cells.{i}.w"]
            b = params[f"{stack}.cells.{i}.b"]
            i += 1
            hid = w.shape[1] // 4
            h = c = xs.new_zeros((xs.shape[1], hid))
            tops = []
            for t in range(xs.shape[0]):
                gates = common.matmul(torch.cat([seq[t], h], dim=-1), w,
                                      kind) + b
                gi, gf, gg, go = gates.chunk(4, dim=-1)
                c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
                h = torch.sigmoid(go) * torch.tanh(c)
                tops.append(h)
            seq = torch.stack(tops)
        return seq

    def encode(self, params: dict, x: torch.Tensor, noise: dict | None,
               prec: dict | None = None) -> dict:
        """Both posteriors of ``x [B, T, F]``; the z2 draw with
        ``noise["z2"]``, the z1 draw with ``noise["z1"]``, else the means."""
        lk, dk = _prec(prec)
        xt = x.float().transpose(0, 1)
        T, B, _ = xt.shape
        noise = noise or {}
        h2 = self.lstm(params, "z2_lstm", xt, lk)[-1]
        z2_mu, z2_logvar, z2 = common.gauss_head(params, "z2_gauss", h2,
                                                 noise.get("z2"), dk)
        xz = torch.cat([xt, z2.expand(T, B, z2.shape[-1])], dim=-1)
        h1 = self.lstm(params, "z1_lstm", xz, lk)[-1]
        z1_mu, z1_logvar, z1 = common.gauss_head(params, "z1_gauss", h1,
                                                 noise.get("z1"), dk)
        return {"z1_mu": z1_mu, "z1_logvar": z1_logvar, "z1": z1,
                "z2_mu": z2_mu, "z2_logvar": z2_logvar, "z2": z2}

    def encode_z2(self, params: dict, x: torch.Tensor,
                  prec: dict | None = None) -> torch.Tensor:
        """z2's posterior mean alone."""
        lk, dk = _prec(prec)
        h2 = self.lstm(params, "z2_lstm", x.float().transpose(0, 1), lk)[-1]
        return common.dense(params, "z2_gauss.mu", h2, dk)

    def forward(self, params: dict, x, seq_idx, nsegs, table=None,
                noise: dict | None = None, prec: dict | None = None) -> dict:
        """Per-row ``lower_bound``, ``log_qy`` and the ELBO's terms, scored
        against ``table`` (default: the learned ``mu2_table``)."""
        lk, dk = _prec(prec)
        table = params["mu2_table"] if table is None else table
        enc = self.encode(params, x, noise, prec)
        T, B = x.shape[1], x.shape[0]
        z = torch.cat([enc["z1"], enc["z2"]], dim=-1)
        tops = self.lstm(params, "dec_lstm", z.expand(T, B, z.shape[-1]), lk)
        x_mu, x_logvar, _ = common.gauss_head(
            params, "dec_gauss", tops.reshape(T * B, -1), None, dk)
        F = self.cfg["feat_dim"]
        x_mu = x_mu.reshape(T, B, F).transpose(0, 1)
        x_logvar = x_logvar.reshape(T, B, F).transpose(0, 1)
        mu2 = table[seq_idx.long()]
        out = common.elbo_terms(x.float(), x_mu, x_logvar, enc, mu2, nsegs,
                                self.cfg["pz2_std"])
        out["log_qy"] = common.log_qy(enc["z2_mu"], table, seq_idx,
                                      self.cfg["pz2_std"])
        return out


Model = FHVAE
