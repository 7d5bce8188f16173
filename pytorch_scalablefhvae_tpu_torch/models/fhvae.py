"""FHVAE: the recurrent factorized hierarchical VAE, as an ``nn.Module``.

Counterpart of ``models/fhvae.py``. Parameters keep the JAX layout and tree
names (``z2_lstm.cells.0.w``, ``z2_gauss.mu.w``, ``mu2_table``, ...): an LSTM
cell is one fused ``w [d_in + H, 4H]`` with the input rows on top, gate
order i, f, g, o, and forget-gate bias 1.0, so JAX weights load without a
transpose (``train/checkpoint.py``).

Every forward follows the JAX package's time-major fused dataflow
(``FHVAE._apply_fused``):
- x is transposed to ``[T, B, D]`` once;
- the z2 and z1 encoders run the projection-fused recurrence kernel, and the
  z1 encoder's z2 input never joins x: its gate block
  ``z2 @ W[D:D+z2] + b`` is computed once per segment (``xgc``);
- the decoder's input is the same ``[z1, z2]`` at every frame, so its gate
  block is computed once per segment and the kernel reads it at every step;
- the ELBO reduces over the time-major reconstruction.

The recurrences run the CUDA kernels for CUDA tensors and their plain
versions on the CPU (``ops/lstm_cuda.py``). Which route a stack takes is
decided by its shape alone, once, when the model is built
(:meth:`LSTMStack.kernel_takes`): two equal-width layers, T >= 2 and a
width within the kernels' block (``lstm_cuda.MAX_H``) take the kernels;
every other stack (one or three cells, unequal widths, T = 1, and wide
two-layer stacks, which the JAX package sends from its Pallas recurrence to
the scan when they are over its VMEM budget) runs :func:`plain_stack`, a
time loop per layer in plain PyTorch on any device: the counterpart of the
JAX package's scan path, on which the reference has no Pallas kernel. On
that route the z1 stack reads ``[x, z2]`` and the decoder ``[z1, z2]`` at
every frame, as the scan path does, and the operands are rounded by
``compute_dtype``, not ``lstm_mm_dtype`` (which only the kernels read).
``plain_stack_calls`` counts its calls. The wavefront schedule, scan unroll
and VMEM gates have no counterpart here.
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
from pytorch_scalablefhvae_tpu_torch.ops import lstm_cuda
from pytorch_scalablefhvae_tpu_torch.parallel.mesh import gather_rows


# calls of plain_stack, on every device: a stack the kernels take never
# gets here, so on CUDA it counts the stacks they do not take
plain_stack_calls = 0


def plain_stack(cells, xs: torch.Tensor, compute_dtype: str = "float32"):
    """A stacked LSTM over time-major ``xs [T, B, D]`` as the JAX scan path
    runs it (``run_lstm``): per layer the input projection of all steps at
    once, then a time loop of the recurrent product and the cell; operands
    rounded to bf16 with ``compute_dtype="bfloat16"``, products and sums in
    fp32. ``cells``: ``[(w, b), ...]``, ``w [d_in + H, 4H]`` (input rows
    first). Returns ``(tops [T, B, H_last], h_last [B, H_last])``;
    differentiable by autograd."""
    global plain_stack_calls
    plain_stack_calls += 1
    T, B, _ = xs.shape
    seq, h = xs, None
    for w, b in cells:
        hid = w.shape[1] // 4
        d_in = w.shape[0] - hid
        w_x, w_h = w[:d_in], w[d_in:]
        xg = layers.matmul(seq.reshape(T * B, d_in), w_x, compute_dtype) \
            .reshape(T, B, 4 * hid) + b
        h = c = xs.new_zeros((B, hid))
        tops = []
        for t in range(T):
            h, c = lstm_cuda._cell(xg[t] + layers.matmul(h, w_h,
                                                          compute_dtype), c)
            tops.append(h)
        seq = torch.stack(tops)
    return seq, h


class LSTMCell(nn.Module):
    def __init__(self, d_in: int, hid: int, generator: torch.Generator):
        super().__init__()
        limit = math.sqrt(6.0 / (d_in + hid + 4 * hid))
        self.w = nn.Parameter(layers.uniform((d_in + hid, 4 * hid), limit,
                                             generator))
        b = torch.zeros(4 * hid)
        b[hid:2 * hid] = 1.0  # forget-gate bias 1.0
        self.b = nn.Parameter(b)


class LSTMStack(nn.Module):
    def __init__(self, d_in: int, widths, generator: torch.Generator):
        super().__init__()
        cells, d = [], d_in
        for w in widths:
            cells.append(LSTMCell(d, w, generator))
            d = w
        self.cells = nn.ModuleList(cells)

    def pairs(self):
        """``[(w, b), ...]``, the form the recurrence ops take."""
        return [(c.w, c.b) for c in self.cells]

    def two_layer_ok(self, T: int) -> bool:
        """The kernel's rule (``_two_layer_ok``): two equal-width layers and
        at least two steps."""
        if len(self.cells) != 2:
            return False
        w1, w2 = self.cells[0].w, self.cells[1].w
        hid = w2.shape[1] // 4
        return w1.shape[1] == w2.shape[1] and w2.shape[0] == 2 * hid and T >= 2

    def kernel_takes(self, T: int) -> bool:
        """Whether the recurrence kernels take this stack at ``T`` steps:
        :meth:`two_layer_ok` and a hidden width within their block."""
        return (self.two_layer_ok(T)
                and self.cells[1].w.shape[1] // 4 <= lstm_cuda.MAX_H)


class FHVAE(nn.Module):
    """Recurrent FHVAE; the public surface of the JAX ``FHVAE``."""

    model_type = "fhvae"

    def __init__(self, input_size: int, z1_hus=(128, 128), z2_hus=(128, 128),
                 z1_dim: int = 16, z2_dim: int = 16, x_hus=(128, 128),
                 num_seqs: int = 1, pz2_std: float = 0.5,
                 mu2_init_std: float = 1.0, compute_dtype: str = "float32",
                 lstm_mm_dtype: str = "bfloat16", feat_dim: int = 80,
                 generator: torch.Generator | None = None):
        super().__init__()
        if lstm_mm_dtype not in lstm_cuda.MM_DTYPES:
            raise ValueError(f"lstm_mm_dtype must be one of "
                             f"{lstm_cuda.MM_DTYPES}")
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
        self.lstm_mm_dtype = lstm_mm_dtype
        self.feat_dim = feat_dim
        self.z2_lstm = LSTMStack(feat_dim, z2_hus, g)
        self.z2_gauss = layers.GaussHead(z2_hus[-1], z2_dim, g)
        self.z1_lstm = LSTMStack(feat_dim + z2_dim, z1_hus, g)
        self.z1_gauss = layers.GaussHead(z1_hus[-1], z1_dim, g)
        self.dec_lstm = LSTMStack(z1_dim + z2_dim, x_hus, g)
        self.dec_gauss = layers.GaussHead(x_hus[-1], feat_dim, g)
        self.mu2_table = nn.Parameter(
            mu2_init_std * torch.randn((num_seqs, z2_dim), generator=g))
        # each stack's route, by its shape at the segment's T
        T = input_size // feat_dim
        self.kernel_stacks = {name: getattr(self, name).kernel_takes(T)
                              for name in ("z2_lstm", "z1_lstm", "dec_lstm")}

    @classmethod
    def from_config(cls, input_size: int, cfg, num_seqs: int,
                    feat_dim: int = 80, generator=None) -> "FHVAE":
        """From a ``ModelConfig``; its TPU-only fields (``use_pallas``,
        ``lstm_pallas``, ``scan_unroll``) have no meaning here."""
        return cls(input_size, z1_hus=tuple(cfg.z1_hus),
                   z2_hus=tuple(cfg.z2_hus), z1_dim=cfg.z1_dim,
                   z2_dim=cfg.z2_dim, x_hus=tuple(cfg.x_hus),
                   num_seqs=num_seqs, pz2_std=cfg.pz2_std,
                   mu2_init_std=cfg.mu2_init_std,
                   compute_dtype=cfg.compute_dtype,
                   lstm_mm_dtype=cfg.lstm_mm_dtype, feat_dim=feat_dim,
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

    # ------------------------------------------------------------ pieces

    def _z2_trunk(self, xt):
        """The z2 stack's last hidden state ``[B, H]`` on ``xt [T, B, D]``."""
        if self.kernel_stacks["z2_lstm"]:
            return lstm_cuda.lstm2_tm_proj(self.z2_lstm.pairs(), xt, None,
                                           self.lstm_mm_dtype,
                                           with_tops=False)[1]
        return plain_stack(self.z2_lstm.pairs(), xt, self.compute_dtype)[1]

    def _encode_tm(self, xt, sample, generator, noise=None):
        """Both encoders on time-major ``xt [T, B, D]``."""
        T, B, D = xt.shape
        cdt, mm = self.compute_dtype, self.lstm_mm_dtype
        noise = noise or {}
        h2 = self._z2_trunk(xt)
        z2_mu, z2_logvar, z2 = layers.gauss_head(
            self.z2_gauss, h2, cdt, sample, eps=noise.get("z2"),
            generator=generator)
        if self.kernel_stacks["z1_lstm"]:
            c1 = self.z1_lstm.cells[0]
            xg_z = layers.matmul(z2, c1.w[D:D + z2.shape[-1]], cdt) + c1.b
            _, h1 = lstm_cuda.lstm2_tm_proj(self.z1_lstm.pairs(), xt, xg_z,
                                            mm, with_tops=False)
        else:
            xz = torch.cat([xt, z2.expand(T, B, z2.shape[-1])], dim=-1)
            _, h1 = plain_stack(self.z1_lstm.pairs(), xz, cdt)
        z1_mu, z1_logvar, z1 = layers.gauss_head(
            self.z1_gauss, h1, cdt, sample, eps=noise.get("z1"),
            generator=generator)
        return {"z1_mu": z1_mu, "z1_logvar": z1_logvar, "z1": z1,
                "z2_mu": z2_mu, "z2_logvar": z2_logvar, "z2": z2}

    def _decode_tm(self, z1, z2, T: int):
        """Decoder: ``(x_mu, x_logvar)``, each time-major ``[T, B, F]``."""
        B = z1.shape[0]
        z = torch.cat([z1, z2], dim=-1)
        if self.kernel_stacks["dec_lstm"]:
            c1 = self.dec_lstm.cells[0]
            xg_c = layers.matmul(z, c1.w[: z.shape[-1]],
                                 self.compute_dtype) + c1.b  # [B, 4H]
            tops, _ = lstm_cuda.lstm2_tm(self.dec_lstm.pairs(), xg_c, T=T,
                                         mm_dtype=self.lstm_mm_dtype)
        else:
            tops, _ = plain_stack(self.dec_lstm.pairs(),
                                  z.expand(T, B, z.shape[-1]),
                                  self.compute_dtype)
        x_mu, x_logvar, _ = layers.gauss_head(
            self.dec_gauss, tops.reshape(T * B, -1), self.compute_dtype)
        return (x_mu.reshape(T, B, self.feat_dim),
                x_logvar.reshape(T, B, self.feat_dim))

    # ------------------------------------------------------------ surface

    def encode(self, x, sample: bool = False,
               generator: torch.Generator | None = None) -> dict:
        """Posteriors of both latents for ``x [B, T, D]``."""
        return self._encode_tm(x.float().transpose(0, 1).contiguous(),
                               sample, generator)

    def decode(self, z1, z2, num_frames: int | None = None,
               sample: bool = False, generator=None):
        """Per-frame Gaussians ``(x_mu, x_logvar, x_sample)``, each
        ``[B, T, F]``; ``T`` defaults to ``input_size // feat_dim``."""
        T = num_frames or self.input_size // self.feat_dim
        x_mu, x_logvar = (a.transpose(0, 1)
                          for a in self._decode_tm(z1, z2, T))
        if not sample:
            return x_mu, x_logvar, x_mu
        eps = torch.randn(x_mu.shape, generator=generator,
                          device=x_mu.device)
        return x_mu, x_logvar, x_mu + eps * torch.exp(0.5 * x_logvar)

    def encode_z2(self, x) -> torch.Tensor:
        """Posterior mean of the sequence latent alone, ``[B, z2_dim]``."""
        h2 = self._z2_trunk(x.float().transpose(0, 1).contiguous())
        return layers.dense(self.z2_gauss.mu, h2, self.compute_dtype)

    def apply(self, x, seq_idx, nsegs, sample: bool = False,
              mu2_table: torch.Tensor | None = None,
              generator: torch.Generator | None = None,
              noise: dict | None = None) -> FHVAEOutputs:
        """The full forward: latents, reconstruction, ELBO terms, log_qy.

        ``x [B, T, D]``, ``seq_idx [B]`` table rows, ``nsegs [B]`` segment
        counts of each row's sequence. ``mu2_table`` overrides the learned
        table (a split's MAP estimates). In a mesh run (``shard_mesh``) the
        learned table is this rank's row shard: its rows are gathered and
        scored through the model group, and all ranks of a model group must
        pass the same batch rows. The serving path runs
        ``sample=False`` and draws nothing. Training runs ``sample=True``:
        the z2 noise, then the z1 noise, come from ``noise={"z2": eps2 [B,
        z2], "z1": eps1 [B, z1]}`` when given (the tests hand in the JAX
        draws) or are drawn from ``generator``, which lives on ``x``'s device.
        Gradients reach every parameter, the mu2 table through both the ELBO
        gather and log_qy.
        """
        B, T, _ = x.shape
        xt = x.float().transpose(0, 1).contiguous()
        enc = self._encode_tm(xt, sample, generator, noise)
        x_mu_tm, x_logvar_tm = self._decode_tm(enc["z1"], enc["z2"], T)

        table, num_real, mesh = resolve_mu2_scoring(self, mu2_table)
        # JAX clamps an out-of-bounds gather; a served request may number
        # more utterances than the table has rows, and must still run
        if mesh is None:
            mu2 = table[seq_idx.long().clamp(0, table.shape[0] - 1)]
        else:
            mu2 = gather_rows(
                table, seq_idx.long().clamp(0, self.num_seqs_padded - 1), mesh)
        lower_bound, log_px_z, neg_kld_z1, neg_kld_z2, log_pmu2 = assemble_elbo(
            xt, mu2, enc["z1_mu"], enc["z1_logvar"], enc["z2_mu"],
            enc["z2_logvar"], x_mu_tm, x_logvar_tm, nsegs,
            pz2_logvar=self.pz2_logvar, frame_axes=(0, 2))
        log_qy = discriminative_log_qy(enc["z2_mu"], table, seq_idx,
                                       self.pz2_logvar, num_real, mesh)
        return FHVAEOutputs(
            lower_bound=lower_bound, log_qy=log_qy, log_px_z=log_px_z,
            neg_kld_z1=neg_kld_z1, neg_kld_z2=neg_kld_z2, log_pmu2=log_pmu2,
            z1_mu=enc["z1_mu"], z2_mu=enc["z2_mu"],
            x_mu=x_mu_tm.transpose(0, 1), x_logvar=x_logvar_tm.transpose(0, 1))
