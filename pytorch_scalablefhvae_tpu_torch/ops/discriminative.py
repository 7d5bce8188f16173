"""Streaming discriminative log q(y | z2) over the mu2 table (forward).

Counterpart of ``pytorch_scalablefhvae_tpu/ops/discriminative.py``
(``discriminative_log_qy_pallas``). For CUDA tensors it runs the kernel in
``csrc/discriminative_fwd.cu``, which never materializes the ``[B, N]``
logits; for CPU tensors it runs :func:`discriminative_log_qy_reference`.
The backward kernel and the sharded form come with later paths.

Semantics shared by both versions, as in the Pallas kernel:
- rows ``n >= num_real`` (mesh padding) get a -1e30 logit bias, so they
  leave the log-sum-exp unchanged;
- an index outside ``[0, N)`` picks nothing: its log_qy is ``-lse``. A
  served request numbers its utterances 0..n-1 and may hold more of them
  than the trained table has rows; that must not fail.

The kernel's launches are counted in ``discriminative_log_qy.launches``.
"""

from __future__ import annotations

import functools
import math

import torch

from pytorch_scalablefhvae_tpu_torch.ops import _build

NEG_INF = -1e30
_TILE = 256


@functools.lru_cache(maxsize=None)
def _target_blocks(device_index: int) -> int:
    """Chunks of the table are spread so that the row tiles and chunks give
    about four blocks per SM of the device."""
    props = torch.cuda.get_device_properties(device_index)
    return 4 * props.multi_processor_count


def discriminative_log_qy_reference(z2_mu, mu2_table, seq_idx, pz2_logvar,
                                    num_real=None):
    """Plain version: the full ``[B, N]`` logits and a log-softmax."""
    n = mu2_table.shape[0]
    num_real = n if num_real is None else int(num_real)
    inv_two_var = 0.5 / math.exp(pz2_logvar)
    cross = z2_mu @ mu2_table.T
    sq = (mu2_table * mu2_table).sum(-1)
    logits = inv_two_var * (2.0 * cross - sq[None, :])
    if num_real < n:
        col = torch.arange(n, device=logits.device)
        logits = torch.where(col[None, :] < num_real, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    seq = seq_idx.long()
    inside = (seq >= 0) & (seq < n)
    picked = logits.gather(1, seq.clamp(0, n - 1)[:, None])[:, 0]
    return torch.where(inside, picked, 0.0) - lse


def discriminative_log_qy(z2_mu, mu2_table, seq_idx, pz2_logvar,
                          num_real=None):
    """``log q(y = seq_idx | z2_mu)``, ``[B]``, under the logits
    ``-|z2_mu - mu2[n]|^2 / (2 exp(pz2_logvar))`` (the ``|z2_mu|^2`` term
    cancels in the softmax and is dropped)."""
    B, D = z2_mu.shape
    N = mu2_table.shape[0]
    if mu2_table.dim() != 2 or mu2_table.shape[1] != D or seq_idx.shape != (B,):
        raise ValueError(
            f"shapes: z2_mu {tuple(z2_mu.shape)}, mu2_table "
            f"{tuple(mu2_table.shape)}, seq_idx {tuple(seq_idx.shape)}")
    if z2_mu.device.type == "cpu":
        return discriminative_log_qy_reference(z2_mu, mu2_table, seq_idx,
                                               pz2_logvar, num_real)
    dev = z2_mu.device
    if dev.type != "cuda":
        raise ValueError(f"the discriminative kernel runs on CUDA tensors, "
                         f"not {dev}")
    for t in (z2_mu, mu2_table):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"the discriminative kernel takes contiguous float32 tensors "
                f"on {dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if seq_idx.device != dev:
        raise ValueError(f"seq_idx is on {seq_idx.device}, not {dev}")
    if torch.is_grad_enabled() and (z2_mu.requires_grad
                                    or mu2_table.requires_grad):
        raise NotImplementedError(
            "the discriminative kernel is forward-only: its backward comes "
            "with the training slice (ROADMAP.md); run under "
            "torch.inference_mode()")
    lib = _build.library()
    if D > lib.sfhvae_disc_max_dim():
        raise ValueError(f"z2 width {D} exceeds the kernel's "
                         f"{lib.sfhvae_disc_max_dim()}")
    if N == 0:
        raise ValueError("the mu2 table is empty")
    num_real = N if num_real is None else int(num_real)
    row_tiles = -(-B // lib.sfhvae_disc_rows_per_block())
    n_chunks = max(1, min(-(-N // _TILE),
                          -(-_target_blocks(dev.index) // max(row_tiles, 1))))
    chunk = -(-N // n_chunks)
    n_chunks = -(-N // chunk)  # no empty chunk
    seq32 = seq_idx.to(torch.int32).contiguous()
    part = torch.empty((3, n_chunks, B), device=dev, dtype=torch.float32)
    out = torch.empty((B,), device=dev, dtype=torch.float32)
    if B == 0:
        return out
    code = lib.sfhvae_disc_fwd(
        z2_mu.data_ptr(), mu2_table.data_ptr(), seq32.data_ptr(),
        part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(),
        out.data_ptr(), B, N, D, num_real, chunk, n_chunks,
        0.5 / math.exp(pz2_logvar), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "discriminative_log_qy")
    discriminative_log_qy.launches += 1
    return out


discriminative_log_qy.launches = 0
