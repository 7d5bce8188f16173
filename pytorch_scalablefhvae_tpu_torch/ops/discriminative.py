"""Streaming discriminative log q(y | z2) over the mu2 table.

Counterpart of ``pytorch_scalablefhvae_tpu/ops/discriminative.py``
(``discriminative_log_qy_pallas``, its VJP, and
``discriminative_log_qy_pallas_sharded``). Four entries, each with its plain
PyTorch version (``<entry>_reference``):

- :func:`discriminative_log_qy`: the forward (``csrc/discriminative_fwd.cu``),
  which never materializes the ``[B, N]`` logits; differentiable;
- :func:`discriminative_log_qy_bwd`: its backward
  (``csrc/discriminative_bwd.cu``), which recomputes the softmax from the
  saved log-sum-exp;
- :func:`discriminative_log_qy_sharded`: the forward over a ``(data, model)``
  mesh of ranks (``parallel/mesh.py``). Every rank holds one row shard of the
  table; the same streaming kernel runs on the shard with the shard's row
  offset and stops at the online partials ``(m, s, picked)`` per batch row
  (:func:`shard_partials`), which the ranks of the model group merge with two
  all-reduces: ``m* = max m``, then the sum of ``[s e^(m - m*), picked]``;
  ``log_qy = picked* - (m* + log s*)``. Differentiable;
- :func:`discriminative_log_qy_sharded_bwd`: the per-shard backward from the
  log-sum-exp over the whole table: ``dz2`` is the shard's part (the
  autograd Function adds the model group's), ``dmu2`` the shard's own for
  this rank's batch rows. The caller sums ``dmu2`` over the data group: the
  train step does so for every gradient at once (``train/step.py``).

Each runs its kernel for CUDA tensors and its plain version for CPU tensors.
The plain forwards are differentiable too, and their backward is the plain
backward. The kernels take ``seq_idx`` as int32 or int64, as it comes.

Semantics shared by all versions, as in the Pallas kernels:
- rows ``n >= num_real`` (mesh padding) get a -1e30 logit bias, so they
  leave the log-sum-exp unchanged and get exactly zero gradient;
- an index outside ``[0, N)`` picks nothing: its log_qy is ``-lse``. A
  served request numbers its utterances 0..n-1 and may hold more of them
  than the trained table has rows; that must not fail;
- a shard made only of padding reports ``m = -1e30`` exactly, and
  ``e^(m - m*)`` is then exactly 0: it leaves the merged result unchanged.

The kernels' launches are counted in ``<entry>.launches``.
"""

from __future__ import annotations

import functools
import math

import torch

from pytorch_scalablefhvae_tpu_torch.ops import _build

NEG_INF = -1e30
# the kernels' tiles (csrc/discriminative_common.cuh) and the most table
# tiles a chunk of the backward may hold (csrc/discriminative_bwd.cu)
_BATCH_TILE, _TABLE_TILE, _BWD_MAX_CHUNK_TILES = 64, 128, 8
# the forward cuts the table into about target_blocks / 32 chunks: few
# partials for its combine to read, and chunks x groups still fill the card
_FWD_BLOCKS_PER_CHUNK = 32
# the kernels read seq_idx as it comes: int64 (1) or int32 (0)
_SEQ64 = {torch.int64: 1, torch.int32: 0}


@functools.lru_cache(maxsize=None)
def _target_blocks(device_index: int) -> int:
    """The kernels cut the table and the batch into about four blocks per
    SM of the device."""
    props = torch.cuda.get_device_properties(device_index)
    return 4 * props.multi_processor_count


def _logits(z2_mu, mu2_table, pz2_logvar, num_real):
    n = mu2_table.shape[0]
    inv_two_var = 0.5 / math.exp(pz2_logvar)
    cross = z2_mu @ mu2_table.T
    sq = (mu2_table * mu2_table).sum(-1)
    logits = inv_two_var * (2.0 * cross - sq[None, :])
    if num_real < n:
        col = torch.arange(n, device=logits.device)
        logits = torch.where(col[None, :] < num_real, logits, NEG_INF)
    return logits


def _forward_plain(z2_mu, mu2_table, seq_idx, pz2_logvar, num_real):
    """The full ``[B, N]`` logits and a log-softmax: ``(log_qy, lse)``."""
    n = mu2_table.shape[0]
    logits = _logits(z2_mu, mu2_table, pz2_logvar, num_real)
    lse = torch.logsumexp(logits, dim=-1)
    seq = seq_idx.long()
    inside = (seq >= 0) & (seq < n)
    picked = logits.gather(1, seq.clamp(0, n - 1)[:, None])[:, 0]
    return torch.where(inside, picked, 0.0) - lse, lse


def shard_partials_reference(z2_mu, mu2_local, seq_idx, pz2_logvar, num_real,
                             row_offset):
    """Plain version of :func:`shard_partials`: the full ``[B, N_loc]``
    logits, their max, the sum of their exponentials and a masked gather."""
    n = mu2_local.shape[0]
    logits = _logits(z2_mu, mu2_local, pz2_logvar, num_real - row_offset)
    m = logits.max(dim=-1).values
    s = torch.exp(logits - m[:, None]).sum(-1)
    local = seq_idx.long() - row_offset
    inside = (local >= 0) & (local < n)
    picked = logits.gather(1, local.clamp(0, n - 1)[:, None])[:, 0]
    return m, s, torch.where(inside, picked, 0.0)


def discriminative_log_qy_bwd_reference(z2_mu, mu2_table, seq_idx, lse, g,
                                        pz2_logvar, num_real, row_offset=0):
    """Plain version of :func:`discriminative_log_qy_bwd` and, with the
    shard's ``row_offset`` and the whole table's ``lse``, of
    :func:`discriminative_log_qy_sharded_bwd`."""
    n = mu2_table.shape[0]
    p = torch.exp(_logits(z2_mu, mu2_table, pz2_logvar, num_real - row_offset)
                  - lse[:, None])
    col = torch.arange(n, device=p.device)
    onehot = (col[None, :] == (seq_idx.long() - row_offset)[:, None]).float()
    dlogits = g[:, None] * (onehot - p)
    c2 = 1.0 / math.exp(pz2_logvar)  # 2 / (2 sigma^2)
    dz2 = c2 * (dlogits @ mu2_table)
    dmu2 = c2 * (dlogits.T @ z2_mu - mu2_table * dlogits.sum(0)[:, None])
    return dz2, dmu2


def _check(z2_mu, mu2_table, seq_idx, *more):
    B, D = z2_mu.shape
    if mu2_table.dim() != 2 or mu2_table.shape[1] != D or seq_idx.shape != (B,):
        raise ValueError(
            f"shapes: z2_mu {tuple(z2_mu.shape)}, mu2_table "
            f"{tuple(mu2_table.shape)}, seq_idx {tuple(seq_idx.shape)}")
    for t in more:
        if t is not None and t.shape != (B,):
            raise ValueError(f"per-row input of shape {tuple(t.shape)}; "
                             f"expected ({B},)")


def _library(z2_mu, mu2_table, seq_idx, *more):
    """Check the tensors the kernels take; returns the loaded library."""
    dev = z2_mu.device
    if dev.type != "cuda":
        raise ValueError(f"the discriminative kernels run on CUDA tensors, "
                         f"not {dev}")
    for t in (z2_mu, mu2_table, *more):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"the discriminative kernels take contiguous float32 tensors "
                f"on {dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if seq_idx.device != dev or seq_idx.dtype not in _SEQ64:
        raise ValueError(f"seq_idx must be an int32 or int64 tensor on {dev}; "
                         f"got {seq_idx.dtype} on {seq_idx.device}")
    lib = _build.library()
    D = z2_mu.shape[1]
    if D > lib.sfhvae_disc_max_dim():
        raise ValueError(f"z2 width {D} exceeds the kernels' "
                         f"{lib.sfhvae_disc_max_dim()}")
    if mu2_table.shape[0] == 0:
        raise ValueError("the mu2 table is empty")
    return lib


def _groups(B: int, n_chunks: int, target_blocks: int) -> tuple[int, int]:
    """``(group_tiles, n_groups)``: groups of 64-row batch tiles that bring
    ``n_chunks`` x groups up to about ``target_blocks``; none is empty."""
    b_tiles = max(1, -(-B // _BATCH_TILE))
    group_tiles = -(-b_tiles // max(1, target_blocks // n_chunks))
    return group_tiles, -(-b_tiles // group_tiles)


def fwd_geometry(B: int, N: int,
                 target_blocks: int) -> tuple[int, int, int, int]:
    """How the forward kernel cuts ``B`` batch rows and ``N`` table rows:
    ``(chunk_tiles, n_chunks, group_tiles, n_groups)``. A chunk holds
    ``chunk_tiles`` 128-row table tiles and depends on ``N`` alone, so a
    row's ``log_qy`` and ``lse`` do not depend on the batch split. The
    forward carries three numbers a row across a chunk, so its chunks may be
    long: at most ``target_blocks / 32`` of them, for a combine that reads few
    partials. The groups of 64-row batch tiles then bring chunks x groups up
    to about ``target_blocks``. No chunk and no group is empty."""
    n_tiles = -(-N // _TABLE_TILE)
    chunk_tiles = -(-n_tiles // max(1, target_blocks // _FWD_BLOCKS_PER_CHUNK))
    n_chunks = -(-n_tiles // chunk_tiles)
    return (chunk_tiles, n_chunks, *_groups(B, n_chunks, target_blocks))


def bwd_geometry(B: int, N: int,
                 target_blocks: int) -> tuple[int, int, int, int]:
    """How the backward kernel cuts ``B`` batch rows and ``N`` table rows:
    ``(chunk_tiles, n_chunks, group_tiles, n_groups)``. A chunk holds
    ``chunk_tiles`` 128-row table tiles (at most 8) and depends on ``N``
    alone, so a ``dz2`` row does not depend on the batch split; about
    ``target_blocks`` chunks fill the card. The groups of 64-row batch tiles
    then bring chunks x groups up to about ``target_blocks``. No chunk and no
    group is empty."""
    n_tiles = -(-N // _TABLE_TILE)
    chunk_tiles = min(_BWD_MAX_CHUNK_TILES, -(-n_tiles // target_blocks))
    n_chunks = -(-n_tiles // chunk_tiles)
    return (chunk_tiles, n_chunks, *_groups(B, n_chunks, target_blocks))


def _forward_partials(entry, z2_mu, mu2_table, seq_idx, pz2_logvar, num_real,
                      row_offset, n_out):
    """Run ``csrc/discriminative_fwd.cu`` (counted on ``entry``): the
    single table's ``(log_qy, lse)`` when ``row_offset`` is None, else the
    shard's ``(m, s, picked)``. One allocation holds the chunks' partials
    and the ``n_out`` outputs, each ``[B]``."""
    lib = _library(z2_mu, mu2_table, seq_idx)
    B, D = z2_mu.shape
    N = mu2_table.shape[0]
    dev = z2_mu.device
    if B == 0:
        return torch.empty((n_out, 0), device=dev).unbind()
    geometry = fwd_geometry(B, N, _target_blocks(dev.index))
    n_chunks = geometry[1]
    buf = torch.empty(((3 * n_chunks + n_out) * B,), device=dev,
                      dtype=torch.float32)
    ptr = buf.data_ptr()
    outs = [ptr + 4 * (3 * n_chunks + i) * B for i in range(n_out)]
    seq_idx = seq_idx.contiguous()
    common = (z2_mu.data_ptr(), mu2_table.data_ptr(), seq_idx.data_ptr(),
              _SEQ64[seq_idx.dtype], ptr)
    stream = torch.cuda.current_stream(dev).cuda_stream
    inv_two_var = 0.5 / math.exp(pz2_logvar)
    if row_offset is None:
        code = lib.sfhvae_disc_fwd(*common, *outs, B, N, D, num_real,
                                   *geometry, inv_two_var, stream)
    else:
        code = lib.sfhvae_disc_partials(*common, *outs, B, N, D, num_real,
                                        row_offset, *geometry, inv_two_var,
                                        stream)
    _build.check(code, entry.__name__)
    entry.launches += 1
    return buf[3 * n_chunks * B:].view(n_out, B).unbind()


def fwd_probe(z2_mu, mu2_table, seq_idx, pz2_logvar, num_real, probe: int):
    """A callable that launches the forward's partials pass alone on these
    inputs, for timing (``chip_smoke.py``): ``probe`` 0 as the entry runs
    it, 1 without the exps, 2 without the cross terms."""
    lib = _library(z2_mu, mu2_table, seq_idx)
    B, D = z2_mu.shape
    N = mu2_table.shape[0]
    dev = z2_mu.device
    geometry = fwd_geometry(B, N, _target_blocks(dev.index))
    part = torch.empty((3 * geometry[1] * B,), device=dev)
    seq_idx = seq_idx.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        _build.check(lib.sfhvae_disc_fwd_probe(
            z2_mu.data_ptr(), mu2_table.data_ptr(), seq_idx.data_ptr(),
            _SEQ64[seq_idx.dtype], part.data_ptr(), B, N, D, num_real,
            *geometry, 0.5 / math.exp(pz2_logvar), probe, stream),
            "discriminative forward probe")
    return launch


def _forward_kernel(z2_mu, mu2_table, seq_idx, pz2_logvar, num_real,
                    with_lse):
    """Run ``csrc/discriminative_fwd.cu``: ``(log_qy, lse | None)``."""
    out, lse = _forward_partials(discriminative_log_qy, z2_mu, mu2_table,
                                 seq_idx, pz2_logvar, num_real, None, 2)
    return out, (lse if with_lse else None)


def _backward(entry, z2_mu, mu2_table, seq_idx, lse, g, pz2_logvar, num_real,
              row_offset):
    """Run ``csrc/discriminative_bwd.cu`` on CUDA tensors (counted on
    ``entry``), the plain backward on CPU tensors."""
    _check(z2_mu, mu2_table, seq_idx, lse, g)
    if z2_mu.device.type == "cpu":
        return discriminative_log_qy_bwd_reference(
            z2_mu, mu2_table, seq_idx, lse, g, pz2_logvar, num_real,
            row_offset)
    g = g.contiguous()
    lib = _library(z2_mu, mu2_table, seq_idx, lse, g)
    B, D = z2_mu.shape
    N = mu2_table.shape[0]
    dev = z2_mu.device
    dz2 = torch.empty_like(z2_mu)
    if B == 0:
        return dz2, torch.zeros_like(mu2_table)
    chunk_tiles, n_chunks, group_tiles, n_groups = bwd_geometry(
        B, N, _target_blocks(dev.index))
    dmu2 = torch.empty_like(mu2_table)
    # the fused pass's partials, added in a fixed order by the second kernel
    part_z = torch.empty((n_chunks, B, D), device=dev, dtype=torch.float32)
    part_mu = (torch.empty((n_groups, N, D + 1), device=dev,
                           dtype=torch.float32) if n_groups > 1 else None)
    seq_idx = seq_idx.contiguous()
    code = lib.sfhvae_disc_bwd(
        z2_mu.data_ptr(), mu2_table.data_ptr(), seq_idx.data_ptr(),
        _SEQ64[seq_idx.dtype], lse.data_ptr(), g.data_ptr(), dz2.data_ptr(),
        dmu2.data_ptr(),
        part_z.data_ptr(), None if part_mu is None else part_mu.data_ptr(),
        B, N, D, int(num_real), int(row_offset), chunk_tiles, n_chunks,
        group_tiles, n_groups, 0.5 / math.exp(pz2_logvar),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, entry.__name__)
    entry.launches += 1
    return dz2, dmu2


def discriminative_log_qy_bwd(z2_mu, mu2_table, seq_idx, lse, g, pz2_logvar,
                              num_real):
    """Backward of :func:`discriminative_log_qy` (the VJP ``_bwd_call``):
    ``(dz2 [B, Dz], dmu2 [N, Dz])`` for the cotangent ``g [B]`` of log_qy,
    given the forward's log-sum-exp ``lse [B]``."""
    return _backward(discriminative_log_qy_bwd, z2_mu, mu2_table, seq_idx, lse,
                     g, pz2_logvar, num_real, 0)


class _LogQyFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z2_mu, mu2_table, seq_idx, pz2_logvar, num_real, plain):
        if plain:
            out, lse = _forward_plain(z2_mu, mu2_table, seq_idx, pz2_logvar,
                                      num_real)
        else:
            out, lse = _forward_kernel(z2_mu, mu2_table, seq_idx, pz2_logvar,
                                       num_real, True)
        ctx.save_for_backward(z2_mu, mu2_table, seq_idx, lse)
        ctx.pz2_logvar, ctx.num_real, ctx.plain = pz2_logvar, num_real, plain
        return out

    @staticmethod
    def backward(ctx, g):
        bwd = (discriminative_log_qy_bwd_reference if ctx.plain
               else discriminative_log_qy_bwd)
        dz2, dmu2 = bwd(*ctx.saved_tensors, g, ctx.pz2_logvar, ctx.num_real)
        return dz2, dmu2, None, None, None, None


def _log_qy(plain, z2_mu, mu2_table, seq_idx, pz2_logvar, num_real):
    _check(z2_mu, mu2_table, seq_idx)
    num_real = mu2_table.shape[0] if num_real is None else int(num_real)
    if torch.is_grad_enabled() and (z2_mu.requires_grad
                                    or mu2_table.requires_grad):
        return _LogQyFn.apply(z2_mu, mu2_table, seq_idx, pz2_logvar,
                              num_real, plain)
    if plain:
        return _forward_plain(z2_mu, mu2_table, seq_idx, pz2_logvar,
                              num_real)[0]
    return _forward_kernel(z2_mu, mu2_table, seq_idx, pz2_logvar, num_real,
                           False)[0]


def discriminative_log_qy(z2_mu, mu2_table, seq_idx, pz2_logvar,
                          num_real=None):
    """``log q(y = seq_idx | z2_mu)``, ``[B]``, under the logits
    ``-|z2_mu - mu2[n]|^2 / (2 exp(pz2_logvar))`` (the ``|z2_mu|^2`` term
    cancels in the softmax and is dropped)."""
    return _log_qy(z2_mu.device.type == "cpu", z2_mu, mu2_table, seq_idx,
                   pz2_logvar, num_real)


def discriminative_log_qy_reference(z2_mu, mu2_table, seq_idx, pz2_logvar,
                                    num_real=None):
    """Plain version of :func:`discriminative_log_qy`: the full ``[B, N]``
    logits and a log-softmax (backward:
    :func:`discriminative_log_qy_bwd_reference`)."""
    return _log_qy(True, z2_mu, mu2_table, seq_idx, pz2_logvar, num_real)


# ----------------------------------------------------------- sharded form


def shard_partials(z2_mu, mu2_local, seq_idx, pz2_logvar, num_real,
                   row_offset):
    """One shard's online partials ``(m, s, picked)``, each ``[B]``:
    the largest logit of ``z2_mu`` against the shard's rows, the sum of
    ``e^(logit - m)`` and the logit of row ``seq_idx - row_offset`` (0 when
    another shard owns it). ``mu2_local [N_loc, Dz]`` holds the whole
    table's rows ``[row_offset, row_offset + N_loc)``; ``num_real`` counts
    the whole table's real rows; ``seq_idx`` holds rows of the whole table.
    The streaming kernel for CUDA tensors, the plain version on the CPU."""
    _check(z2_mu, mu2_local, seq_idx)
    if z2_mu.device.type == "cpu":
        return shard_partials_reference(z2_mu, mu2_local, seq_idx, pz2_logvar,
                                        num_real, row_offset)
    return _forward_partials(discriminative_log_qy_sharded, z2_mu, mu2_local,
                             seq_idx, pz2_logvar, int(num_real),
                             int(row_offset), 3)


def _rescaled(m, s, picked, m_glob):
    """One shard's terms of the merged sums: ``[s e^(m - m*), picked]``."""
    return torch.stack([s * torch.exp(m - m_glob), picked])


def _finish(m_glob, total):
    lse = m_glob + torch.log(total[0])
    return total[1] - lse, lse


def merge_shard_partials(m, s, picked, all_max, all_sum):
    """``(log_qy, lse)`` from one shard's partials and the two reductions
    over the shards: ``m* = all_max(m)``, then ``all_sum`` of the stacked
    ``[s e^(m - m*), picked]``."""
    m_glob = all_max(m)
    return _finish(m_glob, all_sum(_rescaled(m, s, picked, m_glob)))


def combine_shard_partials(parts):
    """:func:`merge_shard_partials` over the partials of all shards held in
    one process (what the ranks of a model group compute together)."""
    m_glob = torch.stack([p[0] for p in parts]).max(dim=0).values
    return _finish(m_glob, sum(_rescaled(*p, m_glob) for p in parts))


def discriminative_log_qy_sharded_bwd(z2_mu, mu2_local, seq_idx, lse, g,
                                      pz2_logvar, num_real, row_offset):
    """Per-shard backward of :func:`discriminative_log_qy_sharded`
    (``bwd_local``): ``(dz2 part [B, Dz], dmu2 [N_loc, Dz])`` for the
    cotangent ``g [B]``, given the log-sum-exp ``lse [B]`` over the whole
    table. The shards' ``dz2`` parts add up to ``dz2``."""
    return _backward(discriminative_log_qy_sharded_bwd, z2_mu, mu2_local,
                     seq_idx, lse, g, pz2_logvar, num_real, row_offset)


class _ShardedLogQyFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z2_mu, mu2_local, seq_idx, pz2_logvar, num_real, mesh,
                plain):
        offset = mesh.model_index * mu2_local.shape[0]
        partials = shard_partials_reference if plain else shard_partials
        out, lse = merge_shard_partials(
            *partials(z2_mu, mu2_local, seq_idx, pz2_logvar, num_real, offset),
            mesh.model_max, mesh.model_sum)
        ctx.save_for_backward(z2_mu, mu2_local, seq_idx, lse)
        ctx.args = (pz2_logvar, num_real, offset)
        ctx.mesh, ctx.plain = mesh, plain
        return out

    @staticmethod
    def backward(ctx, g):
        bwd = (discriminative_log_qy_bwd_reference if ctx.plain
               else discriminative_log_qy_sharded_bwd)
        dz2, dmu2 = bwd(*ctx.saved_tensors, g, *ctx.args)
        return ctx.mesh.model_sum(dz2), dmu2, None, None, None, None, None


def _log_qy_sharded(plain, z2_mu, mu2_local, seq_idx, pz2_logvar, mesh,
                    num_real):
    _check(z2_mu, mu2_local, seq_idx)
    if num_real is None:
        num_real = mu2_local.shape[0] * mesh.shape[1]
    return _ShardedLogQyFn.apply(z2_mu, mu2_local, seq_idx, float(pz2_logvar),
                                 int(num_real), mesh, plain)


def discriminative_log_qy_sharded(z2_mu, mu2_local, seq_idx, pz2_logvar, mesh,
                                  num_real=None):
    """``log q(y = seq_idx | z2_mu)``, ``[B]``, against a mu2 table that is
    row-sharded over the model axis of ``mesh`` (``parallel.mesh.Mesh``).

    Called by every rank with its batch rows ``z2_mu [B, Dz]``, ``seq_idx
    [B]`` (rows of the whole table) and its shard ``mu2_local [N_pad / m,
    Dz]``, whose first row is row ``model_index * N_pad / m`` of the table
    padded to a multiple of ``m`` (``parallel.mesh.padded_num_seqs``);
    ``num_real`` counts the real rows. The ranks of a model group must hold
    the same batch rows. Gradients: ``dz2`` is summed over the model group;
    ``dmu2`` is the shard's gradient from this rank's batch rows, and the
    caller sums it over the data group."""
    return _log_qy_sharded(z2_mu.device.type == "cpu", z2_mu, mu2_local,
                           seq_idx, pz2_logvar, mesh, num_real)


def discriminative_log_qy_sharded_reference(z2_mu, mu2_local, seq_idx,
                                            pz2_logvar, mesh, num_real=None):
    """Plain version of :func:`discriminative_log_qy_sharded`: the same
    reductions around :func:`shard_partials_reference` (backward:
    :func:`discriminative_log_qy_bwd_reference` with the shard's offset)."""
    return _log_qy_sharded(True, z2_mu, mu2_local, seq_idx, pz2_logvar, mesh,
                           num_real)


discriminative_log_qy.launches = 0
discriminative_log_qy_bwd.launches = 0
discriminative_log_qy_sharded.launches = 0
discriminative_log_qy_sharded_bwd.launches = 0
