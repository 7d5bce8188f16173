"""Steps and passes that gather their batches from the device-resident store.

Counterpart of ``pytorch_scalablefhvae_tpu/train/device_step.py``. Instead of a ``[B, seg_len, D]`` batch shipped from the host every
step, these take the staged store (``data/device_store.py``) and the epoch's
index plan on the device, and build each batch there:

- :func:`batch_views`: the shared prologue (plan slice at ``off``, weight
  mask from ``n_real``, segment gather, clipped ``nsegs`` lookup);
- :func:`device_train_step`: one optimizer step (K = 1) through the port's
  ``train_step``;
- :class:`PlanInputs`: the inputs of the K-step bundle (``train/graphs.py``,
  ``make_device_train_step(k)``): the epoch's plan in persistent buffers,
  and step ``i`` of a dispatch reading the plan's rows at ``base + i * B``
  (on a mesh this rank's rows of them), with ``base`` and ``n_real``
  device scalars (:func:`batch_views_at`);
- :func:`device_eval_pass`: per-batch weighted metric sums over a split,
  stacked on the device;
- :func:`device_map_pass` (array plan), :func:`device_map_pass_rows` (the
  same plan derived on the device from per-sequence vectors, a
  hierarchical round's MAP init) and :func:`device_map_pass_chunked` (the
  chunk layout, gathered by the ``windowed_chunk_gather`` kernel): a
  split's MAP mu2 table, accumulated in fp32 on the device.

The store is a tensor in the staging dtype (float32 or bfloat16: the
windows keep it, and the model upcasts them on entry) or a ``Quantized``
int8 store, whose windows are gathered as bytes and dequantized after the
gather (:func:`gather_segments`, JAX's ``_make_gather``), so the
full-precision features never exist on the device, only the ``[B,
seg_len, D]`` batch. The streamed tier's chunks (``data/stream_store.py``)
are stores of the same kinds.

Where the JAX package jits a scan, these loop over batches in Python (the
K-step bundle replays its loop as a CUDA graph); nothing leaves the device
until the caller fetches it.
Padding rows of a plan are (sequence 0, frame 0) with weight 0, so given the
same permutation the steps train exactly as the host loader does.

On a mesh of ranks a rank gathers only its rows of each planned batch
(:func:`rank_views`), from the store replicated on every rank or, with
``--shard-device-store``, row-sharded over the model axis
(:func:`gather_sharded`, one definition for the train step, the eval pass
and the array-plan and rows MAP passes); the eval sums and the MAP sums are
added up over the data group. The chunked MAP pass does not run on a mesh
(as in the JAX loop): the array-plan pass does, and a hierarchical round's
the rows pass.
"""

from __future__ import annotations

import torch

from pytorch_scalablefhvae_tpu_torch.data.device_store import (
    STORE_TAIL_SLACK,
    Quantized,
    RowShard,
)
from pytorch_scalablefhvae_tpu_torch.ops.window_gather import (
    windowed_chunk_gather,
)
from pytorch_scalablefhvae_tpu_torch.parallel.mesh import DATA_AXIS
from pytorch_scalablefhvae_tpu_torch.parallel.sharded_step import (
    sum_eval_over_data,
)
from pytorch_scalablefhvae_tpu_torch.train.step import eval_step, train_step


def gather_segments(store, starts, seg_len: int):
    """``[B, seg_len, D]`` windows ``store[starts[b] + t]``: a plain gather,
    as the JAX package's ``jnp.take`` outside any kernel, in the store's
    dtype; a ``Quantized`` store's windows dequantized after the gather as
    ``q.float() * scale + offset`` in fp32 (two roundings, the bits of
    ``quantize.dequantize``); a ``RowShard``'s by
    :func:`gather_sharded`."""
    idx = starts[:, None] + torch.arange(seg_len, device=store.device)[None, :]
    if isinstance(store, RowShard):
        return gather_sharded(store, idx)
    return _take(store, idx)


def _take(store, idx):
    if isinstance(store, Quantized):
        return store.rows[idx].float() * store.scale + store.offset
    return store[idx]


def gather_sharded(store: RowShard, idx: torch.Tensor) -> torch.Tensor:
    """The rows ``idx`` of a store row-sharded over the model axis, in fp32
    on every rank of the model group, which must pass the same ``idx``
    (JAX ``_make_gather``'s ``gather_local`` under ``shard_map``): each rank
    takes the rows at ``clip(idx - lo)`` of its period, dequantizes an int8
    window and upcasts a bf16 one (the model upcasts on entry), writes -0.0
    where it does not own the frame, and the group sums in fp32. Exactly
    one rank owns a frame and ``x + -0.0 == x`` for every ``x``, -0.0 and
    +0.0 included, so the windows hold the replicated store's values bit
    for bit; a window across a shard boundary needs nothing of its own,
    since the mask is per frame."""
    rel = idx % store.period - store.lo
    own = (rel >= 0) & (rel < store.per)
    local = (idx // store.period) * store.per + rel.clamp(0, store.per - 1)
    g = _take(store.local, local).float()
    g = torch.where(own[..., None], g, -0.0)
    return store.mesh.model_sum_(g)


def batch_views(store, seq_idx_all, starts_all, nsegs_tab, off: int,
                n_real: int, *, batch_size: int, seg_len: int):
    """``(feats, seq_idx, nsegs, weight)`` of the plan's rows ``[off, off +
    batch_size)``: rows at plan positions ``>= n_real`` get weight 0;
    ``nsegs`` is ``None`` when ``nsegs_tab`` is."""
    return _plan_rows(store, seq_idx_all[off:off + batch_size],
                      starts_all[off:off + batch_size], nsegs_tab,
                      off + torch.arange(batch_size, device=store.device),
                      n_real, seg_len)


def _plan_rows(store, seq_idx, starts, nsegs_tab, pos, n_real, seg_len: int):
    """The batch views of plan rows ``seq_idx``, ``starts`` at plan
    positions ``pos``."""
    weight = (pos < n_real).to(torch.float32)
    feats = gather_segments(store, starts, seg_len)
    if nsegs_tab is None:
        return feats, seq_idx, None, weight
    nsegs = nsegs_tab[seq_idx.clamp(0, nsegs_tab.shape[0] - 1)]
    return feats, seq_idx, nsegs, weight


def batch_views_at(store, seq_idx_all, starts_all, nsegs_tab, off, n_real, *,
                   rows: torch.Tensor, seg_len: int):
    """:func:`batch_views` with ``off`` and ``n_real`` as 0-dim device
    tensors and ``rows = arange(batch_size)`` on the device (on a mesh the
    rank's ``arange(lo, hi)``, :func:`rank_views`'s rows): the plan's rows
    are picked by ``index_select`` at ``off + rows``, so a captured graph
    reads wherever the scalars point at replay time. The same gathers, so
    the same bits."""
    pos = off + rows
    return _plan_rows(store, seq_idx_all.index_select(0, pos),
                      starts_all.index_select(0, pos), nsegs_tab, pos, n_real,
                      seg_len)


class PlanInputs:
    """The K-step bundle's inputs on a staged store (the device tier's
    whole store, or the streamed tier's two slots, whose address stays the
    same whichever slot a chunk lands in; replicated or a ``RowShard``): the
    plan ``(seq_idx_all, starts_all, nsegs_tab)`` of an epoch or of a chunk
    copied into persistent buffers (each plan is uploaded to new tensors;
    the graph keeps the first addresses), the real-row count and the
    dispatch's first plan row as device scalars. On a ``mesh`` step ``i``
    reads this rank's rows of its batch, plan rows ``base + i * batch_size
    + local_rows``, as :func:`rank_views` reads them."""

    def __init__(self, store, batch_size: int, seg_len: int, mesh=None):
        dev = store.device
        self.store, self.batch_size, self.seg_len = store, batch_size, seg_len
        self.plan = None
        self.base = torch.zeros((), dtype=torch.long, device=dev)
        self.n_real = torch.zeros((), dtype=torch.long, device=dev)
        rows = (slice(0, batch_size) if mesh is None
                else mesh.local_rows(batch_size))
        self.rows = torch.arange(rows.start, rows.stop, device=dev)

    def load_plan(self, arrays, n_real: int) -> None:
        """This epoch's plan (``DeviceDataSource.stage_epoch``'s arrays) or
        this chunk's (``StreamChunk.arrays``)."""
        if self.plan is None:
            self.plan = tuple(a.clone() for a in arrays)
        elif [a.shape for a in arrays] != [a.shape for a in self.plan]:
            raise ValueError(
                f"the epoch plan's shapes changed from "
                f"{[tuple(a.shape) for a in self.plan]} to "
                f"{[tuple(a.shape) for a in arrays]}; a captured bundle "
                f"reads fixed buffers")
        else:
            for dst, src in zip(self.plan, arrays):
                dst.copy_(src)
        self.n_real.fill_(n_real)

    def set_base(self, off: int) -> None:
        """The plan row of the next dispatch's first step."""
        self.base.fill_(off)

    def views(self, i: int):
        return batch_views_at(self.store, *self.plan,
                              self.base + i * self.batch_size, self.n_real,
                              rows=self.rows, seg_len=self.seg_len)


def rank_views(mesh, store, seq_idx_all, starts_all, nsegs_tab, off: int,
               n_real: int, *, batch_size: int, seg_len: int):
    """:func:`batch_views` of the rows this rank takes of the plan's batch
    at ``off`` (all of them without a ``mesh``)."""
    if mesh is not None:
        rows = mesh.local_rows(batch_size)
        off, batch_size = off + rows.start, rows.stop - rows.start
    return batch_views(store, seq_idx_all, starts_all, nsegs_tab, off, n_real,
                       batch_size=batch_size, seg_len=seg_len)


def device_train_step(state, optimizer, store, plan, off: int, n_real: int,
                      alpha: float, *, batch_size: int, seg_len: int,
                      noise: dict | None = None, mesh=None) -> dict:
    """One optimizer step in place on the plan's batch at ``off``;
    ``plan = (seq_idx_all, starts_all, nsegs_tab)``. Returns the step's
    metrics (0-dim tensors on the device)."""
    feats, seq_idx, nsegs, weight = rank_views(
        mesh, store, *plan, off, n_real, batch_size=batch_size,
        seg_len=seg_len)
    return train_step(state, optimizer, feats, seq_idx, nsegs, weight, alpha,
                      noise=noise, mesh=mesh)


@torch.inference_mode()
def device_eval_pass(model, store, plan, n_real: int, alpha: float,
                     table: torch.Tensor | None, *, batch_size: int,
                     seg_len: int, n_batches: int, mesh=None) -> dict:
    """Weighted sums of every metric and the row count (``count``) per
    batch, each stacked ``[n_batches]`` on the device, scored against
    ``table`` when given."""
    stacked: dict[str, list] = {}
    for b in range(n_batches):
        feats, seq_idx, nsegs, weight = rank_views(
            mesh, store, *plan, b * batch_size, n_real, batch_size=batch_size,
            seg_len=seg_len)
        sums = eval_step(model, feats, seq_idx, nsegs, weight, alpha, table)
        for k, v in sums.items():
            stacked.setdefault(k, []).append(v)
    out = {k: torch.stack(v) for k, v in stacked.items()}
    return out if mesh is None else sum_eval_over_data(mesh, out)


@torch.inference_mode()
def _map_scan(model, batch_fn, n_batches: int, num_rows: int,
              r_ratio: float, device, mesh=None) -> torch.Tensor:
    """The MAP passes' shared body: encode each batch's z2 means, sum them
    and the valid counts per table row in fp32, then the closed-form MAP
    mean ``sum / (count + pz2_var / pmu2_var)``. ``batch_fn(b) -> (feats,
    seq_idx, valid)``. ``index_put_`` with ``accumulate`` adds duplicate rows
    in a fixed order (on CUDA it sorts the indices and runs no atomics), so
    two passes give the same bits. With a ``mesh`` each rank encodes its
    rows and the sums and counts are added up over the data group."""
    sums = torch.zeros((num_rows, model.z2_dim), device=device)
    counts = torch.zeros((num_rows,), device=device)
    for b in range(n_batches):
        feats, seq_idx, valid = batch_fn(b)
        z2_mu = model.encode_z2(feats)
        sums.index_put_((seq_idx,), z2_mu * valid[:, None], accumulate=True)
        counts.index_put_((seq_idx,), valid, accumulate=True)
    if mesh is not None:
        mesh.all_reduce_(sums, DATA_AXIS)
        mesh.all_reduce_(counts, DATA_AXIS)
    return sums / (counts + r_ratio)[:, None]


def device_map_pass(model, store, seq_idx_all, starts_all, n_real: int, *,
                    seg_len: int, batch_size: int, n_batches: int,
                    num_rows: int, pz2_var: float,
                    pmu2_var: float = 1.0, mesh=None) -> torch.Tensor:
    """A split's ``[num_rows, z2_dim]`` MAP mu2 table from the array plan
    (``make_device_map_pass``)."""

    def batch_fn(b):
        feats, seq_idx, _, valid = rank_views(
            mesh, store, seq_idx_all, starts_all, None, b * batch_size,
            n_real, batch_size=batch_size, seg_len=seg_len)
        return feats, seq_idx, valid

    return _map_scan(model, batch_fn, n_batches, num_rows,
                     pz2_var / pmu2_var, store.device, mesh)


def rows_plan(sel_starts, sel_nsegs, *, seg_shift: int, rows: int):
    """The sequence-major window plan of ``rows`` rows derived on the device
    from the sequences' first frames ``sel_starts [K]`` and window counts
    ``sel_nsegs [K]`` (deterministic windowing): row ``r`` belongs to
    sequence ``k = searchsorted(cumsum(nsegs), r, right)`` at window ``j =
    r - cum[k-1]``, frame ``sel_starts[k] + j * seg_shift``. Rows at or past
    ``n_real = sum(nsegs)`` are padding: sequence ``K - 1`` at frame 0, to
    take weight 0. Returns ``(seq_idx [rows], starts [rows], n_real)``, the
    last a 0-dim device tensor."""
    dev = sel_starts.device
    cum = torch.cumsum(sel_nsegs.to(torch.long), 0)
    n_real = cum[-1]
    r = torch.arange(rows, device=dev)
    k = torch.searchsorted(cum, r, right=True).clamp(max=cum.shape[0] - 1)
    prev = torch.where(k > 0, cum[(k - 1).clamp(min=0)], 0)
    starts = sel_starts.to(torch.long)[k] + (r - prev) * seg_shift
    return k, torch.where(r < n_real, starts, 0), n_real


def device_map_pass_rows(model, store, sel_starts, sel_nsegs, *,
                         seg_len: int, seg_shift: int, batch_size: int,
                         n_batches: int, num_rows: int, pz2_var: float,
                         pmu2_var: float = 1.0, mesh=None) -> torch.Tensor:
    """A round's ``[num_rows, z2_dim]`` MAP mu2 table from per-sequence
    vectors only (``make_device_map_pass_rows``): the upload is two ``[K]``
    vectors, the window plan derives on the device (:func:`rows_plan`) and
    runs through :func:`device_map_pass`, so on a ``mesh`` each rank
    encodes its rows of every batch, gathered from the replicated store or
    a ``RowShard``, and the sums are added up over the data group. Every
    rank gets the whole table (padded rows exact zeros); the round keeps
    its rows of it (``step.replace_mu2_table``), as JAX constrains it to
    ``P("model", None)``. Index arithmetic and ``index_put_``, no kernel of
    its own: the JAX package computes it outside Pallas too."""
    seq_all, starts_all, n_real = rows_plan(
        sel_starts, sel_nsegs, seg_shift=seg_shift,
        rows=n_batches * batch_size)
    return device_map_pass(model, store, seq_all, starts_all, n_real,
                           seg_len=seg_len, batch_size=batch_size,
                           n_batches=n_batches, num_rows=num_rows,
                           pz2_var=pz2_var, pmu2_var=pmu2_var, mesh=mesh)


MAP_SPB = 16  # windows per chunk of the chunked MAP passes


def chunk_layout(sel_starts, sel_nsegs, *, spb: int, seg_shift: int,
                 rows: int, chunk_skip: int = 1):
    """The chunked schedule of ``rows`` windows (a multiple of ``spb``):
    sequence ``k`` owns ``ceil(ceil(nsegs[k] / spb) / chunk_skip)`` chunks
    of ``spb`` consecutive windows; its selected chunk ``j`` is original
    chunk ``j * chunk_skip``. Returns ``(seq_all [rows], valid [rows] f32,
    chunk_starts [rows // spb])``: padding chunks past the real ones start
    at frame 0, and a window is valid when it lies inside its sequence and
    its chunk is real."""
    dev = sel_starts.device
    nseg = sel_nsegs.to(torch.long)
    chunks = (nseg + spb - 1) // spb
    cps = (chunks + chunk_skip - 1) // chunk_skip
    cumc = torch.cumsum(cps, 0)
    n_chunks_real = cumc[-1]
    q = torch.arange(rows // spb, device=dev)
    k_q = torch.searchsorted(cumc, q, right=True).clamp(max=nseg.shape[0] - 1)
    prev = torch.where(k_q > 0, cumc[(k_q - 1).clamp(min=0)], 0)
    qj = (q - prev) * chunk_skip  # original chunk index within its sequence
    chunk_starts = sel_starts.to(torch.long)[k_q] + qj * (spb * seg_shift)
    chunk_starts = torch.where(q < n_chunks_real, chunk_starts, 0)
    seq_all = k_q.repeat_interleave(spb, output_size=rows)
    j_in_seq = (qj.repeat_interleave(spb, output_size=rows) * spb
                + torch.arange(spb, device=dev).repeat(rows // spb))
    real_chunk = q.repeat_interleave(spb, output_size=rows) < n_chunks_real
    valid = ((j_in_seq < nseg[seq_all]) & real_chunk).to(torch.float32)
    return seq_all, valid, chunk_starts


def device_map_pass_chunked(model, store, sel_starts, sel_nsegs, *,
                            seg_len: int, seg_shift: int, batch_size: int,
                            n_batches: int, num_rows: int, pz2_var: float,
                            spb: int = MAP_SPB, pmu2_var: float = 1.0,
                            chunk_skip: int = 1) -> torch.Tensor:
    """A split's MAP mu2 table over the chunked schedule of
    :func:`chunk_layout` (``make_device_map_pass_chunked``): each batch's
    ``batch_size / spb`` chunks are gathered by ``windowed_chunk_gather``,
    one region copy per chunk. ``sel_starts [K]`` are the sequences' first
    frames in the staged store, ``sel_nsegs [K]`` their window counts. The
    store must keep ``(spb - 1) * seg_shift + seg_len`` rows of slack past
    its last frame. ``chunk_skip > 1`` encodes every ``chunk_skip``-th
    chunk only (a hierarchical round's MAP init)."""
    B = batch_size
    if B % spb:
        raise ValueError(f"batch_size {B} must be a multiple of spb {spb}")
    region = (spb - 1) * seg_shift + seg_len
    if region > STORE_TAIL_SLACK:
        raise ValueError(
            f"chunk region (spb-1)*seg_shift+seg_len = {region} exceeds the "
            f"staged store's tail slack ({STORE_TAIL_SLACK}); lower spb or "
            f"use the array-plan MAP pass")
    cpb = B // spb
    seq_all, valid_all, chunk_starts = chunk_layout(
        sel_starts, sel_nsegs, spb=spb, seg_shift=seg_shift,
        rows=n_batches * B, chunk_skip=chunk_skip)

    def batch_fn(b):
        feats = windowed_chunk_gather(
            store, chunk_starts[b * cpb:(b + 1) * cpb], spb, seg_len,
            seg_shift)
        return feats, seq_all[b * B:(b + 1) * B], valid_all[b * B:(b + 1) * B]

    return _map_scan(model, batch_fn, n_batches, num_rows,
                     pz2_var / pmu2_var, store.device)
