"""Hierarchical rounds (``train --hierarchical``): counterpart of the round
code of the JAX package's ``train/loop.py``.

Each round trains against a subset of K sequences drawn from the corpus, so
the mu2 table and the discriminative softmax are O(K) whatever the corpus
size (the scalable configuration of arXiv 1804.03201). A round lasts
``--hierarchical-round-epochs`` epochs. Its boundaries are absolute (``epoch
% R == 0``), and its draw, dataset and loader are keyed by its boundary
epoch ``e0`` (:func:`round_keys`, :func:`round_loader`), so a resume
anywhere inside a round rebuilds it exactly. When a round turns over, its
table is MAP-initialised from the current encoder and its Adam moments are
reset (``step.replace_mu2_table``); re-entering a live round on a resume
keeps the restored table.

A hierarchical run takes one of three tiers, as the JAX loop gives it:

- ``device``: the store fits the budget and is staged whole; a round's
  subset is a view of it (absolute frame offsets);
- ``round``: the store is over the budget (``auto``, ``stream``, or an
  explicit ``device``), but a round's worst-case sub-pack fits three
  quarters of it (:func:`round_ceiling`): each round's sub-pack is staged
  into ONE buffer of a fixed row ceiling, in the compute stream's order, so
  a captured K-step graph keeps reading the same address and no step issued
  before a turnover reads the next round's rows. The source holds the host
  store (``DeviceDataSource.hold_host``: page-locked and mapped on a GPU),
  each round is a layout (``RoundLayout``), and one launch of
  ``ops/stage_gather.py`` reads its rows from the host store into the
  buffer (``restage_runs``); int8 staging, whose columns are quantized over
  the whole sub-pack, materialises the round's sub-pack on the host and
  copies it (``restage``). The counters ``stage_gathers`` and
  ``stage_fallbacks`` count the turnovers of each. The dev split is
  budgeted against one ceiling (the JAX loop counts two, for the buffer it
  drops while a dispatch still reads it);
- ``host``: the host loader.

On the two staged tiers every round's plan is padded to one length (the K
largest sequences' windows), so one captured graph serves every round
(``--epoch-plan device`` derives it on the device from the round's
per-sequence vectors, staged at every turnover and re-entry), and
the MAP init is one chunked pass through kernel #8 (every
``--map-init-chunk-skip``-th chunk of 16 windows of each sequence), or the
rows pass (every window, its plan derived on the device from the round's
two ``[K]`` vectors) for int8 stores and on a mesh, or the array-plan pass
for random windows; on the host tier it is ``estimate_split_mu2`` over the
chunks that the chunked pass takes.

On a mesh (``--mesh d,m``) every rank runs the same rounds: the draw is
keyed by ``(seed, e0)`` alone, so every rank draws the same keys; each
stages the round's sub-pack (on the ``round`` tier with
``--shard-device-store`` its rows of it, the budget counting m times); the
MAP init runs on every rank, each encoding its rows of every batch, the
sums added up over the data group, and every rank keeps its rows of the
whole padded table (``step.replace_mu2_table``). Kernel #8 is not on this
path, as in the JAX loop, whose chunked pass runs off a mesh only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pytorch_scalablefhvae_tpu_torch.data.device_store import (
    STORE_TAIL_SLACK,
    DeviceEpochPlanner,
    RoundLayout,
    build_epoch_plan,
    staging_itemsize,
    store_budget,
)
from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
from pytorch_scalablefhvae_tpu_torch.data.segments import (
    SegmentDataset,
    chunk_skip_indices,
)
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train import trace
from pytorch_scalablefhvae_tpu_torch.train.device_step import (
    MAP_SPB,
    device_map_pass,
    device_map_pass_chunked,
    device_map_pass_rows,
)
from pytorch_scalablefhvae_tpu_torch.train.step import (
    TrainState,
    replace_mu2_table,
)

MAP_BATCH_ROWS = 2048  # the MAP init's batch: the train batch times
                       # max(1, 2048 // batch)


def round_ceiling(placement: str, store, k: int, max_bytes: int,
                  store_dtype: str = "float32", verbose: bool = True,
                  mesh=None, shard_store: bool = False
                  ) -> tuple[int, int | None]:
    """Per-round staging of a hierarchical run whose store is over the
    budget: ``(K, ceiling)``, the effective round size and the row count of
    the buffer every round's sub-pack is staged into, or ``(k, None)`` when
    not even the longest sequence fits (``auto``: the host loader trains;
    an explicit ``device`` or ``stream`` raises the JAX package's
    ``ValueError``).

    The sub-pack may take three quarters of ``max_bytes`` in
    ``store_dtype``, times the model axis of ``mesh`` when ``shard_store``
    row-shards it over that axis (``store_budget``, JAX ``loop.py:316-321``).
    K is the largest round size whose worst-case draw, the K longest
    sequences, fits, since the table's rows are fixed for the run; a K below
    ``k`` is announced whatever ``verbose`` is (on a mesh by rank 0 alone),
    as the JAX loop announces it only under ``verbose``."""
    isz = staging_itemsize(store_dtype)
    k = min(k, store.num_seqs)
    budget = store_budget(max_bytes, mesh, shard_store)
    budget_rows = (budget * 3 // 4) // max(store.dim * isz, 1)
    floor = int(np.max(store.lens)) + STORE_TAIL_SLACK
    if budget_rows < floor:
        if placement in ("device", "stream"):
            raise ValueError(
                f"data_placement={placement} with hierarchical sampling "
                f"stages each round's sub-pack, but the longest sequence "
                f"needs {floor} rows and the device-store budget allows "
                f"only {int(budget_rows)} — raise --device-store-max-bytes, "
                f"use --transfer-dtype bfloat16/int8, or use "
                f"data_placement=auto/host")
        return k, None
    desc = np.sort(np.asarray(store.lens))[::-1][:k]
    k_eff = int(np.searchsorted(np.cumsum(desc),
                                budget_rows - STORE_TAIL_SLACK,
                                side="right"))
    if k_eff < k and (mesh is None or mesh.rank == 0):
        print(f"Hierarchical round size reduced {k} -> {k_eff}: a round's "
              f"worst-case sub-pack must fit the device-store budget (raise "
              f"--device-store-max-bytes or use --transfer-dtype "
              f"bfloat16/int8 for larger rounds)")
    ceiling = int(desc[:k_eff].sum()) + STORE_TAIL_SLACK
    if verbose:
        print(f"Hierarchical rounds stage their subset device-resident "
              f"({ceiling * store.dim * isz / 1e6:.1f} MB ceiling per round)")
    return k_eff, ceiling


def round_keys(seq_keys, k: int, seed: int, e0: int) -> list:
    """The keys of the round that starts at epoch ``e0``."""
    rng = np.random.default_rng((seed + 23) * 1_000_003 + e0)
    return list(rng.choice(seq_keys, size=k, replace=False))


def round_loader(full: SegmentDataset, sub_store, batch_size: int, seed: int,
                 e0: int, transfer_dtype: str = "float32") -> SegmentLoader:
    """The shuffled loader of the round that starts at epoch ``e0`` over
    ``sub_store``, its subset of ``full``'s store."""
    ds = SegmentDataset(sub_store, seg_len=full.seg_len,
                        seg_shift=full.seg_shift, rand_seg=full.rand_seg,
                        seed=seed + e0)
    return SegmentLoader(ds, batch_size, shuffle=True, seed=seed + 31 * e0,
                         transfer_dtype=transfer_dtype)


def check_round_table(checkpoint_file, model, k: int) -> None:
    """Refuse a hierarchical resume whose checkpoint holds a round table of
    another size than this run's effective round size ``k`` (the JAX
    package fails there with a shape error): its ``num_seqs``, the K it
    was saved with, whose table a mesh pads to a multiple of its model
    axis; the table's rows where the sidecar lacks it."""
    rows = ckpt.read_checkpoint_meta(checkpoint_file).get("num_seqs")
    if rows is None:
        rows = ckpt.saved_table_rows(checkpoint_file, model)
    if int(rows) != k:
        raise ValueError(
            f"{checkpoint_file} holds a hierarchical round table of {rows} "
            f"rows, but this run's round size K is {k}. K is "
            f"min(--num-hierarchical-sequences, the corpus's sequences), "
            f"reduced where the store is over --device-store-max-bytes so "
            f"that a round's worst-case sub-pack fits it in "
            f"--transfer-dtype; resume with the settings that gave K = "
            f"{rows}, or with --finetune")


class Rounds:
    """A hierarchical run's rounds on its ``tier`` (``"device"``,
    ``"round"`` or ``"host"``; ``source``: the staged store of the first
    two), ``k`` sequences each: :meth:`loader_for` gives an epoch's loader,
    turning the round over at its boundary. ``plan_rows``: the fixed length
    of a staged tier's epoch plans; ``planner``: with ``device_plan`` (a
    staged tier's ``--epoch-plan device``) the planner that derives them,
    its vectors staged at every round entered. ``mesh``: this rank's mesh,
    where the rounds run on every rank in step."""

    def __init__(self, config, loader: SegmentLoader, tier: str, source,
                 k: int, device: torch.device, device_plan: bool = False,
                 mesh=None):
        ds = loader.dataset
        self.full, self.batch_size = ds, loader.batch_size
        self.tier, self.source, self.k, self.device = tier, source, k, device
        self.mesh = mesh
        self.every = max(config.train.hierarchical_round_epochs, 1)
        self.seed = config.train.seed
        self.dtype = config.data.transfer_dtype
        self.skip = max(config.train.map_init_chunk_skip, 1)
        # int8 quantizes each round over its whole sub-pack, on the host;
        # every other staging dtype gathers the round from the held store
        self.quantized = tier == "round" and source.store_dtype == "int8"
        if tier == "round" and not self.quantized:
            source.hold_host(ds.store.data)
        self.current: SegmentLoader | None = None
        B = loader.batch_size
        top = np.sort(np.asarray(ds.nsegs, np.int64))[-k:]
        self.plan_rows = None
        if tier != "host":
            rows = int(top.sum())
            self.plan_rows = rows + (-rows) % B
        self.map_batch = B * max(1, MAP_BATCH_ROWS // B)
        self.chunked = (tier != "host" and mesh is None and not ds.rand_seg
                        and self.dtype != "int8"
                        and self.map_batch % MAP_SPB == 0
                        and (MAP_SPB - 1) * ds.seg_shift + ds.seg_len
                        <= STORE_TAIL_SLACK)
        need = (self.chunk_rows(top) if self.chunked else int(top.sum()))
        self.map_batches = max(-(-need // self.map_batch), 1)
        self.planner = (DeviceEpochPlanner(source, self.seed, ds.seg_shift,
                                           self.plan_rows)
                        if device_plan else None)

    def chunk_rows(self, nsegs) -> int:
        """Rows of the chunked MAP plan of sequences of ``nsegs`` windows:
        every ``skip``-th chunk of ``MAP_SPB`` of each, whole chunks."""
        chunks = -(-np.asarray(nsegs, np.int64) // MAP_SPB)
        return int((-(-chunks // self.skip) * MAP_SPB).sum())

    def loader_for(self, epoch: int, state: TrainState, resumed: bool,
                   verbose: bool = True) -> SegmentLoader:
        """``epoch``'s loader: the current round's, or, at a boundary epoch
        or at the run's first, the new round's, its sub-pack staged on the
        ``round`` tier. The table is MAP-initialised only when the round
        turns over: not when the run re-enters a live round, at an epoch
        inside it or, ``resumed``, at the cursor of a mid-epoch
        checkpoint."""
        boundary = epoch % self.every == 0
        if self.current is not None and not boundary:
            return self.current
        e0 = epoch - epoch % self.every
        fresh = boundary and not resumed
        store = self.full.store
        # the printed seconds are the timed stage spans': draw the draw
        # and the loader, materialise the host's part (the layout and its
        # runs table, or the host sub-pack), stage the copy and its sync
        with trace.span("turnover"):
            with trace.span("turnover.draw", timed=True) as draw:
                keys = round_keys(store.seq_keys, self.k, self.seed, e0)
            secs = {"draw": draw.seconds}
            if self.tier == "round":
                # the ceiling is the buffer's whole row count, also where a
                # mesh stages no slack and a rank holds its rows of it
                frames = int(sum(store.lens[store.seq2idx[k]] for k in keys))
                held = self.source.total_rows - STORE_TAIL_SLACK
                if frames > held:
                    raise RuntimeError(
                        f"round draw needs {frames} frames but the staging "
                        f"ceiling holds {held}: the ceiling must cover the "
                        f"K largest sequences")
                stage = self.stage_quantized if self.quantized else \
                    self.stage_gathered
                sub = stage(store, keys, secs)
            else:
                sub = store.subset(keys)
            with trace.span("turnover.loader", timed=True) as done:
                self.current = round_loader(self.full, sub, self.batch_size,
                                            self.seed, e0, self.dtype)
            secs["draw"] += done.seconds
            if self.planner is not None:
                # the round's planner vectors, also on a re-entry that
                # keeps the restored table: every epoch's plan derives
                # from them
                with trace.span("turnover.planner"):
                    self.planner.stage(self.current.dataset, pad_seqs=self.k)
            if fresh:
                with trace.span("turnover.map_init", timed=True) as done:
                    self.map_init(state, self.current.dataset)
                    self._sync()
                secs["map_init"] = done.seconds
        if verbose:
            print(f"Round at epoch {e0} ({self.k} sequences, "
                  f"{self.every} epoch{'s' if self.every > 1 else ''}"
                  f"{'' if fresh else ', re-entered: the restored table kept'}"
                  f"): " + ", ".join(f"{name} {s:.3f} s"
                                     for name, s in secs.items()))
        return self.current

    def stage_gathered(self, store, keys, secs: dict) -> RoundLayout:
        """The round of ``keys`` as a layout, its rows gathered from the
        held host store into the staged buffer by one launch; the host's
        part (the layout, its runs table and their upload) and the
        gather's seconds into ``secs``."""
        with trace.span("turnover.materialise", timed=True) as done:
            sub = RoundLayout(store, keys)
            runs = self.source.upload_runs(sub)
        secs["materialise"] = done.seconds
        with trace.span("turnover.stage", timed=True) as done:
            self.source.restage_runs(sub, runs)
            self._sync()
        secs["stage"] = done.seconds
        trace.count("stage_gathers")
        trace.count("stage_fallbacks", 0)
        return sub

    def stage_quantized(self, store, keys, secs: dict):
        """int8 staging: the round of ``keys`` materialised on the host,
        where its columns are quantized over the whole sub-pack, and
        copied into the staged buffer; the seconds of each into
        ``secs``."""
        with trace.span("turnover.materialise", timed=True) as done:
            sub = store.subset(keys, materialize=True)
        secs["materialise"] = done.seconds
        with trace.span("turnover.stage", timed=True) as done:
            self.source.restage(sub)
            self._sync()
        secs["stage"] = done.seconds
        trace.count("stage_gathers", 0)
        trace.count("stage_fallbacks")
        return sub

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def map_init(self, state: TrainState, ds: SegmentDataset) -> None:
        """The round's table, MAP-estimated from the current encoder's z2
        means, zero-padded to the model's padded table rows
        (``num_seqs_padded``), in place of the last round's, with its
        moments reset; on a mesh every rank estimates the whole table and
        keeps its rows."""
        model, mesh = state.model, self.mesh
        pz2_var = math.exp(model.pz2_logvar)
        rows = model.num_seqs_padded
        if self.tier == "host":
            from pytorch_scalablefhvae_tpu_torch.train.loop import (
                estimate_split_mu2,
            )

            idx = (chunk_skip_indices(ds.seq_idx, spb=MAP_SPB, skip=self.skip)
                   if self.skip > 1 and not ds.rand_seg else None)
            est = SegmentLoader(ds, self.batch_size, shuffle=False, seed=0,
                                transfer_dtype=self.dtype, indices=idx)
            est_table = estimate_split_mu2(model, est, self.k, pz2_var,
                                           self.device, mesh=mesh)
            table = torch.zeros((rows, est_table.shape[1]))
            table[:self.k] = torch.from_numpy(est_table)
            table = table.to(self.device)
        elif ds.rand_seg:
            # random windows are drawn on the host: every window, in
            # sequence order, its plan padded to the ceiling (raises where
            # the round needs more)
            plan = build_epoch_plan(
                ds, np.arange(len(ds)), self.map_batch,
                pad_rows=self.map_batches * self.map_batch)
            table = device_map_pass(
                model, self.source.data,
                self.source.upload(plan.seq_idx, torch.long),
                self.source.upload(plan.abs_starts, torch.long), plan.n_real,
                seg_len=ds.seg_len, batch_size=self.map_batch,
                n_batches=self.map_batches, num_rows=rows, pz2_var=pz2_var,
                mesh=mesh)
        else:
            # the plan derives on the device from the round's two [K]
            # vectors, so a round that needs more rows than the pass holds
            # would lose windows silently: raise instead
            need = (self.chunk_rows(ds.nsegs) if self.chunked
                    else int(np.sum(ds.nsegs)))
            if need > self.map_batches * self.map_batch:
                raise RuntimeError(
                    f"round MAP plan needs {need} rows but the pass holds "
                    f"{self.map_batches * self.map_batch}: the ceiling must "
                    f"cover the K largest sequences")
            starts, nsegs = (self.planner.meta[:2] if self.planner
                             else self.source.stage_meta(ds, pad_seqs=self.k))
            kw = dict(seg_len=ds.seg_len, seg_shift=ds.seg_shift,
                      batch_size=self.map_batch, n_batches=self.map_batches,
                      num_rows=rows, pz2_var=pz2_var)
            if self.chunked:
                table = device_map_pass_chunked(
                    model, self.source.data, starts, nsegs, spb=MAP_SPB,
                    chunk_skip=self.skip, **kw)
            else:
                table = device_map_pass_rows(model, self.source.data, starts,
                                             nsegs, mesh=mesh, **kw)
        replace_mu2_table(state, table)
