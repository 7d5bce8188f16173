"""The training loop: counterpart of ``train/loop.py``, on one device or on a
mesh of ranks.

Separate pieces rather than the JAX package's one ``run_training`` body:
:func:`run_epoch` (the host loader: one pass over the shuffled training
batches, a pinned host-to-device copy per batch, a loss check on every
batch), :func:`run_device_epoch` (the device-resident store: the same
batches gathered on the device, each loss checked one step late),
:func:`run_stream_epoch` (the streamed tier, ``data/stream_store.py``: the
store's chunks double-buffered through the device, each chunk's shuffled
segments gathered there, the dispatches of every chunk counted as one
epoch), all of which run ``--steps-per-dispatch K`` > 1 as K-step bundles
(``train/graphs.py``: one CUDA graph replay of K steps, on a mesh under
NCCL with its all-reduces inside, under gloo K eager steps a dispatch; the
last ``n % K`` batches of an epoch or of a chunk as eager steps, each
dispatch's losses checked one dispatch late, as the JAX loop's
``_record_dispatch`` does),
:func:`estimate_split_mu2` + :func:`evaluate_split` (the host dev pass
against a MAP-estimated mu2 table), :func:`stage_split` +
:func:`device_dev_pass` (the same pass over a staged dev split),
:func:`save_state` (the checkpoint policy of both cadences),
:class:`EpochCursor` (the step cadence of ``--ckpt-every-steps`` and
``--max-steps``: an epoch's batch cursor, the save and stop hook each tier
calls after every dispatch, the partials a step checkpoint carries),
:func:`check_best` / :func:`check_terminate` (early stopping), and
:func:`run_training`, which resolves the data tier and strings them
together. The device and streamed
tiers stage in the run's transfer dtype (float32, bfloat16 or int8), and so
does the dev split where it fits what the training tier leaves of the
budget.

On a mesh (``parallel/mesh.py``; ``--mesh d,m``, one process per rank) every
rank runs this same loop in step: it pads and shards the mu2 table, takes its
rows of every batch on any tier (the host loader, the device tier or the
streamed tier, in any transfer dtype; with ``--shard-device-store`` the
staged store, the dev split's and the streamed chunks row-sharded over the
model axis) at any K, and splits both dev passes over the data ranks when
the dev batch size divides by ``d`` (else every rank runs them whole). All
decisions (divergence, best epoch, early stopping) are taken from
all-reduced values, so the ranks take them together; rank 0 alone prints,
writes ``metrics.jsonl`` and the checkpoints (with ``--ckpt-backend orbax``
every rank writes its rows of the table and its moments, rank 0 the rest
and the sidecar: ``train/orbax_backend.py``).

A step checkpoint (``..._e<epoch>s<batches>``) holds the whole training
state and the epoch's cursor; ``--continue-from`` on one re-enters that
epoch at its cursor (every tier's batch order is a function of the seed
and the epoch, each step's noise of the seed and the step), so a killed
and resumed run equals an uninterrupted one bit for bit, and the epoch
checkpoint deletes the step checkpoints it supersedes.

Hierarchical rounds (``--hierarchical``, ``train/rounds.py``) run on one
device or on a mesh: each epoch trains on its round's loader through the
runners above, on the device tier (a round's subset a view of the staged
store), per-round staging of a store over the budget (:func:`run_device_epoch`
on the round's buffer, row-sharded with ``--shard-device-store`` on a mesh),
or the host loader, at any K. With ``--epoch-plan device`` the staged
tiers' epoch plans are derived on the device from the seed and the epoch
(``data/device_store.py`` ``DeviceEpochPlanner``; every rank of a mesh
derives the same) instead of uploaded; the host loader and the streamed
tier say they ignore it, as the JAX loop does.

``--legacy`` runs the reference's step epochs on the host loader at batch 1
(:class:`LegacyEpochs`; eager steps, K ignored). The observability flags:
``--tensorboard`` (with ``--log-params`` a histogram of every parameter and
of its gradient from :func:`make_grad_step` on the epoch's first batch),
``--visdom`` (``curves.svg``, ``train/plots.py``), ``--profile-dir``
(:func:`epoch_profile`: one epoch's training under ``torch.profiler``) and
``--trace-spans`` (the spans and counters of ``train/trace.py`` at the
loop's layer boundaries, summed into each epoch's record).
"""

from __future__ import annotations

import contextlib
import itertools
import math
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
from pytorch_scalablefhvae_tpu_torch.data.device_store import (
    STORE_TAIL_SLACK,
    DeviceDataSource,
    DeviceEpochPlanner,
    EpochPlan,
    resolve_data_placement,
    staging_itemsize,
)
from pytorch_scalablefhvae_tpu_torch.data.stream_store import (
    StreamingDeviceSource,
    resolve_tier,
)
from pytorch_scalablefhvae_tpu_torch.models.base import build_model
from pytorch_scalablefhvae_tpu_torch.parallel.mesh import (
    is_sharded,
    make_mesh,
    replicas_equal,
    shard_model,
    whole_tensors,
)
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train import trace
from pytorch_scalablefhvae_tpu_torch.train.device_step import (
    MAP_SPB,
    PlanInputs,
    device_eval_pass,
    device_map_pass,
    device_map_pass_chunked,
    device_train_step,
)
from pytorch_scalablefhvae_tpu_torch.train.graphs import (
    HostInputs,
    StepBundle,
    dispatch_line,
    launch_span,
)
from pytorch_scalablefhvae_tpu_torch.train.metrics import (
    MetricHistory,
    MetricWriter,
)
from pytorch_scalablefhvae_tpu_torch.train.orbax_backend import (
    save_checkpoint_orbax,
    wait_for_saves,
)
from pytorch_scalablefhvae_tpu_torch.train.plots import write_curves_svg
from pytorch_scalablefhvae_tpu_torch.train.rounds import (
    Rounds,
    check_round_table,
    round_ceiling,
)
from pytorch_scalablefhvae_tpu_torch.train.step import (
    Optimizer,
    TrainState,
    create_train_state,
    encode_step,
    eval_step,
    host_to_device,
    make_grad_step,
    make_optimizer,
    snapshot_noise,
    train_step,
)
from pytorch_scalablefhvae_tpu_torch.utils.device import resolve_device


def check_best(val_lower_bound: float, best_val_lb: float) -> bool:
    """Higher dev lower bound is better (utils.py:14-17)."""
    return val_lower_bound > best_val_lb


def check_terminate(epoch: int, best_epoch: int, patience: int,
                    epochs: int) -> bool:
    """Stop after ``patience`` consecutive non-improving epochs, or at the
    epoch budget."""
    return epoch - best_epoch >= patience or epoch + 1 >= epochs


@dataclass
class EpochStats:
    train_loss: float   # count-weighted mean over the epoch's real rows
    segments: int       # real (non-padded) rows trained on
    steps: int
    seconds: float      # wall time of the epoch's steps, device work included
    diverged: bool = False

    @property
    def segments_per_sec(self) -> float:
        return self.segments / max(self.seconds, 1e-9)


@dataclass
class TrainResult:
    state: TrainState
    best_epoch: int
    best_val_lb: float
    last_epoch: int
    history: MetricHistory
    diverged: bool = False


class DispatchLosses:
    """An epoch's step losses, each dispatch's read from the device one
    dispatch late, so the host never waits on the work it just issued (the
    JAX loop's ``_record_dispatch``). ``prior``: a step checkpoint's
    ``mid_epoch``, whose ``batches_done`` and partials of the steps taken
    before the kill (``loss_sum``, ``count_sum``, ``elapsed_s``; a JAX
    cursor may lack them) :meth:`stats` folds in, so that a resumed epoch
    reports the whole epoch."""

    def __init__(self, prior: dict | None = None):
        self.values: list[float] = []
        self.rows: list[int] = []
        self._pending = None
        self.prior = prior or {}
        self.start_clock()

    def start_clock(self) -> None:
        """The epoch's steps start now (their wall time counts from here)."""
        self.t0 = time.perf_counter()

    def push(self, losses: torch.Tensor, rows) -> bool:
        """Keep this dispatch's losses (one per step, ``rows`` real rows
        each) and read the dispatch before's; False once a loss read is not
        finite."""
        ok = self.finish()
        self._pending = (losses, list(rows))
        return ok

    def finish(self) -> bool:
        """Read the last dispatch's losses."""
        if self._pending is None:
            return True
        losses, rows = self._pending
        self._pending = None
        with trace.span("loss_read"):
            vals = losses.reshape(-1).tolist()
        self.values += vals
        self.rows += rows
        return all(math.isfinite(v) for v in vals)

    def partials(self) -> dict:
        """The epoch so far, prior included, as a step checkpoint stores it
        (the JAX loop's cursor partials): the count-weighted loss sum, the
        real rows and the wall seconds of the steps read."""
        loss_sum, count = 0.0, 0
        for loss, rows in zip(self.values, self.rows):
            loss_sum += loss * rows
            count += rows
        return {"loss_sum": loss_sum + self.prior.get("loss_sum", 0.0),
                "count_sum": count + self.prior.get("count_sum", 0),
                "elapsed_s": time.perf_counter() - self.t0
                + self.prior.get("elapsed_s", 0.0)}

    def stats(self) -> EpochStats:
        """The epoch's count-weighted mean loss over the steps read, up to
        the first non-finite one (then ``diverged``), the prior's steps,
        rows and seconds included."""
        for i, loss in enumerate(self.values):
            if not math.isfinite(loss):
                return EpochStats(loss, sum(self.rows[:i]), len(self.values),
                                  time.perf_counter() - self.t0,
                                  diverged=True)
        p = self.partials()
        count = int(p["count_sum"])
        return EpochStats(p["loss_sum"] / max(count, 1), count,
                          int(self.prior.get("batches_done", 0))
                          + len(self.values), p["elapsed_s"])


class StopRun(Exception):
    """Unwinds an epoch from the step cadence: at ``--max-steps``, once the
    step checkpoint is written, or when the loss read before a save is not
    finite (``diverged``; nothing is written)."""

    def __init__(self, diverged: bool = False):
        super().__init__("diverged" if diverged else "--max-steps reached")
        self.diverged = diverged


class EpochCursor:
    """An epoch's place in its batch order for ``--ckpt-every-steps`` and
    ``--max-steps`` (the JAX loop's ``make_after_dispatch``): the batch it
    starts at (``prior``, the ``mid_epoch`` of the step checkpoint resumed
    from: its ``batches_done`` and partials; else 0), the batches done
    since, its :class:`DispatchLosses`, and the hook every tier calls after
    each dispatch (:meth:`push`).

    The step count is ``state.step``, a host int the steps and the bundle
    advance, so the hook costs no device sync unless it saves. It saves at
    the first dispatch boundary ``every`` batches or more after the last
    save, and at ``max_steps``, after which it raises :class:`StopRun`. Before
    a save it reads the dispatch still pending: a save never writes a state
    whose last loss is not finite. ``save(batches_done, partials)`` writes
    the step checkpoint; on a mesh every rank calls it, with the same
    decisions, since the loss and the step count are the same on every
    rank. Without ``every`` and ``max_steps`` the hook only counts."""

    def __init__(self, state: TrainState, prior: dict | None = None,
                 every: int = 0, max_steps: int = 0, save=None):
        self.state, self.every, self.max_steps, self.save = (
            state, every, max_steps, save)
        self.start = self.done = self._saved = int(
            (prior or {}).get("batches_done", 0))
        self.losses = DispatchLosses(prior)

    def room(self, n: int) -> int:
        """``n`` steps, clamped to those left before ``--max-steps``."""
        if not self.max_steps:
            return n
        return max(min(n, self.max_steps - self.state.step), 0)

    def push(self, losses: torch.Tensor, rows) -> bool:
        """A dispatch's losses (:meth:`DispatchLosses.push`), then the
        cadence; False once a loss read is not finite."""
        if not self.losses.push(losses, rows):
            return False
        self.after(len(rows))
        return True

    def after(self, n: int) -> None:
        """``n`` batches more are done: save and stop as due."""
        self.done += n
        due = bool(self.every) and self.done - self._saved >= self.every
        stop = bool(self.max_steps) and self.state.step >= self.max_steps
        if not (due or stop):
            return
        if not self.losses.finish():
            raise StopRun(diverged=True)
        self._saved = self.done
        self.save(self.done, self.losses.partials())
        if stop:
            raise StopRun()


def batch_tensors(b, device: torch.device, mesh=None):
    """``(feats, seq_idx, nsegs, weight)`` of a loader batch on ``device``:
    for a GPU, one pinned host copy and an asynchronous transfer each. With
    a ``mesh``, this rank's rows of the batch only."""
    arrays = (b.feats, b.seq_idx, b.nsegs, b.weight)
    if mesh is not None:
        rows = mesh.local_rows(len(b.weight))
        arrays = tuple(a[rows] for a in arrays)
    return tuple(host_to_device(a, device) for a in arrays)


@dataclass(frozen=True)
class LegacyEpochs:
    """``--legacy`` step epochs (the reference's ``train_model.py``): an
    epoch ends after ``steps_per_epoch`` batches of its shuffled order, or
    at the loader's end if that comes first, and every ``log_interval``
    batches the loop prints the JAX loop's progress line (where
    ``verbose``)."""

    steps_per_epoch: int
    log_interval: int
    verbose: bool = True

    def after(self, batch_idx: int, epoch: int, loader: SegmentLoader,
              loss: float) -> bool:
        """Print the progress line when due; True when the epoch ends."""
        if self.verbose and (batch_idx + 1) % self.log_interval == 0:
            pct = 100.0 * batch_idx / len(loader)
            print(f"====> Train Epoch: {epoch} "
                  f"[{batch_idx * loader.batch_size}/{len(loader.dataset)} "
                  f"({pct:.0f}%)]\tLoss: {loss:.6f}")
        return (batch_idx + 1) % self.steps_per_epoch == 0


def run_epoch(state: TrainState, optimizer: Optimizer, loader: SegmentLoader,
              alpha: float, device: torch.device, epoch: int,
              mesh=None, bundle: StepBundle | None = None,
              cursor: EpochCursor | None = None,
              legacy: LegacyEpochs | None = None) -> EpochStats:
    """One epoch of train steps over ``loader``'s order for ``epoch``, from
    the ``cursor``'s batch on (a mid-epoch resume; by default the first,
    with no step cadence); with ``legacy``, a step epoch of its first
    batches (:class:`LegacyEpochs`).

    Every step's loss comes back to the host (one scalar, the only sync per
    step); a non-finite loss ends the epoch at once with ``diverged``. The
    cursor stops the epoch after the step that reaches ``--max-steps``.
    With a ``bundle`` (its inputs :class:`HostInputs`), see
    :func:`run_bundled_epoch`."""
    loader.set_epoch(epoch)
    cursor = cursor or EpochCursor(state)
    if bundle is not None:
        return run_bundled_epoch(state, optimizer, loader, alpha, device,
                                 bundle, cursor)
    losses = cursor.losses
    losses.start_clock()
    with contextlib.closing(loader.batches_from(cursor.start)) as batches:
        for i, b in enumerate(batches):
            with trace.span("dispatch.load"):
                tensors = batch_tensors(b, device, mesh)
            with launch_span(False):
                metrics = train_step(state, optimizer, *tensors, alpha,
                                     mesh=mesh)
            losses.push(metrics["loss"], [b.num_real])
            if not losses.finish():
                break
            cursor.after(1)
            if legacy is not None and legacy.after(i, epoch, loader,
                                                   losses.values[-1]):
                break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return losses.stats()


def run_bundled_epoch(state: TrainState, optimizer: Optimizer,
                      loader: SegmentLoader, alpha: float,
                      device: torch.device, bundle: StepBundle,
                      cursor: EpochCursor) -> EpochStats:
    """The host loader's epoch in K-step dispatches from the ``cursor``'s
    batch on: every K batches are stacked into the bundle's static inputs
    (through pinned buffers, while the device runs the dispatch before) and
    run as one dispatch; the last ``n % K`` batches run as eager steps. The
    feed stops at the batch that reaches ``--max-steps`` (the JAX loop's
    ``islice``), so no dispatch runs past it. Losses are read one dispatch
    late (:class:`DispatchLosses`). On the bundle's mesh both take this
    rank's rows of each batch."""
    losses = cursor.losses
    losses.start_clock()
    feed = loader.batches_from(cursor.start)
    group, ok = [], True
    with contextlib.closing(feed):
        for b in itertools.islice(feed, cursor.room(len(loader))):
            group.append(b)
            if len(group) == bundle.k:
                with trace.span("dispatch.load"):
                    bundle.inputs.load(group)
                ok = cursor.push(bundle()["loss"].clone(),
                                 [g.num_real for g in group])
                group = []
                if not ok:
                    break
    mesh = bundle.mesh
    for b in group if ok else ():
        with trace.span("dispatch.load"):
            tensors = batch_tensors(b, device, mesh)
        with launch_span(False):
            metrics = train_step(state, optimizer, *tensors, alpha,
                                 mesh=mesh)
        if not cursor.push(metrics["loss"], [b.num_real]):
            break
    losses.finish()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return losses.stats()


def run_plan(state: TrainState, optimizer: Optimizer, store, arrays,
             plan: EpochPlan, start_batch: int, alpha: float,
             cursor: EpochCursor, bundle: StepBundle | None, seg_len: int,
             mesh=None) -> bool:
    """The plan's batches from ``start_batch`` on, gathered from ``store``:
    K to a bundle dispatch while K remain before the plan's end and before
    ``--max-steps``, the rest as eager steps (the bundle's K is fixed, so
    the JAX loop's clamped dispatch runs here as eager steps, which give
    the bundle's bits), each dispatch's losses pushed to the ``cursor``.
    False once a loss read is not finite."""
    B = plan.batch_size
    counts = plan.batch_real_counts()
    if bundle is not None:
        with trace.span("steps.plan"):
            bundle.inputs.load_plan(arrays, plan.n_real)
    b = start_batch
    while b < plan.n_batches:
        if bundle is not None and cursor.room(plan.n_batches - b) >= bundle.k:
            with trace.span("dispatch.load"):
                bundle.inputs.set_base(b * B)
            loss, n = bundle()["loss"].clone(), bundle.k
        else:
            with launch_span(False):
                loss, n = device_train_step(
                    state, optimizer, store, arrays, b * B, plan.n_real,
                    alpha, batch_size=B, seg_len=seg_len,
                    mesh=mesh)["loss"], 1
        if not cursor.push(loss, counts[b:b + n]):
            return False
        b += n
    return True


def run_device_epoch(state: TrainState, optimizer: Optimizer,
                     source: DeviceDataSource, loader: SegmentLoader,
                     alpha: float, device: torch.device, epoch: int,
                     mesh=None, bundle: StepBundle | None = None,
                     cursor: EpochCursor | None = None,
                     plan_rows: int | None = None,
                     planner: DeviceEpochPlanner | None = None
                     ) -> EpochStats:
    """One epoch of train steps gathered from the staged store, over the
    host loader's own permutation for ``epoch``, so both tiers train on the
    same batches, from the ``cursor``'s batch on (:func:`run_plan`, which
    also clamps the dispatches at ``--max-steps``). ``plan_rows``: the
    plan's fixed length (a hierarchical round's, so that every round's plan
    fills the bundle's buffers). With a ``planner`` (``--epoch-plan
    device``) the epoch's plan is derived on the device instead, a
    permutation of its own; :func:`run_plan` copies it into the bundle's
    buffers in stream order before the first dispatch.

    Each step's loss comes back to the host after the next step has been
    issued (lag one), so the host never waits on the step it just issued;
    the last one is checked at the epoch's end. A non-finite loss ends the
    epoch with ``diverged``. With a ``bundle`` (its inputs
    :class:`PlanInputs`) the batches go K to a dispatch, the last ``n % K``
    as eager steps, and each dispatch's losses are read one dispatch
    late."""
    loader.set_epoch(epoch)
    cursor = cursor or EpochCursor(state)
    ds, B = loader.dataset, loader.batch_size
    with trace.span("steps.plan"):
        if planner is not None:
            plan, arrays = planner.plan(epoch, len(ds), B)
        else:
            plan, arrays = source.stage_epoch(ds, loader._order(), B,
                                              pad_rows=plan_rows)
    cursor.losses.start_clock()
    run_plan(state, optimizer, source.data, arrays, plan, cursor.start, alpha,
             cursor, bundle, ds.seg_len, mesh)
    cursor.losses.finish()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return cursor.losses.stats()


def stream_seed(loader: SegmentLoader, epoch: int) -> int:
    """The seed of ``epoch``'s stream schedule: the host loader's shuffle
    seed, as the JAX loop takes it."""
    return loader.seed + 1_000_003 * epoch


def run_stream_epoch(state: TrainState, optimizer: Optimizer,
                     source: StreamingDeviceSource, loader: SegmentLoader,
                     alpha: float, device: torch.device, epoch: int,
                     bundle: StepBundle | None = None,
                     cursor: EpochCursor | None = None,
                     mesh=None) -> EpochStats:
    """One epoch of the streamed tier: the chunks in the epoch's shuffled
    order, each chunk's segments in its own permutation
    (``source.epoch_schedule``), gathered from the chunk's slot while the
    next chunk is copied in. Within a chunk the dispatches run as on the
    device tier (:func:`run_plan`; a chunk's ``n % K`` batches as eager
    steps), the losses read one dispatch late across chunks; the epoch's
    statistics count every chunk's steps, as the other tiers count
    theirs. From a mid-epoch ``cursor`` the chunks wholly behind it are
    never staged (``epoch_batches(skip_batches=)``); the cursor counts the
    epoch's batches across chunks, and a stop in the middle of a chunk
    closes the chunk generator, which releases its filler thread. On a
    ``mesh`` every rank streams the same schedule and takes its rows of each
    batch (``rank_views``)."""
    loader.set_epoch(epoch)
    cursor = cursor or EpochCursor(state)
    seg_len = loader.dataset.seg_len
    cursor.losses.start_clock()
    chunks = source.epoch_batches(stream_seed(loader, epoch),
                                  skip_batches=cursor.start)
    with contextlib.closing(chunks):
        for chunk in chunks:
            if not run_plan(state, optimizer, source.data, chunk.arrays,
                            chunk.plan, chunk.start_batch, alpha, cursor,
                            bundle, seg_len, mesh):
                break
    cursor.losses.finish()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return cursor.losses.stats()


def _map_table(sums: np.ndarray, counts: np.ndarray, pz2_var: float,
               pmu2_var: float = 1.0) -> np.ndarray:
    """Closed-form MAP posterior mean from fp64 accumulators:
    ``mu2[y] = sum / (count + pz2_var / pmu2_var)`` (utils.py:58-59)."""
    r = pz2_var / pmu2_var
    return (sums / (counts + r)[:, None]).astype(np.float32)


def estimate_split_mu2(model, loader: SegmentLoader, num_seqs: int,
                       pz2_var: float, device: torch.device,
                       pmu2_var: float = 1.0, mesh=None) -> np.ndarray:
    """MAP-estimate a split's mu2 table from the z2 encoder's means:
    ``mu2[y] = sum(z2_mu of y's segments) / (nsegs(y) + pz2_var/pmu2_var)``,
    accumulated on the host in fp64. With a ``mesh`` each rank encodes its
    rows of every batch and the sums are added up over the data group."""
    sums = np.zeros((num_seqs, model.z2_dim), dtype=np.float64)
    counts = np.zeros(num_seqs, dtype=np.float64)
    for b in loader:
        z2 = encode_step(model, batch_tensors(b, device, mesh)[0]) \
            .cpu().numpy()
        rows = (slice(None) if mesh is None
                else mesh.local_rows(len(b.weight)))
        seq_idx, real = b.seq_idx[rows], b.weight[rows] > 0
        np.add.at(sums, seq_idx[real], z2[real])
        np.add.at(counts, seq_idx[real], 1.0)
    if mesh is not None:
        sums, counts = mesh.data_sum_host(sums, counts)
    return _map_table(sums, counts, pz2_var, pmu2_var)


def evaluate_split(model, loader: SegmentLoader, alpha: float,
                   device: torch.device, table: torch.Tensor | None = None,
                   mesh=None) -> dict[str, float]:
    """Exact weighted means of every metric over a split (sums and counts
    accumulated in fp64), scored against ``table`` when given. With a
    ``mesh`` each rank scores its rows of every batch and the totals are
    added up over the data group."""

    def per_batch():
        for b in loader:
            sums = eval_step(model, *batch_tensors(b, device, mesh), alpha,
                             table)
            yield sums.keys(), torch.stack(list(sums.values())).double() \
                .cpu().tolist()

    return split_means(per_batch(), mesh)


def split_means(per_batch, mesh=None) -> dict[str, float]:
    """Weighted means from ``(keys, values)`` of each batch's metric sums
    (``count`` among the keys), added in batch order in fp64; with a
    ``mesh`` the ranks' totals are added up over the data group first."""
    totals: dict[str, float] = {}
    count = 0.0
    for keys, vals in per_batch:
        for k, v in zip(keys, vals):
            if k == "count":
                count += v
            else:
                totals[k] = totals.get(k, 0.0) + v
    if mesh is not None and totals:
        summed, = mesh.data_sum_host(np.array([count, *totals.values()]))
        count, totals = summed[0], dict(zip(totals, summed[1:].tolist()))
    if count == 0:
        return {k: float("nan") for k in ("loss", "lower_bound", "log_qy")}
    return {k: v / count for k, v in totals.items()}


def dev_pass(model, loader: SegmentLoader, alpha: float,
             device: torch.device, mesh=None) -> dict[str, float]:
    """The per-epoch dev lower bound: held-out sequences have no rows in the
    learned table, so they are scored against their MAP estimates. With a
    ``mesh`` both passes split their batches over the data ranks."""
    pz2_var = float(math.exp(model.pz2_logvar))
    with trace.span("dev_pass"):
        with trace.span("dev_pass.map"):
            table = estimate_split_mu2(model, loader, loader.dataset.num_seqs,
                                       pz2_var, device, mesh=mesh)
        with trace.span("dev_pass.score"):
            return evaluate_split(model, loader, alpha, device,
                                  table=torch.from_numpy(table).to(device),
                                  mesh=mesh)


@dataclass
class DeviceSplit:
    """A split staged for the device dev pass: its store, its ordered array
    plan on the device and, where the chunked MAP pass applies, the
    sequences' first frames and window counts with its batch count."""

    loader: SegmentLoader
    source: DeviceDataSource
    plan: EpochPlan
    arrays: tuple
    chunked: tuple | None


def stage_split(loader: SegmentLoader, device: torch.device,
                mesh=None, store_dtype: str = "float32",
                shard_store: bool = False) -> DeviceSplit:
    """Stage ``loader``'s split (ordered) on ``device`` in ``store_dtype``,
    on a rank of ``mesh`` row-sharded with ``shard_store``. Its MAP pass is
    the chunked one (kernel #8, on float32 or bfloat16 rows) when windows
    are deterministic, the store is not int8, the batch is a multiple of
    ``MAP_SPB``, a chunk's region fits the store's slack and the run is not
    a mesh run, as the JAX loop decides it."""
    ds, B = loader.dataset, loader.batch_size
    source = DeviceDataSource(ds.store, device, store_dtype, mesh=mesh,
                              shard_store=shard_store)
    plan, arrays = source.stage_epoch(ds, np.arange(len(ds)), B)
    chunked = None
    if (mesh is None and not ds.rand_seg and store_dtype != "int8"
            and B % MAP_SPB == 0
            and (MAP_SPB - 1) * ds.seg_shift + ds.seg_len <= STORE_TAIL_SLACK):
        padded = int((-(-ds.nsegs // MAP_SPB) * MAP_SPB).sum())
        chunked = (source.upload(ds.store.seq_starts, torch.long),
                   source.upload(ds.nsegs, torch.long),
                   max(-(-padded // B), 1))
    return DeviceSplit(loader, source, plan, arrays, chunked)


def device_dev_pass(model, split: DeviceSplit, alpha: float,
                    mesh=None) -> dict[str, float]:
    """:func:`dev_pass` over a staged split: the MAP table (fp32 sums on the
    device) and the scoring pass stay on the device; the per-batch sums come
    back in one fetch and are added as :func:`evaluate_split` adds them.
    With a ``mesh`` each rank takes its rows of every batch."""
    ds, B = split.loader.dataset, split.loader.batch_size
    store, plan = split.source.data, split.plan
    pz2_var = float(math.exp(model.pz2_logvar))
    with trace.span("dev_pass"):
        with trace.span("dev_pass.map"):
            if split.chunked is not None:
                starts, nsegs, n_batches = split.chunked
                table = device_map_pass_chunked(
                    model, store, starts, nsegs, seg_len=ds.seg_len,
                    seg_shift=ds.seg_shift, batch_size=B,
                    n_batches=n_batches, num_rows=ds.num_seqs,
                    pz2_var=pz2_var, spb=MAP_SPB)
            else:
                table = device_map_pass(
                    model, store, split.arrays[0], split.arrays[1],
                    plan.n_real, seg_len=ds.seg_len, batch_size=B,
                    n_batches=plan.n_batches, num_rows=ds.num_seqs,
                    pz2_var=pz2_var, mesh=mesh)
        with trace.span("dev_pass.score"):
            stacked = device_eval_pass(model, store, split.arrays,
                                       plan.n_real, alpha, table,
                                       batch_size=B, seg_len=ds.seg_len,
                                       n_batches=plan.n_batches, mesh=mesh)
        keys = list(stacked)
        with trace.span("dev_pass.fetch"):
            mat = torch.stack([stacked[k] for k in keys]).double().cpu()
        return split_means((keys, row) for row in mat.T.tolist())


def staged_mb(store, store_dtype: str, rows: int | None = None) -> float:
    """MB of ``rows`` (all of the store's by default) staged in
    ``store_dtype``."""
    rows = store.data.shape[0] if rows is None else rows
    return rows * store.dim * staging_itemsize(store_dtype) / 1e6


def stage_train_tier(config: ExperimentConfig, tier: str,
                     train_loader: SegmentLoader, device: torch.device,
                     verbose: bool, ceiling: int | None = None, mesh=None):
    """The training tier's source, ``DeviceDataSource`` (``"device"``; or
    ``"round"``, an empty buffer of ``ceiling`` rows for hierarchical
    rounds) or ``StreamingDeviceSource`` (``"stream"``; chunks of
    ``--stream-chunk-bytes``, by default a quarter of the budget), in the
    run's transfer dtype, and the bytes it holds on the device as the dev
    split's budget counts them: the whole store, the ceiling's rows (each
    round is staged into the same buffer, in stream order), or three chunks
    (two slots and what a draining dispatch still reads), of the whole
    store whether or not it is row-sharded over ``mesh``
    (``--shard-device-store``), as the JAX loop counts them."""
    ds, dtype = train_loader.dataset, config.data.transfer_dtype
    shard = config.data.shard_device_store
    if tier == "round":
        # the ceiling's rows, empty: each round restages its sub-pack (on a
        # mesh with --shard-device-store this rank's rows of it)
        source = DeviceDataSource(ds.store.subset([], materialize=True),
                                  device, dtype, pad_to_rows=ceiling,
                                  mesh=mesh, shard_store=shard)
        return source, ceiling * ds.store.dim * staging_itemsize(dtype)
    if tier == "device":
        source = DeviceDataSource(ds.store, device, dtype, mesh=mesh,
                                  shard_store=shard)
        if verbose:
            print(f"Training data device-resident "
                  f"({staged_mb(ds.store, dtype):.0f} MB staged"
                  f"{', row-sharded' if source.shard_store else ''})")
        return source, ds.store.data.shape[0] * ds.store.dim \
            * staging_itemsize(dtype)
    chunk_bytes = (config.data.stream_chunk_bytes
                   or max(config.data.device_store_max_bytes // 4, 1))
    source = StreamingDeviceSource(ds, chunk_bytes, train_loader.batch_size,
                                   device, dtype, mesh=mesh, shard_store=shard)
    if verbose:
        print(f"Training data streams through the device "
              f"({len(source.chunks)} chunks of "
              f"{staged_mb(ds.store, dtype, source.chunk_rows):.1f} MB in "
              f"{dtype}, double-buffered"
              f"{', row-sharded' if source.shard_store else ''}; "
              f"{source.host_bytes_per_epoch() / 1e6:.1f} MB over the link "
              f"an epoch{' a rank' if mesh is not None else ''})")
    return source, 3 * source.chunk_rows * ds.store.dim * source.itemsize


def stage_dev_tier(config: ExperimentConfig, dev_loader: SegmentLoader,
                   device: torch.device, train_bytes: int, verbose: bool,
                   mesh=None) -> DeviceSplit | None:
    """The dev split staged in the run's transfer dtype where it fits what
    the training tier's ``train_bytes`` leave of the budget (``"auto"``
    against the rest, so that a train store that barely fits never runs out
    of memory for the dev split; scaled by the model axis when it is
    row-sharded over ``mesh``), or ``None``."""
    dev_store, dtype = dev_loader.dataset.store, config.data.transfer_dtype
    shard = config.data.shard_device_store
    if not resolve_data_placement(
            "auto", dev_store, mesh, shard_store=shard, store_dtype=dtype,
            max_bytes=max(config.data.device_store_max_bytes - train_bytes,
                          0)):
        return None
    split = stage_split(dev_loader, device, mesh, dtype, shard)
    if verbose:
        print(f"Dev split device-resident ({staged_mb(dev_store, dtype):.0f} "
              f"MB staged"
              f"{', row-sharded' if split.source.shard_store else ''})")
    return split


@contextlib.contextmanager
def epoch_profile(profile_dir: str, name: str, device: torch.device,
                  verbose: bool = True):
    """``--profile-dir``: the epoch's training (not its dev pass) under
    ``torch.profiler`` with CPU and, on a GPU, CUDA activities, written as a
    Chrome trace ``<profile_dir>/<name>.pt.trace.json`` (the JAX loop's
    ``jax.profiler`` trace of the same epoch). The epoch runners synchronise
    the device before they return, so the trace holds the epoch's kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"{name}.pt.trace.json"))
    if verbose:
        print(f"Wrote profiler trace to {profile_dir}")


def save_state(exp_dir: Path, state: TrainState, config: ExperimentConfig,
               epoch: int, best_epoch: int, best_val_lb: float,
               history: MetricHistory, extra_meta: dict,
               summary_vals: dict | None = None,
               cursor: dict | None = None) -> Path:
    """The one checkpoint writer of both cadences and both backends (the JAX
    loop's ``save_state_checkpoint``), so that a field cannot go missing
    from one of them: the epoch checkpoint (full training state, its
    ``summary_vals``, and a ``best_model_`` copy, or with ``--ckpt-backend
    orbax`` the best pointer, when this epoch is the best), or with a
    ``cursor`` (``mid_epoch``: the epoch, ``batches_done`` and the
    partials) the step checkpoint ``..._e<epoch>s<batches_done>``. The
    orbax backend returns once the state is staged
    (``train/orbax_backend.py``)."""
    model = state.model
    extra = dict(extra_meta)
    if cursor is not None:
        extra["mid_epoch"] = cursor
    suffix = "" if cursor is None else f"s{cursor['batches_done']}"
    with trace.span("save"):
        if config.train.ckpt_backend == "orbax":
            meta = {"model_type": model.model_type,
                    "model_params": list(model.model_params()),
                    "best_epoch": best_epoch,
                    "best_val_lb": float(best_val_lb),
                    "values": history.to_json_dict(), **extra}
            if summary_vals is not None:
                meta["summary_vals"] = summary_vals
            return save_checkpoint_orbax(
                exp_dir, state, model_type=model.model_type,
                run_info=config.base_string(), epoch=epoch, meta=meta,
                suffix=suffix)
        return ckpt.save_checkpoint(
            exp_dir, model, model_type=model.model_type,
            model_params=model.model_params(),
            run_info=config.base_string(), epoch=epoch,
            best_epoch=best_epoch, best_val_lb=float(best_val_lb),
            values=history.to_json_dict(), extra_meta=extra,
            train_state=state, summary_vals=summary_vals, suffix=suffix)


def run_training(config: ExperimentConfig, train_loader: SegmentLoader,
                 dev_loader: SegmentLoader, exp_dir: str | Path,
                 continue_from: str | Path | None = None,
                 finetune: bool = False, device: str = "cuda",
                 verbose: bool = True,
                 trace_spans: bool = False) -> TrainResult:
    """Train from scratch or resume: epochs of training, a dev pass and a
    checkpoint each, early stopping by patience. A non-finite training loss
    stops the run with ``diverged`` set, before that epoch is saved. The
    data tier is resolved first (:func:`resolve_tier`): the device-resident
    store, the streamed tier, or the host loader; for hierarchical rounds
    also per-round staging (``train/rounds.py``). A mesh run
    (``config.train.mesh_shape`` other than ``(1, 1)``, or an initialised
    ``torch.distributed``) is one call of this on every rank, each with its
    own ``device``.

    ``trace_spans`` (``--trace-spans``) records the loop's spans and
    counters (``train/trace.py``), as the ``--profile-dir`` epoch does, and
    adds their ``spans`` and ``counters`` to each epoch's record in
    ``metrics.jsonl``."""
    exp_dir = Path(exp_dir)
    dev = resolve_device(device)
    mesh = None
    if tuple(config.train.mesh_shape) != (1, 1) or dist.is_initialized():
        mesh = make_mesh(tuple(config.train.mesh_shape), dev)
        if train_loader.batch_size % mesh.shape[0]:
            raise ValueError(
                f"the data axis ({mesh.shape[0]}) must divide the training "
                f"batch size ({train_loader.batch_size})")
    first = mesh is None or mesh.rank == 0  # the rank that prints and writes
    verbose = verbose and first
    if first:
        exp_dir.mkdir(parents=True, exist_ok=True)
        config.save(exp_dir / "config.json")

    ds = train_loader.dataset
    hier = config.train.sample_hierarchical
    placement = config.data.data_placement
    legacy = config.train.legacy
    tier = resolve_tier(placement, ds.store,
                        config.data.device_store_max_bytes,
                        config.data.transfer_dtype, verbose=first, mesh=mesh,
                        shard_store=config.data.shard_device_store,
                        hierarchical=hier, legacy=legacy)
    seg_len, dim, num_seqs = ds.seg_len, ds.store.dim, ds.num_seqs
    ceiling = None
    if hier:
        # a round's K rows size the table; over the budget each round's
        # sub-pack is staged where one fits (which may lower K)
        num_seqs = min(config.train.num_hierarchical_sequences, num_seqs)
        if tier == "host" and placement != "host" and not legacy:
            num_seqs, ceiling = round_ceiling(
                placement, ds.store, num_seqs,
                config.data.device_store_max_bytes,
                config.data.transfer_dtype, verbose, mesh,
                config.data.shard_device_store)
            if ceiling is not None:
                tier = "round"
    source, dev_split = None, None
    if tier != "host":
        source, train_bytes = stage_train_tier(config, tier, train_loader,
                                               dev, verbose, ceiling, mesh)
        dev_split = stage_dev_tier(config, dev_loader, dev, train_bytes,
                                   verbose, mesh)
    seed = config.train.seed
    model = build_model(config.model.model_type, seg_len * dim, config.model,
                        num_seqs, feat_dim=dim,
                        generator=torch.Generator().manual_seed(seed))
    # both dev passes split over the data ranks when they can
    dev_mesh = None
    if mesh is not None:
        model = shard_model(model, mesh)
        if dev_loader.batch_size % mesh.shape[0] == 0:
            dev_mesh = mesh
        if verbose:
            print(f"Training on mesh {{'data': {mesh.shape[0]}, 'model': "
                  f"{mesh.shape[1]}}}: {model.num_seqs_padded} mu2 rows, "
                  f"{model.table_rows} per rank")
    state = create_train_state(model.to(dev), seed=seed)
    optimizer = make_optimizer(config.optim.learning_rate,
                               config.optim.beta_one, config.optim.beta_two)
    alpha = config.optim.alpha_dis

    # the step cadence: a resume re-enters an epoch's batch order at its
    # cursor, which holds since that order is a function of (seed, epoch)
    every = max(config.train.ckpt_every_steps, 0)
    max_steps = max(config.train.max_steps, 0)
    if (every or max_steps) and legacy:
        raise ValueError(
            "--ckpt-every-steps/--max-steps are not supported with legacy "
            "step-epochs (their schedule is not a pure function of "
            "(seed, epoch))")
    start_epoch, best_epoch, best_val_lb = 0, 0, -np.inf
    history = MetricHistory()
    mid = None  # the cursor of a mid-epoch checkpoint resumed from
    corpus_fp = ckpt.corpus_fingerprint(ds.store.seq_keys)
    if continue_from is not None:
        # a hierarchical table is the round's, re-estimated at the next
        # turnover: another corpus is no fault, another K is
        if hier and not finetune:
            check_round_table(continue_from, model, num_seqs)
        meta = ckpt.load_train_state(
            continue_from, state, finetune=finetune,
            expected_num_seqs=None if hier else num_seqs,
            expected_fingerprint=None if hier else corpus_fp)
        start_epoch = meta["start_epoch"]
        best_epoch = meta.get("best_epoch", 0)
        best_val_lb = meta.get("best_val_lb", -np.inf)
        history = MetricHistory(meta.get("values", {}))
        mid = None if finetune else meta.get("mid_epoch")
        if mid is not None:
            start_epoch = int(mid["epoch"])
        if verbose:
            print(f"Resumed from {continue_from} at epoch {start_epoch} "
                  f"(step {state.step}"
                  + (f", mid-epoch at batch {int(mid['batches_done'])})"
                     if mid is not None else ")"))

    # legacy step epochs run one eager step a batch, as the JAX loop does
    k = 1 if legacy else config.train.steps_per_dispatch
    bundle = None
    if k > 1:
        if tier == "host":
            inputs = HostInputs(
                k, train_loader.batch_size, seg_len, dim, dev,
                torch.bfloat16 if train_loader.bfloat16 else torch.float32,
                mesh)
        else:
            inputs = PlanInputs(source.data, train_loader.batch_size,
                                seg_len, mesh)
        bundle = StepBundle(state, optimizer, alpha, k, inputs, dev, mesh)
        if verbose:
            print(dispatch_line(k, dev.type,
                                None if mesh is None else mesh.backend))

    staged = tier in ("device", "round")
    device_plan = config.data.epoch_plan == "device" and staged
    if device_plan and ds.rand_seg:
        raise ValueError(
            "--epoch-plan device requires deterministic windowing (rand_seg "
            "draws window starts on the host); use --epoch-plan host")
    if config.data.epoch_plan == "device" and not staged and first:
        print("epoch_plan=device ignored: training data is "
              + ("chunk-streamed (plans are per-chunk, host-derived)"
                 if tier == "stream" else "host-resident"))
    rounds = Rounds(config, train_loader, tier, source, num_seqs, dev,
                    device_plan, mesh) if hier else None
    planner = None if rounds is None else rounds.planner
    if device_plan and rounds is None:
        rows = len(ds) + (-len(ds)) % train_loader.batch_size
        planner = DeviceEpochPlanner(source, seed, ds.seg_shift, rows)
        planner.stage(ds)
    if device_plan and verbose:
        print("Epoch plans derive on the device (upload: one generator "
              "seed)")
    t = config.train
    writer = (MetricWriter(exp_dir, config.run_id(), tensorboard=t.tensorboard,
                           tb_log_dir=t.tb_log_dir, log_params=t.log_params)
              if first else None)
    # the --log-params snapshot: one more forward and backward an epoch, on
    # every rank of a mesh; only with --tensorboard, as the JAX loop builds it
    grad_step = (make_grad_step(alpha, mesh)
                 if t.log_params and t.tensorboard else None)
    if start_epoch > 0 and first:
        writer.replay_history(history, start_epoch)
    legacy_epochs = (LegacyEpochs(t.steps_per_epoch, t.log_interval, verbose)
                     if legacy else None)
    profile_at = (min(t.profile_epoch, t.epochs - 1)
                  if t.profile_dir is not None else None)
    extra = {"num_seqs": num_seqs, "feat_dim": dim, "seg_len": seg_len,
             "corpus_fingerprint": corpus_fp}
    result = TrainResult(state, best_epoch, best_val_lb, start_epoch - 1,
                         history)
    if max_steps and state.step >= max_steps:
        # resumed at the cap: train nothing, or every call of the same
        # resume command would creep on by a dispatch
        if verbose:
            print(f"--max-steps {max_steps} already reached at restore "
                  f"(step {state.step}); nothing to train")
        if first:
            writer.close()
        return result
    trace.take()  # another run's spans are none of this run's epochs
    for epoch in range(start_epoch, config.train.epochs):
        trace.set_epoch(epoch)
        # the epoch: its turnover, steps, dev pass and save, with the
        # loop's own work between them; its record is written after it
        with trace.recording(trace_spans or epoch == profile_at), \
                trace.span("epoch"):
            on_cursor = mid is not None and epoch == int(mid["epoch"])
            loader = train_loader if rounds is None else rounds.loader_for(
                epoch, state, on_cursor, verbose)

            def save_mid(batches_done, partials, epoch=epoch):
                save_state(exp_dir, state, config, epoch, best_epoch,
                           best_val_lb, history, extra,
                           cursor={"epoch": epoch,
                                   "batches_done": batches_done, **partials})

            cursor = EpochCursor(state, mid if on_cursor else None, every,
                                 max_steps, save_mid)
            # the trace's stem: the run, the epoch and, on a mesh, the rank
            profiling = (epoch_profile(
                t.profile_dir, f"{config.run_id()}_e{epoch}"
                + ("" if mesh is None else f"_rank{mesh.rank}"), dev,
                verbose) if epoch == profile_at else contextlib.nullcontext())
            with profiling, trace.span("steps"):
                try:
                    if tier in ("device", "round"):
                        stats = run_device_epoch(
                            state, optimizer, source, loader, alpha, dev,
                            epoch, mesh, bundle, cursor,
                            None if rounds is None else rounds.plan_rows,
                            planner)
                    elif tier == "stream":
                        stats = run_stream_epoch(
                            state, optimizer, source, train_loader, alpha,
                            dev, epoch, bundle, cursor, mesh)
                    else:
                        stats = run_epoch(state, optimizer, loader, alpha,
                                          dev, epoch, mesh, bundle, cursor,
                                          legacy_epochs)
                except StopRun as stop:
                    if stop.diverged:  # the save gate read a non-finite loss
                        stats = cursor.losses.stats()
                    else:
                        if verbose:
                            print(f"Reached --max-steps {max_steps} at epoch "
                                  f"{epoch}, batch {cursor.done} (step "
                                  f"{state.step}); mid-epoch checkpoint "
                                  f"saved")
                        result = TrainResult(state, best_epoch, best_val_lb,
                                             epoch, history)
                        break
            if stats.diverged:
                if first:
                    print("Training diverged")
                    writer.close()
                wait_for_saves()
                result.diverged, result.last_epoch = True, epoch
                return result
            if verbose and tier == "stream" and cursor.start:
                print(f"Resumed epoch {epoch} at batch {cursor.start}: "
                      f"staged {len(source.switch_waits())} of "
                      f"{len(source.chunks)} chunks")
            if mesh is not None and not replicas_equal(mesh, [
                    p for n, p in state.params().items()
                    if not is_sharded(n, p)]):
                raise RuntimeError(
                    f"epoch {epoch}: the replicated parameters differ "
                    f"between the ranks of the mesh")
            if verbose:
                print(f"====> Epoch {epoch}: train loss "
                      f"{stats.train_loss:.4f}, {stats.steps} steps in "
                      f"{stats.seconds:.2f} s "
                      f"({stats.segments_per_sec:.1f} segments/s)")
            val = (device_dev_pass(model, dev_split, alpha, dev_mesh)
                   if dev_split is not None
                   else dev_pass(model, dev_loader, alpha, dev, dev_mesh))
            if verbose:
                print(f"====> Validation set loss: {val['loss']:.4f}  "
                      f"LB: {val['lower_bound']:.4f}")
            history.record(epoch, stats.train_loss, val["loss"],
                           val["lower_bound"], val["log_qy"])
            scalars = {
                "train_loss": stats.train_loss,
                "train_segments_per_sec": stats.segments_per_sec,
                "train_steps": stats.steps,
                "train_seconds": stats.seconds,
                "step": state.step,
                "val_loss": val["loss"],
                "val_lower_bound": val["lower_bound"],
                "val_log_qy": val["log_qy"],
                "val_log_px_z": val.get("log_px_z", float("nan")),
                "val_neg_kld_z1": val.get("neg_kld_z1", float("nan")),
                "val_neg_kld_z2": val.get("neg_kld_z2", float("nan")),
                "val_log_pmu2": val.get("log_pmu2", float("nan")),
            }
            grads = params = None
            if grad_step is not None:
                with contextlib.closing(loader.batches_from(0)) as batches:
                    b = next(batches)
                feats, *rest = batch_tensors(b, dev, mesh)
                grads = grad_step(state, feats, *rest, snapshot_noise(
                    state, epoch, feats.shape[0], dev, mesh))
                params = state.params()
                if mesh is not None:
                    grads = whole_tensors(mesh, grads)
                    params = whole_tensors(mesh, params)
            if first and t.plot_curves:
                write_curves_svg(history, exp_dir / "curves.svg",
                                 config.run_id())
            if check_best(val["lower_bound"], best_val_lb):
                best_epoch, best_val_lb = epoch, val["lower_bound"]
            save_state(exp_dir, state, config, epoch, best_epoch,
                       best_val_lb, history, extra,
                       {k: float(v) for k, v in scalars.items()})
            if every or max_steps or mid is not None:
                # the epoch checkpoint supersedes this run's step
                # checkpoints of this epoch and before, a --max-steps
                # stop's included when this run has no cadence flag; on a
                # mesh, once every rank is past its save and has flushed
                # its async ones
                wait_for_saves()
                if mesh is not None:
                    dist.barrier()
                if first:
                    ckpt.cleanup_mid_epoch(exp_dir, model.model_type,
                                           config.base_string(), epoch)
        # each rank's spans; rank 0 writes its own with the record
        records, counters = trace.take()
        if first:
            if trace_spans:
                scalars.update(spans=trace.summary(records),
                               counters=counters)
            writer.write_epoch(epoch, scalars, params=params, grads=grads)
        result = TrainResult(state, best_epoch, best_val_lb, epoch, history)
        if check_terminate(epoch, best_epoch, config.train.patience,
                           config.train.epochs):
            if verbose:
                print("Training terminated!")
            break
    if first:
        writer.close()
    wait_for_saves()
    if verbose:
        print("Training complete!")
    return result
