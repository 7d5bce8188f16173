"""The training loop: counterpart of ``train/loop.py`` on one device.

Separate pieces rather than the JAX package's one ``run_training`` body:
:func:`run_epoch` (the host loader: one pass over the shuffled training
batches, a pinned host-to-device copy per batch, a loss check on every
batch), :func:`run_device_epoch` (the device-resident store: the same
batches gathered on the device, each loss checked one step late),
:func:`estimate_split_mu2` + :func:`evaluate_split` (the host dev pass
against a MAP-estimated mu2 table), :func:`stage_split` +
:func:`device_dev_pass` (the same pass over a staged dev split),
:func:`save_epoch` (the checkpoint policy), :func:`check_best` /
:func:`check_terminate` (early stopping), and :func:`run_training`, which
resolves the data tier and strings them together.

Hierarchical rounds, the streamed tier, K-step dispatch, mid-epoch
checkpoints and profiling are not ported yet (``ROADMAP.md``;
``train/driver.py`` refuses them).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
from pytorch_scalablefhvae_tpu_torch.data.device_store import (
    STORE_TAIL_SLACK,
    DeviceDataSource,
    EpochPlan,
    resolve_data_placement,
    resolve_tier,
)
from pytorch_scalablefhvae_tpu_torch.models.base import build_model
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train.device_step import (
    device_eval_pass,
    device_map_pass,
    device_map_pass_chunked,
    device_train_step,
)
from pytorch_scalablefhvae_tpu_torch.train.metrics import (
    MetricHistory,
    MetricWriter,
)
from pytorch_scalablefhvae_tpu_torch.train.step import (
    Optimizer,
    TrainState,
    create_train_state,
    encode_step,
    eval_step,
    make_optimizer,
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


def batch_tensors(b, device: torch.device):
    """``(feats, seq_idx, nsegs, weight)`` of a loader batch on ``device``:
    for a GPU, one pinned host copy and an asynchronous transfer each."""
    arrays = (b.feats, b.seq_idx, b.nsegs, b.weight)
    if device.type == "cpu":
        return tuple(torch.from_numpy(a) for a in arrays)
    return tuple(torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
                 for a in arrays)


def run_epoch(state: TrainState, optimizer: Optimizer, loader: SegmentLoader,
              alpha: float, device: torch.device, epoch: int) -> EpochStats:
    """One epoch of train steps over ``loader``'s order for ``epoch``.

    Every step's loss comes back to the host (one scalar, the only sync per
    step); a non-finite loss ends the epoch at once with ``diverged``."""
    loader.set_epoch(epoch)
    loss_sum, count, steps = 0.0, 0, 0
    t0 = time.perf_counter()
    for b in loader:
        metrics = train_step(state, optimizer, *batch_tensors(b, device),
                             alpha)
        loss = float(metrics["loss"])
        steps += 1
        if not math.isfinite(loss):
            return EpochStats(loss, count, steps,
                              time.perf_counter() - t0, diverged=True)
        loss_sum += loss * b.num_real
        count += b.num_real
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return EpochStats(loss_sum / max(count, 1), count, steps,
                      time.perf_counter() - t0)


def run_device_epoch(state: TrainState, optimizer: Optimizer,
                     source: DeviceDataSource, loader: SegmentLoader,
                     alpha: float, device: torch.device,
                     epoch: int) -> EpochStats:
    """One epoch of train steps gathered from the staged store, over the
    host loader's own permutation for ``epoch``, so both tiers train on the
    same batches.

    Each step's loss comes back to the host after the next step has been
    issued (lag one), so the host never waits on the step it just issued;
    the last one is checked at the epoch's end. A non-finite loss ends the
    epoch with ``diverged``."""
    loader.set_epoch(epoch)
    ds, B = loader.dataset, loader.batch_size
    plan, arrays = source.stage_epoch(ds, loader._order(), B)
    counts = plan.batch_real_counts()
    losses: list[float] = []
    t0 = time.perf_counter()
    pending = None  # the step before's loss, still on the device
    for b in range(plan.n_batches):
        metrics = device_train_step(
            state, optimizer, source.data, arrays, b * B, plan.n_real, alpha,
            batch_size=B, seg_len=ds.seg_len)
        if pending is not None:
            losses.append(float(pending))
            if not math.isfinite(losses[-1]):
                break
        pending = metrics["loss"]
    else:
        if pending is not None:
            losses.append(float(pending))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    loss_sum, count = 0.0, 0
    for loss, rows in zip(losses, counts):
        if not math.isfinite(loss):
            return EpochStats(loss, count, len(losses), seconds,
                              diverged=True)
        loss_sum += loss * rows
        count += rows
    return EpochStats(loss_sum / max(count, 1), count, len(losses), seconds)


def _map_table(sums: np.ndarray, counts: np.ndarray, pz2_var: float,
               pmu2_var: float = 1.0) -> np.ndarray:
    """Closed-form MAP posterior mean from fp64 accumulators:
    ``mu2[y] = sum / (count + pz2_var / pmu2_var)`` (utils.py:58-59)."""
    r = pz2_var / pmu2_var
    return (sums / (counts + r)[:, None]).astype(np.float32)


def estimate_split_mu2(model, loader: SegmentLoader, num_seqs: int,
                       pz2_var: float, device: torch.device,
                       pmu2_var: float = 1.0) -> np.ndarray:
    """MAP-estimate a split's mu2 table from the z2 encoder's means:
    ``mu2[y] = sum(z2_mu of y's segments) / (nsegs(y) + pz2_var/pmu2_var)``,
    accumulated on the host in fp64."""
    sums = np.zeros((num_seqs, model.z2_dim), dtype=np.float64)
    counts = np.zeros(num_seqs, dtype=np.float64)
    for b in loader:
        z2 = encode_step(model, batch_tensors(b, device)[0]).cpu().numpy()
        real = b.weight > 0
        np.add.at(sums, b.seq_idx[real], z2[real])
        np.add.at(counts, b.seq_idx[real], 1.0)
    return _map_table(sums, counts, pz2_var, pmu2_var)


def evaluate_split(model, loader: SegmentLoader, alpha: float,
                   device: torch.device,
                   table: torch.Tensor | None = None) -> dict[str, float]:
    """Exact weighted means of every metric over a split (sums and counts
    accumulated in fp64), scored against ``table`` when given."""

    def per_batch():
        for b in loader:
            sums = eval_step(model, *batch_tensors(b, device), alpha, table)
            yield sums.keys(), torch.stack(list(sums.values())).double() \
                .cpu().tolist()

    return split_means(per_batch())


def split_means(per_batch) -> dict[str, float]:
    """Weighted means from ``(keys, values)`` of each batch's metric sums
    (``count`` among the keys), added in batch order in fp64."""
    totals: dict[str, float] = {}
    count = 0.0
    for keys, vals in per_batch:
        for k, v in zip(keys, vals):
            if k == "count":
                count += v
            else:
                totals[k] = totals.get(k, 0.0) + v
    if count == 0:
        return {k: float("nan") for k in ("loss", "lower_bound", "log_qy")}
    return {k: v / count for k, v in totals.items()}


def dev_pass(model, loader: SegmentLoader, alpha: float,
             device: torch.device) -> dict[str, float]:
    """The per-epoch dev lower bound: held-out sequences have no rows in the
    learned table, so they are scored against their MAP estimates."""
    pz2_var = float(math.exp(model.pz2_logvar))
    table = estimate_split_mu2(model, loader, loader.dataset.num_seqs,
                               pz2_var, device)
    return evaluate_split(model, loader, alpha, device,
                          table=torch.from_numpy(table).to(device))


MAP_SPB = 16  # windows per chunk of the chunked dev MAP pass


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


def stage_split(loader: SegmentLoader, device: torch.device) -> DeviceSplit:
    """Stage ``loader``'s split (ordered) on ``device``. Its MAP pass is the
    chunked one when windows are deterministic, the batch is a multiple of
    ``MAP_SPB`` and a chunk's region fits the store's slack, as the JAX loop
    decides it."""
    ds, B = loader.dataset, loader.batch_size
    source = DeviceDataSource(ds.store, device)
    plan, arrays = source.stage_epoch(ds, np.arange(len(ds)), B)
    chunked = None
    if (not ds.rand_seg and B % MAP_SPB == 0
            and (MAP_SPB - 1) * ds.seg_shift + ds.seg_len <= STORE_TAIL_SLACK):
        padded = int((-(-ds.nsegs // MAP_SPB) * MAP_SPB).sum())
        chunked = (source.upload(ds.store.seq_starts, torch.long),
                   source.upload(ds.nsegs, torch.long),
                   max(-(-padded // B), 1))
    return DeviceSplit(loader, source, plan, arrays, chunked)


def device_dev_pass(model, split: DeviceSplit,
                    alpha: float) -> dict[str, float]:
    """:func:`dev_pass` over a staged split: the MAP table (fp32 sums on the
    device) and the scoring pass stay on the device; the per-batch sums come
    back in one fetch and are added as :func:`evaluate_split` adds them."""
    ds, B = split.loader.dataset, split.loader.batch_size
    store, plan = split.source.data, split.plan
    pz2_var = float(math.exp(model.pz2_logvar))
    if split.chunked is not None:
        starts, nsegs, n_batches = split.chunked
        table = device_map_pass_chunked(
            model, store, starts, nsegs, seg_len=ds.seg_len,
            seg_shift=ds.seg_shift, batch_size=B, n_batches=n_batches,
            num_rows=ds.num_seqs, pz2_var=pz2_var, spb=MAP_SPB)
    else:
        table = device_map_pass(
            model, store, split.arrays[0], split.arrays[1], plan.n_real,
            seg_len=ds.seg_len, batch_size=B, n_batches=plan.n_batches,
            num_rows=ds.num_seqs, pz2_var=pz2_var)
    stacked = device_eval_pass(model, store, split.arrays, plan.n_real, alpha,
                               table, batch_size=B, seg_len=ds.seg_len,
                               n_batches=plan.n_batches)
    keys = list(stacked)
    mat = torch.stack([stacked[k] for k in keys]).double().cpu()
    return split_means((keys, row) for row in mat.T.tolist())


def stage_device_tier(config: ExperimentConfig, train_loader: SegmentLoader,
                      dev_loader: SegmentLoader, device: torch.device,
                      verbose: bool):
    """The staged training store, and the staged dev split where it fits
    what the budget leaves (``"auto"`` against the rest, so that a train
    store that barely fits never runs out of memory for the dev split),
    or ``None``."""
    store = train_loader.dataset.store
    source = DeviceDataSource(store, device, config.data.transfer_dtype)
    staged = store.data.nbytes
    if verbose:
        print(f"Training data device-resident ({staged / 1e6:.0f} MB staged)")
    dev_store = dev_loader.dataset.store
    if not resolve_data_placement(
            "auto", dev_store,
            max_bytes=max(config.data.device_store_max_bytes - staged, 0)):
        return source, None
    split = stage_split(dev_loader, device)
    if verbose:
        print(f"Dev split device-resident ({dev_store.data.nbytes / 1e6:.0f} "
              f"MB staged)")
    return source, split


def save_epoch(exp_dir: Path, state: TrainState, config: ExperimentConfig,
               epoch: int, best_epoch: int, best_val_lb: float,
               history: MetricHistory, summary_vals: dict,
               extra_meta: dict) -> Path:
    """The epoch checkpoint (full training state) and, when this epoch is
    the best, its ``best_model_`` copy."""
    model = state.model
    return ckpt.save_checkpoint(
        exp_dir, model, model_type=model.model_type,
        model_params=model.model_params(), run_info=config.base_string(),
        epoch=epoch, best_epoch=best_epoch, best_val_lb=float(best_val_lb),
        values=history.to_json_dict(), extra_meta=extra_meta,
        train_state=state, summary_vals=summary_vals)


def run_training(config: ExperimentConfig, train_loader: SegmentLoader,
                 dev_loader: SegmentLoader, exp_dir: str | Path,
                 continue_from: str | Path | None = None,
                 finetune: bool = False, device: str = "cuda",
                 verbose: bool = True) -> TrainResult:
    """Train from scratch or resume: epochs of training, a dev pass and a
    checkpoint each, early stopping by patience. A non-finite training loss
    stops the run with ``diverged`` set, before that epoch is saved. The
    data tier is resolved first (:func:`resolve_tier`): the device-resident
    store, or the host loader."""
    exp_dir = Path(exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    config.save(exp_dir / "config.json")
    dev = resolve_device(device)

    ds = train_loader.dataset
    source, dev_split = None, None
    if resolve_tier(config.data.data_placement, ds.store,
                    config.data.device_store_max_bytes) == "device":
        source, dev_split = stage_device_tier(config, train_loader,
                                              dev_loader, dev, verbose)
    seg_len, dim, num_seqs = ds.seg_len, ds.store.dim, ds.num_seqs
    seed = config.train.seed
    model = build_model(config.model.model_type, seg_len * dim, config.model,
                        num_seqs, feat_dim=dim,
                        generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model.to(dev), seed=seed)
    optimizer = make_optimizer(config.optim.learning_rate,
                               config.optim.beta_one, config.optim.beta_two)
    alpha = config.optim.alpha_dis

    start_epoch, best_epoch, best_val_lb = 0, 0, -np.inf
    history = MetricHistory()
    corpus_fp = ckpt.corpus_fingerprint(ds.store.seq_keys)
    if continue_from is not None:
        meta = ckpt.load_train_state(continue_from, state, finetune=finetune,
                                     expected_num_seqs=num_seqs,
                                     expected_fingerprint=corpus_fp)
        start_epoch = meta["start_epoch"]
        best_epoch = meta.get("best_epoch", 0)
        best_val_lb = meta.get("best_val_lb", -np.inf)
        history = MetricHistory(meta.get("values", {}))
        if verbose:
            print(f"Resumed from {continue_from} at epoch {start_epoch} "
                  f"(step {state.step})")

    writer = MetricWriter(exp_dir, config.run_id())
    extra = {"num_seqs": num_seqs, "feat_dim": dim, "seg_len": seg_len,
             "corpus_fingerprint": corpus_fp}
    result = TrainResult(state, best_epoch, best_val_lb, start_epoch - 1,
                         history)
    for epoch in range(start_epoch, config.train.epochs):
        if source is not None:
            stats = run_device_epoch(state, optimizer, source, train_loader,
                                     alpha, dev, epoch)
        else:
            stats = run_epoch(state, optimizer, train_loader, alpha, dev,
                              epoch)
        if stats.diverged:
            print("Training diverged")
            result.diverged, result.last_epoch = True, epoch
            return result
        if verbose:
            print(f"====> Epoch {epoch}: train loss {stats.train_loss:.4f}, "
                  f"{stats.steps} steps in {stats.seconds:.2f} s "
                  f"({stats.segments_per_sec:.1f} segments/s)")
        val = (device_dev_pass(model, dev_split, alpha) if dev_split
               is not None else dev_pass(model, dev_loader, alpha, dev))
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
        writer.write_epoch(epoch, scalars)
        if check_best(val["lower_bound"], best_val_lb):
            best_epoch, best_val_lb = epoch, val["lower_bound"]
        save_epoch(exp_dir, state, config, epoch, best_epoch, best_val_lb,
                   history, {k: float(v) for k, v in scalars.items()}, extra)
        result = TrainResult(state, best_epoch, best_val_lb, epoch, history)
        if check_terminate(epoch, best_epoch, config.train.patience,
                           config.train.epochs):
            if verbose:
                print("Training terminated!")
            break
    if verbose:
        print("Training complete!")
    return result
