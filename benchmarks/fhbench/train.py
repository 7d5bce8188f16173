"""A training cell's run: set-up, the measured window and the check.

The window drives the program's training entry,
``pytorch_scalablefhvae_tpu_torch.train.loop.run_training``, with the config
that ``sfhvae train`` builds from the cell's flags and the loaders that
``train/driver.py`` builds (``FeatureStore.from_arrays`` over the seeded
corpus, ``SegmentDataset``, ``SegmentLoader``). One training run goes
through four calls of it, each resuming the last one's checkpoint, so the
state the window trains is the state that set-up checked:

1. from the benchmark's initial weights (``--finetune``: weights only),
   one step (``--max-steps 1``, an eager step): its gradient is read from
   Adam's moment in the step checkpoint;
2. two K-step dispatches more (the bundle's first, run eagerly, and its
   second, captured and replayed as a CUDA graph): the steps' losses and
   the weights after them are read;
3. the warm-up: the rest of epoch 0, then the mix's ``warm_epochs``
   whole epochs (1 where it names none), each with its dev pass and
   checkpoint; the last epoch's time, the graph's capture left out, sets
   the window's epoch count E, the whole epochs that fill ``--seconds``
   (a call's first epoch also runs its first dispatch eagerly and its
   first dev pass and save, which a short epoch does not amortise: the
   TIMIT mixes time a whole epoch after it, the LibriSpeech rounds, of
   about 5 s each, time the rest of epoch 0);
4. the window: E whole epochs, each with its dev pass and checkpoint (in a
   hierarchical run each epoch is a round: turnover, steps, dev pass).

Set-up is everything before the window: imports, the corpus, the weights,
calls 1-3 (the kernels' build on a checkout's first run, the graph
captures, the staging). The reference runs after the window, once the
peak memory is read and the program's state is freed.

A mix of ``"kind": "stream"`` runs ``fhbench/stream.py``'s subclass: the
same four calls on the streamed tier, the reference's batches in the
stream's chunk order, each window epoch's chunk switches read from the
program's source, and two calls more after the window, from call 2's
checkpoint to the first chunk switch past it and on through it, for
``switch_loss_gap``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from fhbench import check, corpus, weights
from fhbench.hooks import Recorder
from reference import common, model_for
from reference import train as ref_train

ADAM_MU = "adam_mu."
MAP_SPB = 16  # windows per chunk of a round's MAP init


class Readings:
    """What the metric readers read: the window's host clock, the program's
    per-epoch records, its turnover lines, the cell's FLOP count and peak,
    and the traced cycle's reduction (``cycle``, traced runs only)."""

    def __init__(self, **kw):
        self.cycle = None
        self.__dict__.update(kw)

    @property
    def segments_per_s(self) -> float:
        return self.segments / self.window_s

    def roofline(self, group: str):
        return None if self.cycle is None else \
            self.cycle["rooflines"].get(group)


def program_config(cell, seed: int, device: str):
    """The program's ``ExperimentConfig`` of ``sfhvae train`` with the
    cell's flags."""
    from pytorch_scalablefhvae_tpu_torch.cli.args import config_from_args
    from pytorch_scalablefhvae_tpu_torch.cli.main import build_parser

    argv = ["train", *cell.config["flags"], *cell.traffic["flags"],
            "--seed", str(seed), "--device", device]
    config = config_from_args(build_parser().parse_args(argv))
    widths = cell.config["widths"]
    model = config.model
    got = {"z1_hus": list(model.z1_hus), "z2_hus": list(model.z2_hus),
           "x_hus": list(model.x_hus), "z1_dim": model.z1_dim,
           "z2_dim": model.z2_dim, "seg_len": config.data.seg_len,
           "seg_shift": config.data.seg_shift,
           "feat_dim": cell.traffic["corpus"]["feat_dim"],
           "pz2_std": model.pz2_std}
    wrong = {k: (got[k], v) for k, v in widths.items() if got[k] != v}
    if wrong:
        raise ValueError(f"the flags give other widths than the "
                         f"configuration states: {wrong}")
    return config


def loaders(config, splits: dict):
    """The training and dev loaders as ``train/driver.py`` builds them, over
    stores made in memory."""
    from pytorch_scalablefhvae_tpu_torch.data.feature_store import (
        FeatureStore,
    )
    from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
    from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset

    d, seed = config.data, config.train.seed
    out = []
    for name, bs, shuffle in (("train", d.training_batch_size, True),
                              ("dev", d.dev_batch_size, False)):
        store = FeatureStore.from_arrays(splits[name].arrays())
        ds = SegmentDataset(store, seg_len=d.seg_len, seg_shift=d.seg_shift,
                            rand_seg=d.rand_seg, seed=seed)
        out.append(SegmentLoader(ds, bs, shuffle=shuffle, seed=seed,
                                 transfer_dtype=d.transfer_dtype))
    return out


def checkpoint(exp: Path, pattern: str) -> dict:
    """The arrays of the one checkpoint in ``exp`` matching ``pattern``."""
    found = [p for p in exp.glob(pattern)
             if not p.name.startswith("best_model_")]
    if len(found) != 1:
        raise RuntimeError(f"expected one {pattern} in {exp}, found "
                           f"{[p.name for p in found]}")
    with np.load(found[0]) as z:
        return {"path": found[0], **{k: z[k] for k in z.files}}


def epoch_records(exp: Path, since: int) -> list:
    rows = [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines() if line.strip()]
    return [r for r in rows if r["epoch"] >= since]


def turnover_lines(log: Path, since: int) -> list:
    """Seconds of each ``Round at epoch E (...): draw X s, ...`` line the
    loop printed for an epoch at or past ``since``."""
    out = []
    for line in log.read_text().splitlines():
        if not line.startswith("Round at epoch "):
            continue
        epoch = int(line.split()[3])
        stages = line.split("): ", 1)[1].split(", ")
        if epoch >= since:
            out.append({s.split()[0]: float(s.split()[1]) for s in stages})
    return out


class Run:
    """One run of a training cell on ``device`` in ``workdir``."""

    def __init__(self, cell, seed: int, seconds: float, traced: bool,
                 device: str, workdir: Path):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.traced, self.device = traced, torch.device(device)
        self.workdir = workdir
        self.log = workdir / "program.log"
        self.config = program_config(cell, seed, device)
        self.hier = self.config.train.sample_hierarchical
        self.k = self.config.train.steps_per_dispatch
        c = cell.config
        self.model = model_for(c["reference"],
                               {**c["widths"], "pz2_std": c["pz2_std"]})

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        self.setup_data()
        self.setup_program()

    def setup_data(self) -> None:
        """The corpus, the program's loaders and the initial weights."""
        common.set_exact_float32()
        self.splits = corpus.make_corpus(self.cell.traffic["corpus"],
                                         self.seed, self.device)
        self.train_loader, self.dev_loader = loaders(self.config,
                                                     self.splits)
        n_train = len(self.splits["train"].keys)
        self.rows = (min(self.config.train.num_hierarchical_sequences,
                         n_train) if self.hier else n_train)
        self.params0 = weights.make(self.model, self.rows,
                                    self.cell.config["mu2_init_std"],
                                    self.seed, self.device)

    def setup_program(self) -> None:
        """Calls 1-3 of the program's entry: the first steps and the
        warm-up epoch."""
        init = weights.write(self.workdir / "init" / "init.npz",
                             self.params0, self.cell.config["model_type"])
        self.recorder = Recorder(self.hier, self.traced)
        steps = 1 + 2 * self.k
        self.call("first", 1, 1, init, finetune=True)
        self.first = checkpoint(self.workdir / "first", "*_e0s1.npz")
        rows = self.first["mu2_table"].shape[0]
        if rows != self.rows:
            raise RuntimeError(
                f"the program trains a table of {rows} rows, the benchmark "
                f"expects {self.rows}: a round smaller than "
                f"--num-hierarchical-sequences is another cell")
        losses = self.recorder.losses()
        self.call("first", 1, steps, self.first["path"])
        self.after = checkpoint(self.workdir / "first", f"*_e0s{steps}.npz")
        self.losses = losses + self.recorder.losses()
        # the last warm epoch's cycle (from its start to the call's
        # return: turnover, steps, dev pass and save) less the graph's
        # capture is the epoch time that sets E; where that is the rest of
        # epoch 0, its first dispatch, run eagerly, takes about as long as
        # the 1 + 2 K steps it lacks
        extra = self.cell.traffic.get("warm_epochs", 1)
        self.first_epoch = 1 + extra  # the window's first epoch
        self.recorder.marks = []
        self.call("warm", self.first_epoch, 0, self.after["path"])
        t0 = self.recorder.marks[-1][1]
        capture = sum(b - a for m, a, b in self.recorder.spans
                      if m == "capture" and a >= t0)
        self.t_epoch = time.perf_counter() - t0 - capture
        self.epochs = max(2, round(self.seconds / self.t_epoch))
        self.warm = checkpoint(self.workdir / "warm", f"*_e{extra}.npz")

    def call(self, name: str, epochs: int, max_steps: int, start: Path,
             finetune: bool = False):
        """One call of the program's training entry in ``workdir/name``,
        from the checkpoint ``start``, its output appended to the log."""
        from pytorch_scalablefhvae_tpu_torch.train import loop

        cfg = self.config.apply_overrides({
            "train.epochs": epochs, "train.max_steps": max_steps,
            "train.patience": epochs + 10})
        self.recorder.cursors = []
        with open(self.log, "a") as out, contextlib.redirect_stdout(out):
            print(f"---- call {name}: epochs {epochs}, max_steps {max_steps}"
                  f", from {start.name}")
            result = loop.run_training(
                cfg, self.train_loader, self.dev_loader,
                self.workdir / name, continue_from=start, finetune=finetune,
                device=self.device.type, verbose=True)
        self.sync()
        return result

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ window

    def window(self, probe=None) -> Readings:
        """The measured window: one call over ``self.epochs`` epochs. In a
        traced run the host-clock readings leave out the profiled epochs'
        cycles (from their start to the next epoch's) and the probe's work
        at the epochs' starts: they are of the rest of the window."""
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        if probe is not None:
            probe.arm()
        self.recorder.marks = []
        t0 = time.perf_counter()
        result = self.call("window", self.first_epoch + self.epochs, 0,
                           self.warm["path"])
        t1 = time.perf_counter()
        if probe is not None:
            probe.finish()
        self.peak = (int(torch.cuda.max_memory_allocated(self.device))
                     if self.device.type == "cuda" else 0)
        self.final = {n: p.detach().cpu().numpy().copy()
                      for n, p in result.state.params().items()}
        self.diverged = result.diverged
        self.window_round = None
        if self.recorder.round is not None:
            r = self.recorder.round
            self.window_round = {
                "epoch": r["epoch"], "keys": r["keys"],
                "params": {n: v.cpu().numpy()
                           for n, v in r["params"].items()},
                "table_after": r["table_after"].cpu().numpy()}
        self.recorder.round = None
        del result
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.window_spans = {
            n: [round(b - a, 4) for m, a, b in self.recorder.spans
                if m == n and a >= t0]
            for n in ("turnover", "dev_pass", "save_state", "capture")}
        marks = self.recorder.marks
        self.cycles = [(marks[i + 1][0] if i + 1 < len(marks) else t1)
                       - marks[i][1] for i in range(len(marks))]
        skipped = set() if probe is None else set(probe.profiled)
        window_s = t1 - t0 - sum(b - a for a, b in marks)
        for i in skipped:
            end = marks[i + 1][0] if i + 1 < len(marks) else t1
            window_s -= end - marks[i][1]
        self.records = epoch_records(self.workdir / "window",
                                     self.first_epoch)
        records = [r for i, r in enumerate(self.records) if i not in skipped]
        segments = sum(round(r["train_segments_per_sec"] * r["train_seconds"])
                       for r in records)
        flops = importlib.import_module(
            f"roofline.{self.cell.config['flops']}")
        turnovers = (turnover_lines(self.log, self.first_epoch)
                     if self.hier else [])
        return Readings(
            window_s=window_s, segments=segments,
            attempted=int(sum(r["train_steps"] for r in self.records)),
            steps=int(sum(r["train_steps"] for r in records)),
            train_seconds=sum(r["train_seconds"] for r in records),
            epochs=len(records),
            turnovers=[t for i, t in enumerate(turnovers)
                       if i not in skipped],
            flops_per_segment=flops.flops_per_segment(
                self.cell.config["widths"], self.rows),
            peak_flops=flops.PEAKS[self.cell.config["peak"]],
            cycle=None if probe is None else probe.result)

    # ------------------------------------------------------------ check

    def reference_split(self, name: str) -> common.Split:
        s, w = self.splits[name], self.cell.config["widths"]
        return common.Split(s.frames, s.offsets, s.lens, w["seg_len"],
                            w["seg_shift"])

    def train_split(self):
        """The split the first steps train on: the training split, or the
        first round's sequences in draw order."""
        return self.round_split(0)[0] if self.hier else \
            self.reference_split("train")

    def round_split(self, epoch: int) -> tuple:
        """The reference's draw of the round at ``epoch`` and its
        sequences in draw order."""
        keys = self.splits["train"].keys
        drawn = common.round_draw(keys, self.rows, self.seed, epoch)
        index = {k: i for i, k in enumerate(keys)}
        split = self.reference_split("train")
        return split.subset(np.array([index[k] for k in drawn])), drawn

    def window_table(self, prec: dict | None = None) -> tuple:
        """The reference's draw of the window's last round and its
        MAP-initialised table from the weights the program held at that
        turnover (``prec``: a control's operand precisions)."""
        w = self.window_round
        split, drawn = self.round_split(w["epoch"])
        params = {n: torch.from_numpy(v).to(self.device)
                  for n, v in w["params"].items()}
        table = ref_train.round_table(
            self.model, params, split, self.config.train.map_init_chunk_skip,
            MAP_SPB, self.device, prec)
        return drawn, table.cpu().numpy()

    def window_numbers(self, prec: dict | None = None,
                       stale: bool = False) -> dict:
        """``window_draw_gap`` and ``window_table_gap`` of the window's
        last round: the program's (``prec``: the reference at a control's
        precisions in its place; ``stale``: a fault, the table left as the
        last round trained it) against the float32 reference's."""
        w = self.window_round
        if w is None or w["epoch"] != self.first_epoch + self.epochs - 1:
            return {"window_draw_gap": 1.0,
                    "window_table_gap": float("inf")}
        if getattr(self, "_window_ref", None) is None:
            self._window_ref = self.window_table()
        drawn, ref = self._window_ref
        keys, table = w["keys"], w["table_after"][:self.rows]
        if prec is not None:
            keys, table = self.window_table(prec)
        elif stale:
            table = w["params"]["mu2_table"][:self.rows]
        return {"window_draw_gap": check.draw_gap(keys, drawn),
                "window_table_gap": check.row_gap(table, ref)}

    def reference(self, prec: dict | None = None) -> dict:
        """The reference's readings from the initial weights (``prec``: the
        operand precisions of a control in the reference's place); the
        float32 reference's are computed once a run."""
        if prec is None and getattr(self, "_reference", None) is not None:
            return dict(self._reference)
        out = self._follow(prec)
        if prec is None:
            self._reference = out
        return dict(out)

    def _follow(self, prec: dict | None, half_batch: bool = False) -> dict:
        dev, t = self.device, self.config.train
        split = self.train_split()
        params = {n: p.clone() for n, p in self.params0.items()}
        out = {"params_before": {n: p.cpu().numpy().copy()
                                 for n, p in params.items()}}
        if self.hier:
            params["mu2_table"] = ref_train.round_table(
                self.model, params, split, t.map_init_chunk_skip, MAP_SPB,
                dev, prec)
        batches = self.first_batches(split)

        def after_step(n):
            if n == 1 and self.hier:
                out["table_first"] = \
                    params["mu2_table"].detach().cpu().numpy().copy()

        run = ref_train.follow(self.model, params, split, batches, self.seed,
                               self.optim(), dev, prec, after_step,
                               half_batch)
        out.update(losses=run["losses"],
                   first_grads={n: g.cpu().numpy().copy()
                                for n, g in run["first_grads"].items()},
                   params_after={n: p.cpu().numpy().copy()
                                 for n, p in params.items()})
        return out

    def first_batches(self, split: common.Split) -> list:
        """The window indices of the first ``1 + 2 K`` batches of
        ``split``, in the loader's order of epoch 0."""
        return ref_train.first_batches(
            split, self.seed, self.config.data.training_batch_size,
            1 + 2 * self.k)

    def optim(self) -> dict:
        o = self.config.optim
        return {"learning_rate": o.learning_rate, "beta_one": o.beta_one,
                "beta_two": o.beta_two, "alpha_dis": o.alpha_dis,
                "grad_clip_norm": self.cell.config["grad_clip_norm"]}

    def program_readings(self) -> dict:
        names = list(self.params0)
        out = {"losses": np.array(self.losses),
               "mu_first": {n: self.first[ADAM_MU + n] for n in names},
               "params_before": {n: p.cpu().numpy().copy()
                                 for n, p in self.params0.items()},
               "params_after": {n: self.after[n] for n in names},
               "dev_lb": self.records[-1]["val_lower_bound"]}
        if self.hier:
            out["table_first"] = self.first["mu2_table"]
        return out

    def dev_lb(self, params: dict, prec: dict | None = None,
               dev_half: bool = False) -> float:
        tensors = {n: torch.from_numpy(v).to(self.device)
                   for n, v in params.items()}
        split = self.reference_split("dev")
        if dev_half:
            split = split.subset(np.arange(len(split.lens) // 2))
        return common.dev_lower_bound(self.model, tensors, split,
                                      self.device, kind=prec)

    @property
    def dev_compared(self) -> bool:
        return "dev_lb_gap" in self.cell.limits

    def numbers(self) -> dict:
        """The cell's numbers: the program against the reference."""
        prog = self.program_readings()
        ref = self.reference()
        if self.dev_compared:
            ref["dev_lb"] = self.dev_lb(self.final)
        out = check.numbers(prog, ref, self.config.optim.beta_one, self.k)
        if self.hier:
            out.update(self.window_numbers())
        return out

    def control_numbers(self, prec: dict | None, half_batch: bool = False,
                        dev_half: bool = False) -> dict:
        """The same numbers with the reference at ``prec`` in the program's
        place: its first steps, its dev pass over the weights they reach
        and, in rounds, the window's last round's draw and MAP init. With
        ``half_batch`` or ``dev_half`` (and ``prec`` None) the
        reference in the program's place has that fault planted instead:
        half of each batch left out of the loss, or a dev pass over the
        first half of the dev sequences alone."""
        ctrl = (self._follow(None, half_batch=True) if half_batch
                else self.reference(prec))
        prog = {"losses": ctrl["losses"],
                "mu_first": {n: (1.0 - self.config.optim.beta_one) * g
                             for n, g in ctrl["first_grads"].items()},
                "params_before": ctrl["params_before"],
                "params_after": ctrl["params_after"]}
        if "table_first" in ctrl:
            prog["table_first"] = ctrl["table_first"]
        ref = self.reference()
        if self.dev_compared:
            prog["dev_lb"] = self.dev_lb(ctrl["params_after"], prec,
                                         dev_half)
            ref["dev_lb"] = self.dev_lb(ctrl["params_after"])
        out = check.numbers(prog, ref, self.config.optim.beta_one, self.k)
        if self.hier and prec is not None:
            out.update(self.window_numbers(prec))
        return out

    def close(self) -> None:
        recorder = getattr(self, "recorder", None)
        if recorder is not None:
            recorder.close()
