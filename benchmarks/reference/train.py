"""The reference's training steps: the first steps of a run followed from
the benchmark's initial weights, on the batches the training path's
documented order gives, with each step's documented noise."""

from __future__ import annotations

import numpy as np
import torch

from reference import common


def first_batches(split: common.Split, loader_seed: int, batch: int,
                  steps: int) -> list:
    """The window indices of epoch 0's first ``steps`` batches."""
    order = common.epoch_order(len(split.seq), loader_seed, 0)
    return [order[s * batch:(s + 1) * batch] for s in range(steps)]


def stream_batches(schedule: list, batch: int) -> list:
    """The window indices of every batch of a streamed epoch's schedule
    (:func:`common.stream_schedule`), chunk after chunk; a chunk's last
    batch may be short."""
    return [order[at:at + batch] for _, order in schedule
            for at in range(0, len(order), batch)]


def round_table(model, params: dict, split: common.Split, skip: int,
                spb: int, device, prec: dict | None = None) -> torch.Tensor:
    """A hierarchical round's MAP-initialised table: every ``skip``-th chunk
    of ``spb`` windows of each of the round's sequences, encoded with the
    current weights."""
    keep = common.chunk_skip_windows(split.nsegs, spb, skip)
    with torch.no_grad():
        return common.map_table(
            lambda x: model.encode_z2(params, x, prec), split, keep,
            len(split.lens), model.cfg["pz2_std"] ** 2, device)


def follow(model, params: dict, split: common.Split, batches: list,
           seed: int, optim: dict, device, prec: dict | None = None,
           after_step=None, half_batch: bool = False) -> dict:
    """Train ``params`` (a dict of float32 tensors, updated in place) over
    ``batches`` from step 0: forward with the step's noise, the loss,
    backward, the clip and Adam; ``after_step(n)`` is called once ``n``
    steps are done. Returns each step's loss and the first step's clipped
    gradient. ``half_batch`` plants a fault for reading the limits: the
    loss is the mean over the batch's first half alone."""
    for p in params.values():
        p.requires_grad_(True)
    adam = common.Adam(params, optim["learning_rate"], optim["beta_one"],
                       optim["beta_two"], optim["grad_clip_norm"])
    losses, first = [], None
    for step, idx in enumerate(batches):
        loss = step_loss(model, params, split.windows(idx, device), seed,
                         step, optim["alpha_dis"], device, prec, half_batch)
        names = list(params)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        clipped = adam.update(params, dict(zip(names, grads)))
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: g.detach().clone() for n, g in clipped.items()}
        if after_step is not None:
            after_step(step + 1)
    for p in params.values():
        p.requires_grad_(False)
    return {"losses": np.array(losses), "first_grads": first}


def step_loss(model, params: dict, windows: tuple, seed: int, step: int,
              alpha: float, device, prec: dict | None = None,
              half_batch: bool = False) -> torch.Tensor:
    """The training loss of step ``step`` (0 first) over ``windows``, ``(x,
    seq, nsegs)`` of one batch, at ``params``, with the step's noise;
    ``half_batch``: over the batch's first half alone (a planted fault)."""
    x, seq, nsegs = windows
    cfg = model.cfg
    weight = torch.ones(len(seq), device=device)
    if half_batch:
        weight[len(seq) // 2:] = 0.0
    noise = common.step_noise(seed, step, len(seq), cfg["z1_dim"],
                              cfg["z2_dim"], device)
    out = model.forward(params, x, seq, nsegs, None, noise, prec)
    return common.training_loss(out, weight, alpha)
