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
    cfg = model.cfg
    for p in params.values():
        p.requires_grad_(True)
    adam = common.Adam(params, optim["learning_rate"], optim["beta_one"],
                       optim["beta_two"], optim["grad_clip_norm"])
    losses, first = [], None
    for step, idx in enumerate(batches):
        x, seq, nsegs = split.windows(idx, device)
        weight = torch.ones(len(idx), device=device)
        if half_batch:
            weight[len(idx) // 2:] = 0.0
        noise = common.step_noise(seed, step, len(idx), cfg["z1_dim"],
                                  cfg["z2_dim"], device)
        out = model.forward(params, x, seq, nsegs, None, noise, prec)
        loss = common.training_loss(out, weight, optim["alpha_dis"])
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
