"""Steps over a whole batch on a mesh of ranks.

Counterpart of ``pytorch_scalablefhvae_tpu/parallel/sharded_step.py``. The
JAX package compiles the single-device step bodies with shardings; here every
rank calls the same bodies (``train/step.py``) on its rows of the batch, and
those bodies do the mesh's reductions themselves when handed the mesh. Each
function made here takes the WHOLE batch, as the JAX steps do, takes this
rank's rows of it (``parallel.mesh.shard_batch``) and returns what the
single-device step returns:

- batch rows go to the data ranks in contiguous blocks; the ranks of a model
  group see the same rows;
- the model is the rank's (``parallel.mesh.shard_model``): the learned mu2
  table and its Adam moments are row shards, all else is replicated;
- evaluation scores against a split's MAP table, which stays replicated (it
  has as many rows as the split has sequences), so only the batch is split.

The data axis must divide the batch size.
"""

from __future__ import annotations

import torch

from pytorch_scalablefhvae_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    shard_batch,
)
from pytorch_scalablefhvae_tpu_torch.train.step import (
    encode_step,
    eval_step,
    train_step,
)


def make_sharded_train_step(state, optimizer, alpha: float, mesh: Mesh):
    """``step(feats, seq_idx, nsegs, weight, noise=None) -> metrics``: one
    optimizer step in place on this rank's state; ``noise`` (whole-batch
    draws) is for tests. The metrics are the whole batch's."""

    def step(feats, seq_idx, nsegs, weight, noise=None):
        if noise is not None:
            noise = dict(zip(noise, shard_batch(mesh, *noise.values())))
        return train_step(state, optimizer,
                          *shard_batch(mesh, feats, seq_idx, nsegs, weight),
                          alpha, noise=noise, mesh=mesh)

    return step


def sum_eval_over_data(mesh: Mesh, sums: dict) -> dict:
    """A rank's eval sums (stacked per batch or not) added up over the data
    group, in one all-reduce."""
    keys = list(sums)
    total = mesh.all_reduce_(torch.stack([sums[k] for k in keys]), DATA_AXIS)
    return dict(zip(keys, total))


def make_sharded_eval_step(model, alpha: float, mesh: Mesh):
    """``step(feats, seq_idx, nsegs, weight, table) -> sums``: the weighted
    metric sums and row count of the whole batch against the replicated
    ``table``."""

    def step(feats, seq_idx, nsegs, weight, table):
        sums = eval_step(model,
                         *shard_batch(mesh, feats, seq_idx, nsegs, weight),
                         alpha, table)
        return sum_eval_over_data(mesh, sums)

    return step


def make_sharded_encode_step(model, mesh: Mesh):
    """``step(feats) -> z2_mu`` of this rank's rows of the batch
    (``mesh.local_rows``); the data ranks' blocks in rank order make up the
    batch's."""

    def step(feats):
        return encode_step(model, *shard_batch(mesh, feats))

    return step
