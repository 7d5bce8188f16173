"""The ``(data, model)`` mesh of ranks and the one sharding rule.

Counterpart of ``pytorch_scalablefhvae_tpu/parallel/mesh.py``. Where the JAX
package lays a ``jax.sharding.Mesh`` over the devices of one program and lets
GSPMD place the collectives, the port runs one process per rank under
``torch.distributed`` and states every collective itself:

- axis "data": every rank of a data row ``i`` takes the contiguous rows
  ``[i B/d, (i+1) B/d)`` of each batch; gradients are summed over the data
  group once per step (``train/step.py``);
- axis "model": the mu2 table and its two Adam moments are row-sharded, rank
  ``j`` of a model group holding rows ``[j N_pad/m, (j+1) N_pad/m)`` of the
  table padded to a multiple of ``m``; the discriminative log-sum-exp and the
  ELBO's row gather reduce over the model group. With
  ``--shard-device-store`` the staged store and the streamed chunks are
  row-sharded the same way (:meth:`Mesh.store_rows`), and every window
  gathered from them is summed over the model group
  (:meth:`Mesh.model_sum_`).

Everything else is replicated: all ranks hold the same bits, because every
rank computes the same numbers from the same all-reduced values
(:func:`replicas_equal` checks it). Rank ``i * m + j`` sits at ``(i, j)``, so
the model axis is the fast one and stays inside a node
(:func:`validate_multihost_mesh`).

The collectives are ``all_reduce`` only, the one reduction PyTorch's gloo
backend offers for CUDA tensors besides ``broadcast``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def padded_num_seqs(num_seqs: int, model_axis_size: int) -> int:
    """Round the mu2 row count up to a multiple of the model axis so the
    row-sharded table divides evenly on any corpus (TIMIT's 4620 train
    sequences on a model=8 axis, etc.). Padded rows carry zero weight: they
    are masked out of the discriminative log-sum-exp (models/base.py
    ``num_real``) and no segment ever gathers them."""
    if model_axis_size <= 1:
        return num_seqs
    return -(-num_seqs // model_axis_size) * model_axis_size


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: its shape ``(d, m)``, its rank, the
    process groups of its data column and its model row, and the device its
    tensors live on."""

    shape: tuple[int, int]
    rank: int
    data_group: dist.ProcessGroup
    model_group: dist.ProcessGroup
    device: torch.device

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape[1]

    @property
    def backend(self) -> str:
        """The process groups' backend: ``"nccl"`` or ``"gloo"``."""
        return str(dist.get_backend(self.data_group))

    def _group(self, axis: str):
        if axis not in (DATA_AXIS, MODEL_AXIS):
            raise ValueError(f"unknown mesh axis {axis!r}")
        return self.data_group if axis == DATA_AXIS else self.model_group

    def all_reduce_(self, t: torch.Tensor, axis: str,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``t`` in place over the ranks of ``axis``; returns it."""
        dist.all_reduce(t, op=op, group=self._group(axis))
        return t

    def model_max(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_reduce_(t.clone(), MODEL_AXIS, dist.ReduceOp.MAX)

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_reduce_(t.clone(), MODEL_AXIS)

    def model_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed in place over the model group (the row-sharded
        store's gather: each rank's rows, -0.0 elsewhere)."""
        return self.all_reduce_(t, MODEL_AXIS)

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.all_reduce_(t.clone(), DATA_AXIS)

    def data_sum_host(self, *arrays: np.ndarray) -> list[np.ndarray]:
        """Host arrays summed over the data group in float64; they travel
        through the mesh's device, where the backend reduces."""
        flat = torch.from_numpy(np.concatenate(
            [np.asarray(a, np.float64).reshape(-1) for a in arrays]))
        flat = self.all_reduce_(flat.to(self.device), DATA_AXIS).cpu().numpy()
        out, at = [], 0
        for a in arrays:
            out.append(flat[at:at + a.size].reshape(a.shape))
            at += a.size
        return out

    def local_rows(self, batch: int) -> slice:
        """The rows of a ``batch``-row batch that this rank's data row
        takes: contiguous blocks in rank order."""
        d = self.shape[0]
        if batch % d:
            raise ValueError(f"the data axis ({d}) must divide the batch "
                             f"size ({batch})")
        per = batch // d
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def table_rows(self, rows_padded: int) -> slice:
        """The rows of the padded mu2 table that this rank holds."""
        return model_shard(self, rows_padded, "mu2 table rows")

    def table_shard(self, table):
        """This rank's rows of a whole padded ``[rows_padded, z2]`` table (a
        tensor or an array; JAX's ``device_put(table, NamedSharding(mesh,
        P("model", None)))``): a hierarchical round's MAP table, a saved
        table on a resume."""
        return table[self.table_rows(table.shape[0])]

    def store_rows(self, rows_padded: int) -> slice:
        """The rows of a store or a streamed chunk row-sharded over the
        model axis (``--shard-device-store``) that this rank stages: the
        table's rule, ``[j R/m, (j+1) R/m)`` of ``R = rows_padded``."""
        return model_shard(self, rows_padded, "row-sharded store rows")


def model_shard(mesh, rows_padded: int, what: str) -> slice:
    """Rank ``(i, j)``'s rows ``[j R/m, (j+1) R/m)`` of ``R = rows_padded``
    rows row-sharded over the model axis of ``mesh``."""
    m = mesh.shape[1]
    if rows_padded % m:
        raise ValueError(
            f"{what} ({rows_padded}) must be a multiple of the model axis "
            f"({m}); pad with parallel.mesh.padded_num_seqs")
    per = rows_padded // m
    return slice(mesh.model_index * per, (mesh.model_index + 1) * per)


def make_mesh(mesh_shape: tuple[int, int], device: torch.device) -> Mesh:
    """This rank's :class:`Mesh` over the initialised default process group.
    Every rank must call it: the groups are made collectively, the data
    columns first, then the model rows."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialised torch.distributed process group: "
            "start the ranks with the CLI (train --mesh d,m) or under a "
            "launcher (--distributed)")
    d, m = (int(x) for x in mesh_shape)
    n = dist.get_world_size()
    if d * m != n:
        raise ValueError(f"mesh_shape {(d, m)} does not cover {n} ranks")
    rank = dist.get_rank()
    data_group = model_group = None
    for j in range(m):
        g = dist.new_group([i * m + j for i in range(d)])
        if j == rank % m:
            data_group = g
    for i in range(d):
        g = dist.new_group([i * m + j for j in range(m)])
        if i == rank // m:
            model_group = g
    # no rank goes on until every rank's groups are connected: one that
    # raises right after (a setting refused on a mesh) would otherwise
    # close its sockets under another rank's gloo handshake
    dist.barrier()
    return Mesh((d, m), rank, data_group, model_group, torch.device(device))


def validate_multihost_mesh(mesh_shape: tuple[int, int], node_count: int,
                            local_rank_count: int) -> None:
    """Raise unless a ``(data, model)`` mesh can be laid over ``node_count``
    nodes of ``local_rank_count`` ranks each with the model axis inside a
    node: ranks are numbered node by node and the model axis is the fast one,
    so it is node-local iff its size divides the ranks per node. The model
    axis carries the discriminative reductions of every step and must ride
    the node's own links; only the data axis, one gradient all-reduce per
    step, may span nodes."""
    d, m = mesh_shape
    total = node_count * local_rank_count
    if d * m != total:
        raise ValueError(
            f"mesh_shape {mesh_shape} does not cover {total} ranks "
            f"({node_count} nodes x {local_rank_count})")
    if m > local_rank_count or local_rank_count % m != 0:
        raise ValueError(
            f"model axis {m} would span node boundaries "
            f"({local_rank_count} ranks per node): the discriminative "
            f"reductions would cross the network between nodes. Use a model "
            f"axis that divides the ranks per node and put the surplus on "
            f"'data'.")


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of a batch's arrays (tensors or numpy arrays)."""
    rows = mesh.local_rows(arrays[0].shape[0])
    return tuple(a[rows] for a in arrays)


def is_sharded(name: str, leaf) -> bool:
    """The ONE sharding rule for parameters and Adam moments: a rank-2 leaf
    whose name contains ``mu2_table`` (the table itself and, under the same
    name, its two moments) is row-sharded over "model"; everything else is
    replicated."""
    return "mu2_table" in name and leaf.dim() == 2


def shard_model(model, mesh: Mesh):
    """Pad ``model``'s mu2 table with zero rows to a multiple of the model
    axis and keep this rank's rows of it; the model then scores through the
    mesh (``num_seqs_padded``, ``shard_mesh``). Moments made after this
    (``create_train_state``) have the shard's shape."""
    n_pad = padded_num_seqs(model.num_seqs, mesh.shape[1])
    table = model.mu2_table.data
    padded = torch.zeros((n_pad, table.shape[1]), dtype=table.dtype,
                         device=table.device)
    padded[:table.shape[0]] = table
    model.mu2_table = torch.nn.Parameter(mesh.table_shard(padded).clone())
    model.num_seqs_padded = n_pad
    model.shard_mesh = mesh
    return model


def gather_table_rows(mesh: Mesh, *shards: torch.Tensor) -> list[torch.Tensor]:
    """The whole padded tables of row shards (the table, its moments), on
    every rank: each rank writes its rows into zeros and the model group adds
    them up, all in one all-reduce."""
    m = mesh.shape[1]
    per = shards[0].shape[0]
    whole = torch.zeros((len(shards), per * m, shards[0].shape[1]),
                        dtype=shards[0].dtype, device=shards[0].device)
    rows = mesh.table_rows(per * m)
    for k, s in enumerate(shards):
        whole[k, rows] = s.detach()
    mesh.all_reduce_(whole, MODEL_AXIS)
    return list(whole)


def whole_tensors(mesh: Mesh, named: dict) -> dict:
    """``named`` (name -> tensor) with every row-sharded leaf
    (:func:`is_sharded`) gathered whole by :func:`gather_table_rows`; every
    rank takes part."""
    sharded = [k for k, v in named.items() if is_sharded(k, v)]
    return {**named, **dict(zip(sharded, gather_table_rows(
        mesh, *(named[k] for k in sharded))))}


def replicas_equal(mesh: Mesh, tensors) -> bool:
    """Whether the replicated ``tensors`` hold the same bits on every rank:
    their largest and smallest value over all ranks must coincide, element
    by element (two all-reduces over the default group)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return bool(torch.equal(hi, lo))


class _GatherRowsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_local, idx, mesh):
        per = table_local.shape[0]
        local = idx.long() - mesh.model_index * per
        own = (local >= 0) & (local < per)
        local = local.clamp(0, per - 1)
        ctx.save_for_backward(local, own)
        ctx.per = per
        rows = table_local[local] * own[:, None].to(table_local.dtype)
        return mesh.model_sum(rows)

    @staticmethod
    def backward(ctx, g):
        local, own = ctx.saved_tensors
        d_table = torch.zeros((ctx.per, g.shape[1]), dtype=g.dtype,
                              device=g.device)
        # accumulate sorts its indices on CUDA and runs no atomics: rows
        # gathered twice add up in a fixed order
        d_table.index_put_((local,), g * own[:, None].to(g.dtype),
                           accumulate=True)
        return d_table, None, None


def gather_rows(table_local: torch.Tensor, idx: torch.Tensor,
                mesh: Mesh) -> torch.Tensor:
    """``table[idx]`` of the row-sharded table, ``[B, Dz]`` on every rank of
    the model group (which must pass the same ``idx``, rows of the whole
    padded table): each rank gathers the rows it owns, zeros elsewhere, and
    the group adds them up. Backward: a row's gradient goes to its owner's
    shard only. GSPMD does this silently for the JAX package's
    ``table[seq_idx]``."""
    return _GatherRowsFn.apply(table_local, idx, mesh)
