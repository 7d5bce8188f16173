"""What the ranks of the mesh tests run (``parallel/launch.run_ranks``).

A spawned rank imports this module, so it imports torch and the port only:
the tests compute the JAX side in their own process and pass arrays through
``.npz`` files. Every function here runs with the default process group up
and writes ``rank<r>.npz`` into ``out_dir``.
"""

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
from pytorch_scalablefhvae_tpu_torch.ops import discriminative as disc
from pytorch_scalablefhvae_tpu_torch.parallel import mesh as pmesh
from pytorch_scalablefhvae_tpu_torch.parallel.sharded_step import (
    make_sharded_encode_step,
    make_sharded_eval_step,
    make_sharded_train_step,
)
from pytorch_scalablefhvae_tpu_torch.train import step as tstep

CPU = torch.device("cpu")


def _save(out_dir, **arrays):
    np.savez(Path(out_dir) / f"rank{dist.get_rank()}.npz",
             **{k: np.asarray(v) for k, v in arrays.items()})


def sharded_entry(inp, out_dir, shape, pz2_logvar, num_real):
    """``discriminative_log_qy_sharded`` forward and backward through the
    real groups, on this rank's batch rows and table shard."""
    mesh = pmesh.make_mesh(shape, CPU)
    with np.load(inp) as z:
        z2, table, seq, g = (torch.from_numpy(z[k])
                             for k in ("z2", "table", "seq", "g"))
    rows = mesh.local_rows(z2.shape[0])
    z2_loc = z2[rows].clone().requires_grad_()
    shard = table[mesh.table_rows(table.shape[0])].clone().requires_grad_()
    out = disc.discriminative_log_qy_sharded(z2_loc, shard, seq[rows],
                                             pz2_logvar, mesh, num_real)
    dz2, dmu2 = torch.autograd.grad(out, (z2_loc, shard), g[rows])
    _save(out_dir, log_qy=out.detach(), dz2=dz2, dmu2=dmu2,
          launches=disc.discriminative_log_qy_sharded.launches)
    return 0


def train_steps(inp, out_dir, shape, dims, alpha):
    """A sharded eval and encode step of a small FHVAE at given parameters,
    then train steps on the mesh from given batches and whole-batch noise.
    Saves the eval sums, this rank's encoded rows, the losses, the whole
    table and its first moment, and every replicated parameter as this rank
    holds it."""
    mesh = pmesh.make_mesh(shape, CPU)
    with np.load(inp) as z:
        arrays = {k: z[k] for k in z.files}
    n_steps = int(arrays["n_steps"])
    model = FHVAE(lstm_mm_dtype="float32", **dims)
    model.load_state_dict({k[6:]: torch.from_numpy(v)
                           for k, v in arrays.items() if k.startswith("param.")})
    model = pmesh.shard_model(model, mesh)
    batch = [torch.from_numpy(arrays[f"{k}0"])
             for k in ("x", "seq", "nsegs", "weight")]
    sums = make_sharded_eval_step(model, alpha, mesh)(
        *batch, torch.from_numpy(arrays["eval_table"]))
    z2 = make_sharded_encode_step(model, mesh)(batch[0])
    state = tstep.create_train_state(model, seed=0)
    step = make_sharded_train_step(
        state, tstep.make_optimizer(1e-3, 0.95, 0.999), alpha, mesh)
    losses = []
    for i in range(n_steps):
        batch = [torch.from_numpy(arrays[f"{k}{i}"])
                 for k in ("x", "seq", "nsegs", "weight")]
        noise = {k: torch.from_numpy(arrays[f"eps_{k}{i}"])
                 for k in ("z2", "z1")}
        losses.append(float(step(*batch, noise=noise)["loss"]))
    table, mu = pmesh.gather_table_rows(mesh, model.mu2_table,
                                        state.mu["mu2_table"])
    out = {f"param.{n}": p.detach() for n, p in model.named_parameters()
           if not pmesh.is_sharded(n, p)}
    out["equal"] = pmesh.replicas_equal(mesh, list(out.values()))
    _save(out_dir, losses=losses, table=table, table_mu=mu, z2=z2,
          step=state.step, count=state.count,
          **{f"eval.{k}": v for k, v in sums.items()}, **out)
    return 0


def sharded_gather(inp, out_dir, shape):
    """The windows of this rank's batch rows gathered from a store staged
    row-sharded over the model axis (``--shard-device-store``), in each
    transfer dtype, and the rows the rank staged."""
    from types import SimpleNamespace

    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        DeviceDataSource,
    )
    from pytorch_scalablefhvae_tpu_torch.train.device_step import (
        gather_segments,
    )

    mesh = pmesh.make_mesh(shape, CPU)
    with np.load(inp) as z:
        data, starts, seg_len = z["data"], z["starts"], int(z["seg_len"])
    starts = torch.from_numpy(starts[mesh.local_rows(len(starts))]).long()
    out = {}
    for dtype in ("float32", "bfloat16", "int8"):
        src = DeviceDataSource(SimpleNamespace(data=data), CPU, dtype,
                               mesh=mesh, shard_store=True)
        out[dtype] = gather_segments(src.data, starts, seg_len)
        out[f"{dtype}.rows"] = src.rows.float()
    _save(out_dir, **out)
    return 0


def raise_in_rank_one():
    """Rank 1 fails; rank 0 waits for it in a collective."""
    if dist.get_rank() == 1:
        raise RuntimeError("this rank fails")
    dist.all_reduce(torch.zeros(1))
    return 0
