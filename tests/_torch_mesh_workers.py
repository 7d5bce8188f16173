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


def _feature_store(arrays):
    """The store that the test built, from its sequences' rows and
    lengths."""
    from pytorch_scalablefhvae_tpu_torch.data.feature_store import (
        FeatureStore,
    )

    data = arrays["store_data"]
    bounds = np.cumsum([0, *arrays["store_lens"]])
    return FeatureStore.from_arrays({
        f"s{i}": data[lo:hi] for i, (lo, hi) in enumerate(
            zip(bounds[:-1], bounds[1:]))})


def _mesh_state(arrays, mesh, dims):
    model = FHVAE(lstm_mm_dtype="float32", **dims)
    model.load_state_dict({k[6:]: torch.from_numpy(v) for k, v in
                           arrays.items() if k.startswith("param.")})
    return tstep.create_train_state(pmesh.shard_model(model, mesh), seed=0)


def bundle_steps(inp, out_dir, shape, dims, alpha, k):
    """Two dispatches of a K-step bundle on the mesh from each of three
    inputs (``host``: the batches stacked in ``HostInputs``; ``device`` and
    ``device sharded``: the plan over the store staged replicated or
    row-sharded, ``PlanInputs``), each step's whole-batch noise handed in
    as the rank's rows, beside the same steps run eagerly from the same
    start and noise. Saves, per input, the losses, the whole table and its
    first moment, every replicated parameter as this rank holds it, the
    counts, whether the replicas agree, whether the bundle would replay a
    graph and whether its state equals the eager steps' bit for bit."""
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        DeviceDataSource,
    )
    from pytorch_scalablefhvae_tpu_torch.data.loader import Batch
    from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
    from pytorch_scalablefhvae_tpu_torch.train.device_step import (
        PlanInputs,
        device_train_step,
    )
    from pytorch_scalablefhvae_tpu_torch.train.graphs import (
        HostInputs,
        StepBundle,
    )

    mesh = pmesh.make_mesh(shape, CPU)
    with np.load(inp) as z:
        arrays = {key: z[key] for key in z.files}
    n_steps, bs, seg_len = (int(arrays[key]) for key in
                            ("n_steps", "batch", "seg_len"))
    rows = mesh.local_rows(bs)
    noise = [{key: torch.from_numpy(arrays[f"eps_{key}{i}"][rows])
              for key in ("z2", "z1")} for i in range(n_steps)]
    opt = tstep.make_optimizer(1e-3, 0.95, 0.999)
    ds = SegmentDataset(_feature_store(arrays), seg_len=seg_len,
                        seg_shift=int(arrays["seg_shift"]))
    out = {}
    for tier in ("host", "device", "device sharded"):
        bundled, eager = (_mesh_state(arrays, mesh, dims) for _ in range(2))
        if tier == "host":
            batches = [Batch(*(arrays[f"{f}{i}"] for f in
                               ("x", "seq", "nsegs", "weight")), n_real=0)
                       for i in range(n_steps)]
            inputs = HostInputs(k, bs, seg_len, dims["feat_dim"], CPU,
                                mesh=mesh)
            step = make_sharded_train_step(eager, opt, alpha, mesh)
            want = [float(step(*(torch.from_numpy(a) for a in (
                b.feats, b.seq_idx, b.nsegs, b.weight)), noise={
                    key: torch.from_numpy(arrays[f"eps_{key}{i}"])
                    for key in ("z2", "z1")})["loss"])
                for i, b in enumerate(batches)]
        else:
            src = DeviceDataSource(ds.store, CPU, mesh=mesh,
                                   shard_store=tier.endswith("sharded"))
            plan, plan_arrays = src.stage_epoch(ds, arrays["order"], bs)
            inputs = PlanInputs(src.data, bs, seg_len, mesh)
            inputs.load_plan(plan_arrays, plan.n_real)
            want = [float(device_train_step(
                eager, opt, src.data, plan_arrays, b * bs, plan.n_real,
                alpha, batch_size=bs, seg_len=seg_len, noise=noise[i],
                mesh=mesh)["loss"])
                for i, b in enumerate(arrays["plan_batches"])]
        bundle = StepBundle(bundled, opt, alpha, k, inputs, CPU, mesh)
        got = []
        for d in range(n_steps // k):
            if tier == "host":
                inputs.load(batches[d * k:(d + 1) * k])
            else:
                inputs.set_base(int(arrays["plan_batches"][d * k]) * bs)
            got += bundle(noise=noise[d * k:(d + 1) * k])["loss"].tolist()
        model = bundled.model
        table, mu = pmesh.gather_table_rows(mesh, model.mu2_table,
                                            bundled.mu["mu2_table"])
        params = {f"param.{n}": p.detach()
                  for n, p in model.named_parameters()
                  if not pmesh.is_sharded(n, p)}
        same = got == want and all(
            torch.equal(a, b) for x, y in ((bundled.params(), eager.params()),
                                           (bundled.mu, eager.mu),
                                           (bundled.nu, eager.nu))
            for a, b in zip(x.values(), y.values()))
        out.update({f"{tier}/{key}": v for key, v in dict(
            losses=got, table=table, table_mu=mu, step=bundled.step,
            count=bundled.count, replays=bundle.replays, same_as_eager=same,
            equal=pmesh.replicas_equal(mesh, list(params.values())),
            **params).items()})
    _save(out_dir, **out)
    return 0


def nccl_bundle_replays(out_dir, k, device="cuda"):
    """A one-rank NCCL mesh on the card (``device="cpu"``: a gloo rank on
    the CPU, where the bundle runs eagerly): three dispatches of a K-step
    bundle over a staged seeded store (eager, captured and replayed,
    replayed; the model at the CLI's widths, so through the tensor-core
    kernels and #7) against the same steps run eagerly on the mesh from
    the same state. Saves the losses, whether every parameter and moment
    is equal, whether the bundle replayed, and each dispatch's launches."""
    import json

    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        DeviceDataSource,
    )
    from pytorch_scalablefhvae_tpu_torch.data.feature_store import (
        FeatureStore,
    )
    from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
    from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
    from pytorch_scalablefhvae_tpu_torch.train.device_step import (
        PlanInputs,
        device_train_step,
    )
    from pytorch_scalablefhvae_tpu_torch.train.graphs import (
        StepBundle,
        launch_counts,
    )

    dev = (CPU if device == "cpu"
           else torch.device("cuda", torch.cuda.current_device()))
    mesh = pmesh.make_mesh((1, 1), dev)
    seg_len, dim, bs = 20, 80, 64
    rng = np.random.default_rng(7)
    store = FeatureStore.from_arrays({
        f"s{i}": rng.standard_normal((n, dim)).astype(np.float32)
        for i, n in enumerate(rng.integers(60, 160, 80))})
    ds = SegmentDataset(store, seg_len=seg_len, seg_shift=8)
    order = SegmentLoader(ds, bs, shuffle=True, seed=0)._order()
    source = DeviceDataSource(store, dev, mesh=mesh)
    plan, arrays = source.stage_epoch(ds, order, bs)
    model = FHVAE(seg_len * dim, num_seqs=ds.num_seqs, feat_dim=dim,
                  generator=torch.Generator().manual_seed(7))
    states = []
    for _ in range(2):
        m = FHVAE(seg_len * dim, num_seqs=ds.num_seqs, feat_dim=dim)
        m.load_state_dict(model.state_dict())
        states.append(tstep.create_train_state(
            pmesh.shard_model(m, mesh).to(dev), seed=3))
    opt = tstep.make_optimizer(1e-3, 0.95, 0.999)
    eager = [float(device_train_step(
        states[0], opt, source.data, arrays, b * bs, plan.n_real, 10.0,
        batch_size=bs, seg_len=seg_len, mesh=mesh)["loss"])
        for b in range(3 * k)]
    inputs = PlanInputs(source.data, bs, seg_len, mesh)
    inputs.load_plan(arrays, plan.n_real)
    bundle = StepBundle(states[1], opt, 10.0, k, inputs, dev, mesh)
    got, deltas = [], []
    for d in range(3):
        before = launch_counts()
        inputs.set_base(d * k * bs)
        got += bundle()["loss"].tolist()
        after = launch_counts()
        deltas.append({e.__name__: after[(e, c)] - n
                       for (e, c), n in before.items()
                       if c == "launches" and after[(e, c)] != n})
    a, b = states
    equal = a.step == b.step == a.count == b.count == 3 * k and all(
        torch.equal(x[n], y[n]) for x, y in ((a.params(), b.params()),
                                             (a.mu, b.mu), (a.nu, b.nu))
        for n in x)
    (Path(out_dir) / "nccl_bundle.json").write_text(json.dumps({
        "backend": mesh.backend, "replays": bundle.replays,
        "graph": bundle.graph is not None, "losses": got, "eager": eager,
        "equal": equal, "deltas": deltas}))
    return 0


def cli_runs(runs_json):
    """Every CLI run of ``runs_json`` (``{name: argv}``) in turn, this
    process being a rank of the group that ``run_ranks`` set up
    (``--distributed``); stops at the first that fails."""
    import json

    from pytorch_scalablefhvae_tpu_torch.cli.main import main

    for argv in json.loads(Path(runs_json).read_text()).values():
        code = main(argv + ["--distributed", "--dist-backend", "gloo"])
        if code:
            return code
    return 0


def raise_in_rank_one():
    """Rank 1 fails; rank 0 waits for it in a collective."""
    if dist.get_rank() == 1:
        raise RuntimeError("this rank fails")
    dist.all_reduce(torch.zeros(1))
    return 0


def hier_rounds(inp, out_dir, shape, dims, runs_json):
    """A hierarchical round's pieces on the mesh, in turn (rank side of
    ``tests/test_torch_mesh_hier.py``): (a) ``device_map_pass_rows`` over a
    subset view of a store staged replicated and row-sharded; (b) the
    JAX run's epoch-0 checkpoint resumed through the CLI, JAX's noise handed
    to every step, each turnover's whole table kept; (c) every other CLI run
    of ``runs_json`` (``{"turnover": argv, "runs": {name: argv}}``), the
    epoch plans derived by ``DeviceEpochPlanner`` during the run named
    ``"plan"`` kept. Saves the tables, the turnover's tables and the plans
    into ``rank<r>.npz``."""
    import json

    from pytorch_scalablefhvae_tpu_torch.cli.main import main
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        DeviceDataSource,
        DeviceEpochPlanner,
    )
    from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
    from pytorch_scalablefhvae_tpu_torch.train import rounds
    from pytorch_scalablefhvae_tpu_torch.train.device_step import (
        device_map_pass_rows,
    )

    mesh = pmesh.make_mesh(shape, CPU)
    with np.load(inp) as z:
        arrays = {k: z[k] for k in z.files}
    seg_len, seg_shift, bs, n_batches, num_rows = (
        int(arrays[k]) for k in ("seg_len", "seg_shift", "batch", "n_batches",
                                 "num_rows"))
    store = _feature_store(arrays)
    sub = store.subset([store.seq_keys[i] for i in arrays["sub_idx"]])
    ds = SegmentDataset(sub, seg_len=seg_len, seg_shift=seg_shift)
    model = FHVAE(lstm_mm_dtype="float32", **dims)
    model.load_state_dict({k[6:]: torch.from_numpy(v) for k, v in
                           arrays.items() if k.startswith("param.")})
    out = {}
    for shard in (False, True):
        src = DeviceDataSource(store, CPU, mesh=mesh, shard_store=shard)
        starts, nsegs = src.stage_meta(ds)
        out[f"map/{shard}"] = device_map_pass_rows(
            model, src.data, starts, nsegs, seg_len=seg_len,
            seg_shift=seg_shift, batch_size=bs, n_batches=n_batches,
            num_rows=num_rows, pz2_var=float(np.exp(model.pz2_logvar)),
            mesh=mesh)

    todo = json.loads(Path(runs_json).read_text())
    gloo = ["--distributed", "--dist-backend", "gloo"]
    tables = []

    def jax_noise(state, rows, device, mesh):
        take = mesh.local_rows(rows * mesh.shape[0])
        return {k: torch.from_numpy(arrays[f"eps_{k}{state.step}"][take])
                for k in ("z2", "z1")}

    def swap(state, table):
        tables.append(table.clone())
        real_swap(state, table)

    real_noise, real_swap = tstep.step_noise, rounds.replace_mu2_table
    tstep.step_noise, rounds.replace_mu2_table = jax_noise, swap
    try:
        code = main(todo["turnover"] + gloo)
    finally:
        tstep.step_noise, rounds.replace_mu2_table = real_noise, real_swap
    if code:
        return code
    out["turnover_tables"] = torch.stack(tables)

    plans = []

    def plan(self, epoch, n_real, batch_size):
        got = real_plan(self, epoch, n_real, batch_size)
        plans.append(torch.stack(got[1][:2]))
        return got

    real_plan = DeviceEpochPlanner.plan
    for name, argv in todo["runs"].items():
        DeviceEpochPlanner.plan = plan if name == "plan" else real_plan
        try:
            code = main(argv + gloo)
        finally:
            DeviceEpochPlanner.plan = real_plan
        if code:
            return code
    out["plans"] = torch.stack(plans)
    _save(out_dir, **out)
    return 0


def map_pass_rows_card(inp, out_dir, dims):
    """``device_map_pass_rows`` on a one-rank NCCL mesh on the card, over a
    subset view of a store held as a ``RowShard`` (on one rank the shard is
    the whole store, so every window goes through ``gather_sharded`` and
    the model group's all-reduce); the LSTM kernels' launches counted.
    Saves the table and the launches of the forward entries."""
    from pytorch_scalablefhvae_tpu_torch.data.device_store import RowShard
    from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
    from pytorch_scalablefhvae_tpu_torch.ops import lstm_cuda
    from pytorch_scalablefhvae_tpu_torch.train.device_step import (
        device_map_pass_rows,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = pmesh.make_mesh((1, 1), dev)
    with np.load(inp) as z:
        arrays = {k: z[k] for k in z.files}
    store = _feature_store(arrays)
    sub = store.subset([store.seq_keys[i] for i in arrays["sub_idx"]])
    ds = SegmentDataset(sub, seg_len=int(arrays["seg_len"]),
                        seg_shift=int(arrays["seg_shift"]))
    model = FHVAE(lstm_mm_dtype="float32", **dims)
    model.load_state_dict({k[6:]: torch.from_numpy(v) for k, v in
                           arrays.items() if k.startswith("param.")})
    model.to(dev)
    rows = torch.from_numpy(store.data).to(dev)
    shard = RowShard(rows, 0, rows.shape[0], rows.shape[0], mesh)
    before = lstm_cuda.lstm2_tm_proj.launches
    table = device_map_pass_rows(
        model, shard,
        torch.from_numpy(np.asarray(sub.seq_starts, np.int64)).to(dev),
        torch.from_numpy(np.asarray(ds.nsegs, np.int64)).to(dev),
        seg_len=ds.seg_len, seg_shift=ds.seg_shift,
        batch_size=int(arrays["batch"]), n_batches=int(arrays["n_batches"]),
        num_rows=int(arrays["num_rows"]),
        pz2_var=float(np.exp(model.pz2_logvar)), mesh=mesh)
    _save(out_dir, table=table.cpu(),
          launches=lstm_cuda.lstm2_tm_proj.launches - before)
    return 0

