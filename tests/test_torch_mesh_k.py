"""K whole mesh steps a dispatch: ``train --mesh d,m --steps-per-dispatch K``
on the CPU.

Ranks are real processes (gloo on the CPU, one torch thread each), started
by ``parallel/launch.run_ranks``; what they run lives in
``tests/_torch_mesh_workers.py``, which imports no jax. Under gloo a bundle
runs its K step bodies eagerly through the static buffers that a CUDA
graph reads under NCCL (``tests/test_torch_gpu.py`` holds the replay on a
card). The JAX side runs in this process on the virtual CPU mesh of
``tests/conftest.py``, with ``use_pallas="always"`` (the sharded Pallas
entry in interpret mode) and fp32 LSTM operands, as in
``tests/test_torch_parallel.py``; the weights cross by ``params_from_jax``
and each step's noise is JAX's draw.

- (a) the port's bundle at K = 3 on ``(2, 2)``, from the host loader's
  batches, against JAX ``make_sharded_multi_train_step``;
- (b) the same over the staged store, replicated and row-sharded, against
  JAX ``make_device_train_step(k=3, mesh, shard_store)``; limits of (a) and
  (b) as ``tests/test_torch_parallel.py``'s: loss 2e-5 relative, table 2e-4
  relative / 2e-5 absolute, padded rows exactly 0; replicated parameters
  as ``tests/test_torch_multi_step.py`` holds them; and each bundle equal
  bit for bit to the same steps run eagerly on the mesh;
- (c) ``train --mesh 2,2 --steps-per-dispatch 3`` through the CLI against
  ``--steps-per-dispatch 1``, bit for bit (metrics and every checkpoint
  array), on the host loader, the device tier (replicated and
  ``--shard-device-store``) and the streamed tier, on epochs whose batch
  counts leave a tail of eager steps;
- (d) a K = 3 mesh run stopped by ``--max-steps`` mid-epoch and resumed,
  against the run never stopped (``train_loss`` to 1e-12, all else bit for
  bit);
- (e) the replay-or-eager rule, by device type and backend;
- (f) ``--ckpt-backend orbax`` on ``(2, 2)`` (the device tier at K = 3,
  stopped and resumed): every rank's DCP file holds only its own rows of
  the mu2 table and its moments, the checkpoint equals the npz run's bit
  for bit, and it loads on ``(1, 2)`` and on one device.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import _torch_mesh_workers as workers
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
)
from pytorch_scalablefhvae_tpu_torch.data.feature_store import FeatureStore
from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
from pytorch_scalablefhvae_tpu_torch.parallel import launch
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train.graphs import (
    HostInputs,
    StepBundle,
    dispatch_line,
    replays_graph,
)
from pytorch_scalablefhvae_tpu_torch.train.step import (
    create_train_state,
    make_optimizer,
)
from test_torch_parallel import ALPHA, DIMS, NUM_SEQS, WIDTHS, B, F, T
from test_torch_parallel import make_batch

K = 3
CPU = torch.device("cpu")
RUN = "synthetic_np_fbank"
STEM = f"fhvae_{RUN}"
SEG_SHIFT = 2
PLAN_BATCHES = tuple(range(6))  # (b): the second dispatch ends on the
                                # plan's padded batch
MESH = ["--mesh", "2,2", "--dist-backend", "gloo", "--dist-timeout", "60"]
TRAIN_BATCH = 16      # (c): 10 batches an epoch, 3 bundles and 1 eager step
CHUNK = 350_000       # (c): two chunks of 7 and 4 batches (11 an epoch): a
                      # dispatch window across the switch runs eagerly
ORBAX_STOP = 13       # (f): epoch 1, batch 3, inside a bundle of 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Four ranks start beside the test process while other test processes
    run: every process keeps to one thread (``OMP_NUM_THREADS=1``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    yield
    mp.undo()
    torch.set_num_threads(before)


# ------------------------------------------------------- (e) the rule


@pytest.mark.parametrize("device,backend,replays,says", [
    ("cuda", None, True, ", replayed as one CUDA graph"),
    ("cuda", "nccl", True,
     ", replayed as one CUDA graph (NCCL all-reduces inside)"),
    ("cuda", "gloo", False,
     ", run eagerly: gloo all-reduces pass through the host"),
    ("cpu", None, False, ""),
    ("cpu", "gloo", False, ""),
])
def test_replay_or_eager_rule(device, backend, replays, says):
    """A graph on a card without a mesh or under NCCL; K eager step bodies
    under gloo (its all-reduce of a CUDA tensor passes through the host)
    and on the CPU; the loop's line says which."""
    assert replays_graph(device, backend) is replays
    assert dispatch_line(8, device, backend) == f"8 steps per dispatch{says}"


def test_a_bundle_that_runs_eagerly_captures_nothing():
    """``capture`` refuses where the rule says eager steps: nothing drops
    from one mode to the other."""
    state = create_train_state(FHVAE(lstm_mm_dtype="float32", **DIMS))
    bundle = StepBundle(state, make_optimizer(1e-3, 0.95, 0.999), ALPHA, K,
                        HostInputs(K, B, T, F, CPU), CPU)
    assert not bundle.replays
    with pytest.raises(ValueError, match="CUDA graph needs"):
        bundle.capture()


# ------------------------------------------------ (a), (b) against JAX


def seeded_store():
    """13 sequences of 9-21 frames (``NUM_SEQS``, one table row each),
    windows of ``T`` frames at shift 2: a plan of six 16-row batches, the
    last one padded."""
    rng = np.random.default_rng(4)
    lens = rng.integers(9, 22, NUM_SEQS)
    data = rng.standard_normal((int(lens.sum()), F)).astype(np.float32)
    return data, lens


@pytest.fixture(scope="module")
def jax_and_ranks(tmp_path_factory):
    """JAX-initialised weights, six batches (the first scaled so that its
    gradient norm passes the clip), the staged store and its epoch order,
    JAX's noise for six steps; JAX's two K = 3 dispatches on the ``(2, 2)``
    mesh from the stacked batches and from the store (replicated and
    row-sharded); and every rank's bundles from the same (the worker)."""
    import jax
    import jax.numpy as jnp

    from pytorch_scalablefhvae_tpu.data.device_store import (
        DeviceDataSource as JaxDeviceDataSource,
    )
    from pytorch_scalablefhvae_tpu.data.feature_store import (
        FeatureStore as JaxFeatureStore,
    )
    from pytorch_scalablefhvae_tpu.data.segments import (
        SegmentDataset as JaxSegmentDataset,
    )
    from pytorch_scalablefhvae_tpu.models.fhvae import FHVAE as JaxFHVAE
    from pytorch_scalablefhvae_tpu.parallel.mesh import (
        make_mesh,
        shard_stacked_batch,
        shard_state,
    )
    from pytorch_scalablefhvae_tpu.parallel.sharded_step import (
        make_sharded_multi_train_step,
    )
    from pytorch_scalablefhvae_tpu.train import step as jax_step
    from pytorch_scalablefhvae_tpu.train.device_step import (
        make_device_train_step,
    )
    from pytorch_scalablefhvae_tpu.train.loop import _replace_mu2_table

    jm = JaxFHVAE(use_pallas="always", lstm_pallas="never",
                  lstm_mm_dtype="float32", **DIMS)
    opt = jax_step.make_optimizer(1e-3, 0.95, 0.999)
    start = jax_step.create_train_state(jm, opt, seed=0)
    params = ckpt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         start.params))
    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    jm_pad = dataclasses.replace(jm, num_seqs_padded=14, shard_mesh=mesh)

    def fresh():
        return shard_state(mesh, _replace_mu2_table(
            jax_step.create_train_state(jm_pad, opt, seed=0),
            np.pad(np.asarray(start.params["mu2_table"]), ((0, 1), (0, 0)))))

    n_steps = 2 * K
    batches = [make_batch(s, scale=30.0 if s == 0 else 1.0)
               for s in range(n_steps)]
    data, lens = seeded_store()
    bounds = np.cumsum([0, *lens])
    seqs = {f"s{i}": data[lo:hi]
            for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))}
    ds = SegmentDataset(FeatureStore.from_arrays(seqs), seg_len=T,
                        seg_shift=SEG_SHIFT)
    order = SegmentLoader(ds, B, shuffle=True, seed=0)._order()
    jds = JaxSegmentDataset(JaxFeatureStore.from_arrays(seqs), seg_len=T,
                            seg_shift=SEG_SHIFT)
    arrays = {"n_steps": n_steps, "batch": B, "seg_len": T,
              "seg_shift": SEG_SHIFT, "store_data": data, "store_lens": lens,
              "order": order, "plan_batches": np.array(PLAN_BATCHES),
              **{f"param.{k}": v.numpy() for k, v in params.items()}}
    for i, arrs in enumerate(batches):
        for key, a in zip(("x", "seq", "nsegs", "weight"), arrs):
            arrays[f"{key}{i}"] = a
        k_enc, _ = jax.random.split(jax.random.fold_in(start.rng, i))
        k2, k1 = jax.random.split(k_enc)
        arrays[f"eps_z2{i}"] = np.asarray(
            jax.random.normal(k2, (B, 8), jnp.float32))
        arrays[f"eps_z1{i}"] = np.asarray(
            jax.random.normal(k1, (B, 8), jnp.float32))

    def trajectory(step, args_of):
        state, losses = fresh(), []
        for d in range(n_steps // K):
            state, metrics = step(state, *args_of(d))
            losses += np.asarray(metrics["loss"]).tolist()
        return {"losses": losses,
                "table": np.asarray(jax.device_get(
                    state.params["mu2_table"])),
                "params": jax.tree_util.tree_map(np.asarray, state.params),
                "step": int(state.step)}

    jax_runs = {"host": trajectory(
        make_sharded_multi_train_step(jm_pad, opt, ALPHA, mesh, donate=False),
        lambda d: shard_stacked_batch(mesh, *(
            np.stack([b[f] for b in batches[d * K:(d + 1) * K]])
            for f in range(4))))}
    for shard in (False, True):
        src = JaxDeviceDataSource(jds.store, mesh, shard_store=shard)
        plan, jarrays = src.stage_epoch(jds, order, B)
        assert plan.n_batches == 6 and plan.n_real % B
        jax_runs["device sharded" if shard else "device"] = trajectory(
            make_device_train_step(jm_pad, opt, ALPHA, T, B, k=K, mesh=mesh,
                                   shard_store=shard, donate=False),
            lambda d, src=src, jarrays=jarrays, plan=plan: (
                src.data, *jarrays, np.int32(PLAN_BATCHES[d * K] * B),
                np.int32(plan.n_real)))

    tmp = tmp_path_factory.mktemp("bundles")
    np.savez(tmp / "in.npz", **arrays)
    codes = launch.run_ranks(
        workers.bundle_steps, 4,
        (str(tmp / "in.npz"), str(tmp), (2, 2), DIMS, ALPHA, K),
        backend="gloo", device="cpu", timeout_s=60, join_timeout_s=120)
    assert codes == [0] * 4
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return jax_runs, ranks


@pytest.mark.parametrize("tier", ["host", "device", "device sharded"])
def test_mesh_bundle_matches_jax(jax_and_ranks, tier):
    """(a) ``host``: against ``make_sharded_multi_train_step``; (b)
    ``device`` and ``device sharded``: against ``make_device_train_step(k=3,
    mesh, shard_store)``. Two dispatches, the first through the clip, three
    weight-0 rows on the second data rank (or the plan's padded batch), 13
    sequences padded to 14. Every rank's bundle runs eagerly under gloo and
    equals the same mesh steps run eagerly, bit for bit."""
    jax_runs, ranks = jax_and_ranks
    want = jax_runs[tier]
    assert want["step"] == 2 * K
    assert (want["table"][NUM_SEQS:] == 0.0).all()
    jax_params = ckpt.params_from_jax(want["params"])
    for r in ranks:
        def get(key):
            return r[f"{tier}/{key}"]

        assert not bool(get("replays"))
        assert bool(get("same_as_eager")) and bool(get("equal"))
        assert int(get("step")) == int(get("count")) == 2 * K
        np.testing.assert_allclose(get("losses"), want["losses"], rtol=2e-5)
        table = get("table")
        assert table.shape == (14, 8) and (table[NUM_SEQS:] == 0.0).all()
        assert (get("table_mu")[NUM_SEQS:] == 0.0).all()
        np.testing.assert_allclose(table, want["table"], rtol=2e-4,
                                   atol=2e-5)
        for key in (k for k in r if k.startswith(f"{tier}/param.")):
            name = key.split("/param.", 1)[1]
            diff = np.abs(r[key] - jax_params[name].numpy())
            assert diff.max() <= 2e-4, (name, diff.max())
            assert (diff > 1e-5).mean() <= 0.005, name
    for key in (k for k in ranks[0] if f"{tier}/param." in k):
        for r in ranks[1:]:
            assert np.array_equal(r[key], ranks[0][key]), key


# ------------------------------------------------------ (c), (d) the CLI


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from pytorch_scalablefhvae_tpu_torch.features.pipeline import (
        preprocess_data,
    )

    root = tmp_path_factory.mktemp("corpus")
    preprocess_data(ExperimentConfig(data=DataConfig(
        dataset="synthetic", synthetic_speakers=9, synthetic_utts=5)),
        root=root)
    return root


def train_args(corpus, exp_root, *extra):
    return ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(corpus), "--mvn-path", str(corpus / "mvn.json"),
            "--training-batch-size", str(TRAIN_BATCH), "--dev-batch-size",
            "64", "--exp-root", str(exp_root), "--device", "cpu", "--epochs",
            "2", *WIDTHS, *extra]


def run_dir(exp_root):
    return exp_root / RUN / "fhvae_e2_p10_a10.0"


def metrics(d):
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


def assert_same_bits(got, want, loss_rtol=0.0):
    """Two runs' metrics (``train_loss`` to ``loss_rtol``; 0: equal) and
    every array of each epoch's checkpoint, bit for bit."""
    g, w = metrics(got), metrics(want)
    assert [r["epoch"] for r in g] == [r["epoch"] for r in w] == [0, 1]
    for a, b in zip(g, w):
        for k in ("train_steps", "step", "val_loss", "val_lower_bound",
                  "val_log_qy"):
            assert a[k] == b[k], (a["epoch"], k)
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=loss_rtol, atol=0)
    for e in (0, 1):
        with np.load(got / f"{STEM}_e{e}.npz") as x, \
                np.load(want / f"{STEM}_e{e}.npz") as y:
            assert set(x.files) == set(y.files)
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k], err_msg=(e, k))


def chunk_batches(corpus, epoch: int) -> list[int]:
    """The batch counts of ``epoch``'s chunks, in its schedule's order."""
    from pytorch_scalablefhvae_tpu_torch.data.stream_store import (
        StreamingDeviceSource,
    )
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders
    from pytorch_scalablefhvae_tpu_torch.train.loop import stream_seed

    loader = build_loaders(ExperimentConfig(data=DataConfig(
        dataset="synthetic", mvn_path=str(corpus / "mvn.json"),
        training_batch_size=TRAIN_BATCH)), corpus, True)[0]
    src = StreamingDeviceSource(loader.dataset, CHUNK, TRAIN_BATCH, CPU)
    loader.set_epoch(epoch)
    return [-(-len(order) // TRAIN_BATCH)
            for _, order in src.epoch_schedule(stream_seed(loader, epoch))]


TIERS = {
    "host": ["--data-placement", "host"],
    "device": ["--data-placement", "device"],
    "device sharded": ["--data-placement", "device",
                       "--shard-device-store"],
    "stream": ["--data-placement", "stream", "--stream-chunk-bytes",
               str(CHUNK)],
}


@pytest.fixture(scope="module")
def cli_runs(corpus, tmp_path_factory):
    """Two-epoch ``--mesh 2,2`` runs at K = 1 and K = 3 on each tier, and
    the streamed K = 3 run stopped by ``--max-steps`` one batch into epoch
    1's second chunk (where the cap clamps a bundle to one eager step),
    then resumed, and (f)'s orbax run on the device tier, stopped and
    resumed: four gloo ranks started once, each
    running every run through the CLI in turn. Returns the run directories
    by name and the stop step."""
    root = tmp_path_factory.mktemp("cli")
    n0, counts = sum(chunk_batches(corpus, 0)), chunk_batches(corpus, 1)
    assert counts == [7, 4]
    stop = n0 + counts[0] + 1
    runs, dirs = {}, {}
    for tier, flags in TIERS.items():
        for k in (1, 3):
            if k == 1 and tier == "device sharded":
                continue  # its K = 1 bits are the replicated store's
            name = f"{tier} K{k}"
            dirs[name] = root / name.replace(" ", "_")
            runs[name] = train_args(corpus, dirs[name], "--mesh", "2,2",
                                    *flags, "--steps-per-dispatch", str(k))
    dirs["stopped"] = root / "stopped"
    runs["stopped"] = train_args(corpus, dirs["stopped"], "--mesh", "2,2",
                                 *TIERS["stream"], "--steps-per-dispatch",
                                 "3", "--max-steps", str(stop))

    def resume(last):
        return ["train", "--dataset", "synthetic", "--preprocessed",
                "--data-root", str(corpus), "--device", "cpu",
                "--continue-from", str(last), "--resume-override",
                "max_steps=0"]

    runs["resumed"] = resume(run_dir(dirs["stopped"])
                             / f"{STEM}_e1s{stop - n0}.npz")
    # (f): orbax at K = 3, stopped at epoch 1, batch 3
    dirs["orbax"] = root / "orbax"
    runs["orbax stopped"] = train_args(
        corpus, dirs["orbax"], "--mesh", "2,2", *TIERS["device"],
        "--steps-per-dispatch", "3", "--ckpt-backend", "orbax",
        "--ckpt-every-steps", "4", "--max-steps", str(ORBAX_STOP))
    runs["orbax resumed"] = resume(run_dir(dirs["orbax"])
                                   / f"{STEM}_e1s{ORBAX_STOP - 10}.orbax")
    (root / "runs.json").write_text(json.dumps(runs))
    codes = launch.run_ranks(workers.cli_runs, 4, (str(root / "runs.json"),),
                             backend="gloo", device="cpu", timeout_s=60,
                             join_timeout_s=240)
    assert codes == [0] * 4
    return {name: run_dir(d) for name, d in dirs.items()}, stop - n0


@pytest.mark.parametrize("tier", list(TIERS))
def test_cli_mesh_k3_equals_k1(cli_runs, tier):
    """(c) ``--steps-per-dispatch 3`` on ``--mesh 2,2``: the K = 1 run's
    bits on every tier (bundles and a tail of eager steps: 10 batches an
    epoch; streamed, 11 in chunks of 7 and 4, each chunk's tail eager),
    the row-sharded store's included."""
    runs, _ = cli_runs
    n = 11 if tier == "stream" else 10
    recs = metrics(runs[f"{tier} K3"])
    assert recs[0]["train_steps"] == n and recs[1]["step"] == 2 * n
    assert_same_bits(runs[f"{tier} K3"],
                     runs[f"{tier.split()[0]} K1"])


def test_stopped_mesh_k3_run_resumes_to_the_same_bits(cli_runs):
    """(d) The streamed K = 3 mesh run stopped by ``--max-steps`` one batch
    into epoch 1's second chunk (the dispatches before the cap clamped to
    eager steps) and resumed there: the run never stopped, bit for bit
    (``train_loss`` to 1e-12: the stopped epoch's partials are added in
    another order); no step checkpoint outlives the epoch."""
    runs, batches_done = cli_runs
    d = runs["stopped"]
    assert not list(d.glob(f"{STEM}_e*s*.npz"))
    assert batches_done % K
    assert_same_bits(d, runs["stream K3"], loss_rtol=1e-12)


def test_cli_mesh_says_its_dispatches(corpus, tmp_path, capfd):
    """``--mesh 2,2 --steps-per-dispatch 3`` started by the CLI itself:
    rank 0 alone says how it dispatches (eager bodies on the CPU)."""
    assert main(train_args(corpus, tmp_path, *MESH, "--epochs", "1",
                           "--steps-per-dispatch", "3")) == 0
    out = capfd.readouterr().out
    assert out.count("3 steps per dispatch\n") == 1, out
    recs = metrics(tmp_path / RUN / "fhvae_e1_p10_a10.0")
    assert recs[0]["train_steps"] == 10 and np.isfinite(recs[0]["train_loss"])


def test_orbax_mesh_save_writes_each_ranks_rows_and_loads_anywhere(cli_runs):
    """(f) The ``(2, 2)`` orbax run stopped at step 13 and resumed: its
    epoch-1 directory holds the npz run's tensors bit for bit (whose save
    gathered the whole table on rank 0), each row shard of the mu2 table
    and its moments in the DCP file of a rank of that shard's model index;
    it loads on ``(1, 2)`` (each rank its rows) and on one device (the
    padding sliced off); no step directory is left."""
    from torch.distributed.checkpoint import FileSystemReader

    from pytorch_scalablefhvae_tpu_torch.models.base import build_model
    from pytorch_scalablefhvae_tpu_torch.parallel.mesh import Mesh, shard_model
    from test_torch_ckpt_steps import orbax_arrays

    runs, _ = cli_runs
    d, want = runs["orbax"], runs["device K1"]
    e1 = d / f"{STEM}_e1.orbax"
    assert not list(d.glob(f"{STEM}_e*s*.orbax"))
    g, w = metrics(d), metrics(want)
    for a, b in zip(g, w):
        for k in ("train_steps", "step", "val_loss", "val_lower_bound",
                  "val_log_qy"):
            assert a[k] == b[k], (a["epoch"], k)
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=1e-12, atol=0)
    with np.load(want / f"{STEM}_e1.npz") as z:
        npz = {k: z[k] for k in z.files}
    got = orbax_arrays(e1)
    assert set(got) == set(npz)
    for k, v in npz.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    per = npz["mu2_table"].shape[0] // 2
    shards = {}
    for idx, info in FileSystemReader(str(e1)).read_metadata() \
            .storage_data.items():
        if idx.fqn.endswith("mu2_table"):
            rank = int(info.relative_path.split("_")[2])  # __<rank>_0.distcp
            assert idx.offset[0] == (rank % 2) * per, (idx, info)
            shards.setdefault(idx.fqn, []).append(int(idx.offset[0]))
    assert {k: sorted(v) for k, v in shards.items()} == {
        k: [0, per] for k in ("mu2_table", "adam_mu.mu2_table",
                              "adam_nu.mu2_table")}

    meta = ckpt.read_checkpoint_meta(e1)
    config = ExperimentConfig.load(d / "config.json")

    def loaded(mesh):
        model = build_model("fhvae", meta["model_params"][0], config.model,
                            meta["num_seqs"], feat_dim=meta["feat_dim"])
        if mesh is not None:
            model = shard_model(model, mesh)
        state = create_train_state(model)
        ckpt.load_train_state(e1, state)
        return {**{k: v.detach().numpy() for k, v in
                   model.state_dict().items()},
                **{"adam_mu." + k: v.numpy() for k, v in state.mu.items()},
                **{"adam_nu." + k: v.numpy() for k, v in state.nu.items()}}

    for j in (0, 1):
        got = loaded(Mesh((1, 2), j, None, None, CPU))
        for k, v in got.items():
            whole = npz[k]
            if k.endswith("mu2_table"):
                whole = whole[j * per:(j + 1) * per]
            np.testing.assert_array_equal(v, whole, err_msg=(j, k))
    for k, v in loaded(None).items():
        whole = npz[k][:meta["num_seqs"]] if k.endswith("mu2_table") \
            else npz[k]
        np.testing.assert_array_equal(v, whole, err_msg=k)
