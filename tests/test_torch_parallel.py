"""The port's mesh training against its single-device step and the JAX
package's mesh-compiled step.

Ranks are real processes (gloo on the CPU, spawned by
``parallel/launch.run_ranks`` with a ``file://`` rendezvous); what they run
lives in ``tests/_torch_mesh_workers.py``, which imports no jax. The JAX side
runs in this process on the virtual CPU mesh of ``tests/conftest.py``, with
``use_pallas="always"`` so that its sharded Pallas entry runs (interpret
mode), at fp32 LSTM operands; the weights cross by ``params_from_jax`` and
each step's noise is JAX's draw.

Limits, as ``tests/test_parallel.py``: loss 2e-5 relative; table 2e-4
relative / 2e-5 absolute; padded rows exactly 0; eval sums and encoded means
2e-5 relative (1e-6 absolute on the means, 1e-4 on the sums, which are ~1e4).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import _torch_mesh_workers as workers
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
from pytorch_scalablefhvae_tpu_torch.parallel import launch
from pytorch_scalablefhvae_tpu_torch.parallel import mesh as pmesh
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train import step as tstep

B, T, F, NUM_SEQS, ALPHA, STEPS = 16, 5, 8, 13, 10.0, 4
DIMS = dict(input_size=T * F, z1_hus=(32, 32), z2_hus=(32, 32),
            x_hus=(32, 32), z1_dim=8, z2_dim=8, num_seqs=NUM_SEQS, feat_dim=F)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests start up to four ranks beside the test process while
    other test processes run: every process keeps to one thread, as the
    ranks do (``OMP_NUM_THREADS=1``), so that none waits for a core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ no group


@pytest.mark.parametrize("shape,nodes,local", [
    ((4, 2), 2, 4), ((2, 4), 2, 4), ((1, 8), 2, 4), ((4, 2), 1, 8),
    ((2, 3), 2, 4), ((8, 1), 2, 4), ((2, 3), 2, 3)])
def test_validate_multihost_mesh_as_the_original(shape, nodes, local):
    """The model axis must stay inside a node: the same verdicts as the JAX
    package's rule for hosts and their devices."""
    from pytorch_scalablefhvae_tpu.parallel.mesh import (
        validate_multihost_mesh as original,
    )

    def verdict(fn, *args):
        try:
            fn(*args)
            return "ok"
        except ValueError:
            return "raises"

    assert verdict(pmesh.validate_multihost_mesh, shape, nodes, local) == \
        verdict(original, shape, nodes, local)


def test_the_sharding_rule():
    model = FHVAE(**DIMS)
    sharded = [n for n, p in model.named_parameters()
               if pmesh.is_sharded(n, p)]
    assert sharded == ["mu2_table"]
    assert pmesh.is_sharded("adam_mu.mu2_table", model.mu2_table)
    assert not pmesh.is_sharded("mu2_table.scale", torch.zeros(3))


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh((2, 2), torch.device("cpu"))


def test_backend_and_device_rules():
    """The backend named is the backend used: the CPU needs gloo, and a
    card is never replaced by the CPU."""
    assert launch.rank_device("cpu", "gloo", 3, 4) == "cpu"
    with pytest.raises(ValueError, match="gloo"):
        launch.rank_device("cpu", "nccl", 0, 4)
    with pytest.raises(ValueError):
        launch.rank_device("cpu", "mpi", 0, 4)
    for backend in ("nccl", "gloo"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.rank_device("cuda", backend, 0, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run_ranks(workers.sharded_entry, 2, backend="nccl")


class FakeMesh:
    """A rank's position without its groups (for the slicing rules)."""

    def __init__(self, shape, rank):
        self.shape, self.rank = shape, rank

    data_index = pmesh.Mesh.data_index
    model_index = pmesh.Mesh.model_index
    local_rows = pmesh.Mesh.local_rows
    table_rows = pmesh.Mesh.table_rows


def test_rows_of_a_rank():
    """Rank ``i * m + j`` sits at ``(i, j)``: contiguous batch rows by
    ``i``, contiguous table rows by ``j``."""
    mesh = FakeMesh((2, 4), 6)
    assert (mesh.data_index, mesh.model_index) == (1, 2)
    assert mesh.local_rows(16) == slice(8, 16)
    assert mesh.table_rows(16) == slice(8, 12)
    feats, seq = np.arange(32).reshape(16, 2), np.arange(16)
    got = pmesh.shard_batch(mesh, feats, seq)
    assert np.array_equal(got[0], feats[8:]) and np.array_equal(got[1], seq[8:])
    with pytest.raises(ValueError, match="data axis"):
        mesh.local_rows(15)
    with pytest.raises(ValueError, match="multiple of the model axis"):
        mesh.table_rows(13)


def test_checkpoint_rows_fit_the_loading_mesh(tmp_path):
    """A table saved with one padding loads into another and into a rank's
    shard (``_fit_table``), for parameters and moments."""
    model = FHVAE(**DIMS)
    state = tstep.create_train_state(model)
    state.mu["mu2_table"].copy_(torch.arange(NUM_SEQS * 8.0).reshape(-1, 8))
    path = ckpt.save_checkpoint(
        tmp_path, model, model_type="fhvae", model_params=model.model_params(),
        run_info="t", epoch=0, best_epoch=0, best_val_lb=0.0, values={},
        extra_meta={"num_seqs": NUM_SEQS}, train_state=state)
    rank = FHVAE(**DIMS)
    rank.num_seqs_padded = 16
    rank.shard_mesh = FakeMesh((1, 4), 3)
    rank.mu2_table = torch.nn.Parameter(torch.zeros(4, 8))
    rstate = tstep.create_train_state(rank)
    ckpt.load_train_state(path, rstate)
    want = np.zeros((16, 8), np.float32)
    want[:NUM_SEQS] = model.mu2_table.detach().numpy()
    np.testing.assert_array_equal(rank.mu2_table.detach().numpy(), want[12:])
    assert (rank.mu2_table.detach().numpy()[1:] == 0).all()
    np.testing.assert_array_equal(
        rstate.mu["mu2_table"].numpy()[0],
        state.mu["mu2_table"].numpy()[12])


# --------------------------------------------------------- real groups


def make_batch(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    weight = np.ones(B, np.float32)
    weight[-3:] = 0.0  # padded rows, all on the last data rank
    return ((scale * rng.standard_normal((B, T, F))).astype(np.float32),
            rng.integers(0, NUM_SEQS, B).astype(np.int32),
            rng.integers(1, 9, B).astype(np.float32), weight)


@pytest.fixture(scope="module")
def reference():
    """JAX-initialised weights, the batches (the first scaled so that its
    gradient norm passes the clip at 100), JAX's noise for every step, and
    three trajectories from them: the JAX mesh-compiled step on ``(2, 2)``,
    and the port's single-device step."""
    import jax
    import jax.numpy as jnp

    from pytorch_scalablefhvae_tpu.models.fhvae import FHVAE as JaxFHVAE
    from pytorch_scalablefhvae_tpu.parallel.mesh import (
        make_mesh,
        shard_batch,
        shard_state,
    )
    from pytorch_scalablefhvae_tpu.parallel.sharded_step import (
        make_sharded_train_step,
    )
    from pytorch_scalablefhvae_tpu.train import step as jax_step
    from pytorch_scalablefhvae_tpu.train.loop import _replace_mu2_table

    jm = JaxFHVAE(use_pallas="always", lstm_pallas="never",
                  lstm_mm_dtype="float32", **DIMS)
    opt = jax_step.make_optimizer(1e-3, 0.95, 0.999)
    start = jax_step.create_train_state(jm, opt, seed=0)
    params = ckpt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         start.params))
    batches = [make_batch(s, scale=30.0 if s == 0 else 1.0)
               for s in range(STEPS)]

    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    jm_pad = dataclasses.replace(jm, num_seqs_padded=14, shard_mesh=mesh)
    jstate = _replace_mu2_table(
        jax_step.create_train_state(jm_pad, opt, seed=0),
        np.pad(np.asarray(start.params["mu2_table"]), ((0, 1), (0, 0))))
    jstate = shard_state(mesh, jstate)
    jstep = make_sharded_train_step(jm_pad, opt, ALPHA, mesh, donate=False)

    tm = FHVAE(lstm_mm_dtype="float32", **DIMS)
    tm.load_state_dict(params)
    tstate = tstep.create_train_state(tm, seed=0)
    topt = tstep.make_optimizer(1e-3, 0.95, 0.999)

    arrays = {"n_steps": STEPS,
              **{f"param.{k}": v.numpy() for k, v in params.items()}}
    jax_losses, one_losses, first_norm = [], [], None
    for i, arrs in enumerate(batches):
        k_enc, _ = jax.random.split(jax.random.fold_in(jstate.rng,
                                                       jstate.step))
        k2, k1 = jax.random.split(k_enc)
        noise = {"z2": np.asarray(jax.random.normal(k2, (B, 8), jnp.float32)),
                 "z1": np.asarray(jax.random.normal(k1, (B, 8), jnp.float32))}
        for k, a in zip(("x", "seq", "nsegs", "weight"), arrs):
            arrays[f"{k}{i}"] = a
        arrays[f"eps_z2{i}"], arrays[f"eps_z1{i}"] = noise["z2"], noise["z1"]
        jstate, jm_metrics = jstep(jstate, *shard_batch(mesh, *arrs))
        jax_losses.append(float(jm_metrics["loss"]))
        if i == 0:
            out = tm.apply(*(torch.from_numpy(a) for a in arrs[:3]),
                           sample=True, noise={k: torch.from_numpy(v)
                                               for k, v in noise.items()})
            loss, _ = tstep.loss_from_outputs(out, torch.from_numpy(arrs[3]),
                                              ALPHA)
            grads = torch.autograd.grad(loss, list(tm.parameters()))
            first_norm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
        one_losses.append(float(tstep.train_step(
            tstate, topt, *(torch.from_numpy(a) for a in arrs), ALPHA,
            noise={k: torch.from_numpy(v) for k, v in noise.items()})["loss"]))
    arrays["eval_table"] = np.random.default_rng(9).standard_normal(
        (NUM_SEQS, 8)).astype(np.float32)
    start_model = FHVAE(lstm_mm_dtype="float32", **DIMS)
    start_model.load_state_dict(params)
    return {"arrays": arrays, "jax_losses": jax_losses,
            "jax_table": np.asarray(jax.device_get(
                jstate.params["mu2_table"])),
            "one_losses": one_losses, "one": tstate, "first_norm": first_norm,
            "start_model": start_model, "batches": batches}


def run_mesh(reference, tmp_path, shape, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    np.savez(tmp_path / "in.npz", **reference["arrays"])
    world = shape[0] * shape[1]
    codes = launch.run_ranks(
        workers.train_steps, world,
        (str(tmp_path / "in.npz"), str(tmp_path), shape, DIMS, ALPHA),
        backend="gloo", device="cpu", timeout_s=60, join_timeout_s=120)
    assert codes == [0] * world
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def check_against_one_device(ranks, reference, shape):
    one = reference["one"]
    n_pad = pmesh.padded_num_seqs(NUM_SEQS, shape[1])
    want_table = one.model.mu2_table.detach().numpy()
    for r in ranks:
        np.testing.assert_allclose(r["losses"], reference["one_losses"],
                                   rtol=2e-5)
        assert r["table"].shape == (n_pad, 8)
        np.testing.assert_allclose(r["table"][:NUM_SEQS], want_table,
                                   rtol=2e-4, atol=2e-5)
        assert (r["table"][NUM_SEQS:] == 0.0).all()
        np.testing.assert_allclose(
            r["table_mu"][:NUM_SEQS], one.mu["mu2_table"].numpy(), rtol=1e-3,
            atol=1e-4 * float(one.mu["mu2_table"].abs().max()))
        assert int(r["step"]) == int(r["count"]) == STEPS
        assert bool(r["equal"])
    # the replicated leaves: the same bits on every rank, and the
    # single-device step's values (Adam moves an element by ~lr per step
    # whatever its gradient, so elements with gradients near zero may take a
    # step of another size: tests/test_torch_train_step.py)
    for k in (k for k in ranks[0] if k.startswith("param.")):
        for r in ranks[1:]:
            assert np.array_equal(r[k], ranks[0][k]), k
        diff = np.abs(ranks[0][k] - dict(
            one.model.named_parameters())[k[6:]].detach().numpy())
        assert diff.max() <= 2e-4 and (diff > 1e-5).mean() <= 0.005, k


def test_train_steps_on_2x2_match_one_device_and_jax(reference, tmp_path,
                                                     monkeypatch):
    """Four steps on four ranks, the first through the clip, with three
    weight-0 rows on the second data rank and 13 sequences padded to 14."""
    assert reference["first_norm"] > 100.0
    ranks = run_mesh(reference, tmp_path, (2, 2), monkeypatch)
    check_against_one_device(ranks, reference, (2, 2))
    np.testing.assert_allclose(ranks[0]["losses"], reference["jax_losses"],
                               rtol=2e-5)
    np.testing.assert_allclose(ranks[0]["table"], reference["jax_table"],
                               rtol=2e-4, atol=2e-5)
    assert (reference["jax_table"][NUM_SEQS:] == 0.0).all()

    # sharded eval and encode steps at the starting weights vs unsharded
    model, arrays = reference["start_model"], reference["arrays"]
    batch = [torch.from_numpy(a) for a in reference["batches"][0]]
    want = tstep.eval_step(model, *batch, ALPHA,
                           torch.from_numpy(arrays["eval_table"]))
    want_z2 = tstep.encode_step(model, batch[0]).numpy()
    for rank, r in enumerate(ranks):
        for k, v in want.items():
            np.testing.assert_allclose(r[f"eval.{k}"], float(v), rtol=2e-5,
                                       atol=1e-4, err_msg=k)
        rows = slice(8 * (rank // 2), 8 * (rank // 2) + 8)
        np.testing.assert_allclose(r["z2"], want_z2[rows], rtol=2e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_train_steps_match_one_device(reference, tmp_path, monkeypatch,
                                      shape):
    """The table sharded without data parallelism, and data parallelism
    with the whole table."""
    check_against_one_device(run_mesh(reference, tmp_path, shape,
                                      monkeypatch), reference, shape)


# ------------------------------------------------------------- the CLI

WIDTHS = ["--z1-hus", "32", "32", "--z2-hus", "32", "32", "--x-hus", "32",
          "32", "--z1-dim", "8", "--z2-dim", "8"]
RUN = "synthetic_np_fbank"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from pytorch_scalablefhvae_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
    )
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
            "--training-batch-size", "32", "--dev-batch-size", "64",
            "--exp-root", str(exp_root), "--device", "cpu", "--dist-backend",
            "gloo", "--dist-timeout", "60", *WIDTHS, *extra]


def metrics(d):
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


def assert_same_run(got, want):
    """Two runs' epochs: the first epoch's train loss to the step tests'
    2e-5; what comes after several Adam steps (later train losses, every dev
    metric) to 2e-4, the room the step tests give the parameters, since Adam
    moves an element by ~lr whatever the size of its gradient."""
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want]
    for g, w in zip(got, want):
        assert g["train_steps"] == w["train_steps"] and g["step"] == w["step"]
        np.testing.assert_allclose(g["train_loss"], w["train_loss"],
                                   rtol=2e-5 if g["epoch"] == 0 else 2e-4)
        for k in ("val_loss", "val_lower_bound", "val_log_qy"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-4, err_msg=k)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """Two epochs without a mesh, and two on ``--mesh 2,2`` (four gloo
    ranks on the CPU, started by the CLI itself)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    try:
        one, four = (tmp_path_factory.mktemp(n) for n in ("one", "four"))
        assert main(train_args(corpus, one, "--epochs", "2")) == 0
        assert main(train_args(corpus, four, "--epochs", "2", "--mesh",
                               "2,2")) == 0
    finally:
        mp.undo()
    tail = f"{RUN}/fhvae_e2_p10_a10.0"
    return one / tail, four / tail


def test_cli_mesh_run_matches_the_run_without_a_mesh(runs):
    one, four = runs
    assert_same_run(metrics(four), metrics(one))
    # rank 0 alone wrote, and it wrote the whole table: an odd number of
    # sequences padded by one row on the model axis of 2, moments included
    with np.load(four / f"fhvae_{RUN}_e1.npz") as z, \
            np.load(one / f"fhvae_{RUN}_e1.npz") as w:
        assert set(z.files) == set(w.files)
        n = w["mu2_table"].shape[0]
        assert n % 2 == 1
        for k in ("mu2_table", "adam_mu.mu2_table", "adam_nu.mu2_table"):
            assert z[k].shape == (n + 1, 8), k
            assert (z[k][n:] == 0).all()
        np.testing.assert_allclose(z["mu2_table"][:n], w["mu2_table"],
                                   rtol=2e-4, atol=2e-5)
    assert ckpt.read_checkpoint_meta(four / f"fhvae_{RUN}_e1.npz")[
        "num_seqs"] == n
    assert json.loads((four / "config.json").read_text())["train"][
        "mesh_shape"] == [2, 2]


@pytest.mark.parametrize("mesh_shape", ["1,2", "1,1"])
def test_mesh_checkpoint_resumes_on_another_mesh_and_on_one_device(
        runs, tmp_path, corpus, monkeypatch, mesh_shape):
    """Epoch 2 from the ``2,2`` run's checkpoint on two ranks and in one
    process, against epoch 2 resumed from the run without a mesh."""
    import shutil

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    one, four = runs
    dirs = {}
    for name, src, shape in (("mesh", four, mesh_shape), ("one", one, "1,1")):
        dirs[name] = tmp_path / name
        shutil.copytree(src, dirs[name])
        assert main(["train", "--dataset", "synthetic", "--preprocessed",
                     "--data-root", str(corpus), "--device", "cpu",
                     "--dist-backend", "gloo", "--dist-timeout", "60",
                     "--continue-from",
                     str(dirs[name] / f"fhvae_{RUN}_e1.npz"),
                     "--resume-override", "epochs=3", "--resume-override",
                     f"mesh_shape={shape}"]) == 0
    got, want = metrics(dirs["mesh"]), metrics(dirs["one"])
    assert [r["epoch"] for r in got] == [0, 1, 2]
    assert_same_run(got[2:], want[2:])
    with np.load(dirs["mesh"] / f"fhvae_{RUN}_e2.npz") as z, \
            np.load(dirs["one"] / f"fhvae_{RUN}_e2.npz") as w:
        n = w["mu2_table"].shape[0]
        assert z["mu2_table"].shape == (n + (mesh_shape == "1,2"), 8)
        np.testing.assert_allclose(z["mu2_table"][:n], w["mu2_table"],
                                   rtol=2e-4, atol=2e-5)


def test_jax_mesh_checkpoint_resumes_in_the_port(corpus, tmp_path):
    """A JAX run on ``--mesh 2,4`` saves its table padded to a multiple of
    4; the port resumes it on one device (padding sliced off) with JAX's step
    count."""
    from pytorch_scalablefhvae_tpu.config import (
        DataConfig,
        ExperimentConfig,
        ModelConfig,
        TrainConfig,
    )
    from pytorch_scalablefhvae_tpu.train.driver import (
        train_from_config as jax_train_from_config,
    )

    cfg = ExperimentConfig(
        data=DataConfig(dataset="synthetic", mvn_path=str(corpus / "mvn.json"),
                        training_batch_size=32, dev_batch_size=64),
        model=ModelConfig(model_type="fhvae", z1_hus=(32, 32),
                          z2_hus=(32, 32), x_hus=(32, 32), z1_dim=8, z2_dim=8,
                          use_pallas="never", lstm_pallas="never",
                          lstm_mm_dtype="float32"),
        train=TrainConfig(epochs=1, mesh_shape=(2, 4)))
    res = jax_train_from_config(cfg, corpus, tmp_path, is_preprocessed=True,
                                verbose=False)
    d = tmp_path / RUN / "fhvae_e1_p10_a10.0"
    first = d / f"fhvae_{RUN}_e0.npz"
    assert main(["train", "--dataset", "synthetic", "--preprocessed",
                 "--data-root", str(corpus), "--device", "cpu",
                 "--continue-from", str(first), "--resume-override",
                 "epochs=2", "--resume-override", "mesh_shape=1,1"]) == 0
    nxt = ckpt.read_checkpoint_meta(d / f"fhvae_{RUN}_e1.npz")
    assert nxt["step"] == 2 * int(res.state.step)
    jax_rows = np.asarray(res.state.params["mu2_table"]).shape[0]
    with np.load(d / f"fhvae_{RUN}_e1.npz") as z:
        assert z["mu2_table"].shape == (nxt["num_seqs"], 8)
        assert jax_rows == nxt["num_seqs"] + 1 and jax_rows % 4 == 0
    recs = metrics(d)
    assert recs[1]["train_loss"] < recs[0]["train_loss"]


@pytest.mark.parametrize("flags", [
    ["--mesh", "2,2", "--ckpt-backend", "orbax"],
], ids=lambda f: " ".join(f))
def test_what_still_raises_on_a_mesh(corpus, tmp_path, monkeypatch, flags):
    """Nothing is refused on a mesh any more: ``--ckpt-backend orbax``, the
    last setting that was, trains on the ranks the CLI starts itself, each
    rank writing its rows of the table (``tests/test_torch_mesh_k.py``
    checks the files), and its checkpoint loads on one device with the
    padding sliced off (hierarchical rounds run on a mesh too:
    ``tests/test_torch_mesh_hier.py``)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert main(train_args(corpus, tmp_path, *flags, "--epochs", "1")) == 0
    d = tmp_path / RUN / "fhvae_e1_p10_a10.0"
    path = ckpt.find_best_checkpoint(d)
    meta = ckpt.read_checkpoint_meta(path)
    assert path.name == f"fhvae_{RUN}_e0.orbax" and meta["table_rows"] % 2 == 0
    model = FHVAE(**{**DIMS, "input_size": meta["model_params"][0],
                     "num_seqs": meta["num_seqs"],
                     "feat_dim": meta["feat_dim"]})
    ckpt.load_params(path, model)
    assert model.mu2_table.shape[0] == meta["num_seqs"]


def test_mesh_over_the_budget_needs_host_placement(corpus, tmp_path, capfd,
                                                  monkeypatch):
    """On a mesh, ``auto`` with a store over the budget resolves to the
    streamed tier, as on one device, and trains there (rank 0 alone says
    so); ``--data-placement host`` still trains the same store.
    ``tests/test_torch_mesh_tiers.py`` holds the tiers of a mesh to each
    other and to one device."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    over = ["--mesh", "2,1", "--device-store-max-bytes", "1",
            "--stream-chunk-bytes", "200000", "--epochs", "1"]
    assert main(train_args(corpus, tmp_path / "auto", *over)) == 0
    out = capfd.readouterr().out
    assert out.count("over the device-store budget") == 1, out
    assert out.count("streaming it") == 1
    assert out.count("Training data streams through the device") == 1
    assert main(train_args(corpus, tmp_path / "host", *over,
                           "--data-placement", "host")) == 0
    for d in ("auto", "host"):
        recs = metrics(tmp_path / d / f"{RUN}/fhvae_e1_p10_a10.0")
        assert len(recs) == 1 and np.isfinite(recs[0]["train_loss"])


def test_a_rank_that_dies_ends_the_run(tmp_path, monkeypatch):
    """One rank raises while the other waits for it in a collective: the
    launcher comes back with error codes instead of waiting."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    codes = launch.run_ranks(workers.raise_in_rank_one, 2, backend="gloo",
                             device="cpu", timeout_s=20, join_timeout_s=90)
    assert codes[1] == 1 and codes[0] != 0
