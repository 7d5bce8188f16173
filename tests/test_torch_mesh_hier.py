"""Hierarchical rounds on a mesh: ``train --mesh d,m --hierarchical`` on the
CPU.

Ranks are real processes (gloo on the CPU, one torch thread each), started
once for the module by ``parallel/launch.run_ranks``; what they run is
``tests/_torch_mesh_workers.py`` ``hier_rounds``, which imports no jax. The
JAX side runs in this process on the virtual CPU mesh of
``tests/conftest.py`` (its first four devices), with ``use_pallas="always"``
(the sharded Pallas entry in interpret mode) and fp32 LSTM operands, as in
``tests/test_torch_mesh_k.py``. Tiny widths (H 16, z 4), batch 4 on the
``(2, 2)`` mesh, K = 3 sequences a round, which the model axis does not
divide: the table pads to 4 rows.

- (a) ``device_map_pass_rows`` against JAX ``make_device_map_pass_rows`` on
  a subset view, on one device and on ``(2, 2)``, replicated and
  row-sharded: ``rtol 1e-5, atol 1e-6`` (``tests/test_device_data.py``'s),
  padded rows exactly 0, row-sharded equal to replicated bit for bit;
- (b) a turnover on ``(2, 2)`` against the JAX loop's (the composition of
  ``tests/test_loop.py``'s hierarchical mesh test): both resume the JAX
  run's epoch-0 checkpoint, the JAX noise handed to the port's steps; the
  new round's MAP table (host loader: fp64 sums on both sides) at ``rtol
  1e-5``, then parameters, moments and the epoch's metrics at ``rtol 1e-4,
  atol 1e-5``, ``tests/test_torch_hier.py``'s limits;
- (c) the tiers of a mesh through the CLI: staged against the host loader
  at (b)'s limits (the staged MAP init, the rows pass, sums every window in
  fp32; the host's, at ``--map-init-chunk-skip 1``, the same windows in
  fp64);
  round-staged against the device tier (views), row-sharded against
  replicated, K = 3 against K = 1 over a turnover, and a run stopped inside
  a round and resumed against the run never stopped, bit for bit (dev
  metrics to ``1e-5`` where one run's dev split is staged and the other's
  is not); ``--epoch-plan device``: every rank derives the same plans;
  bfloat16 and int8 rounds run;
- (d) ``round_ceiling`` on a mesh against the JAX loop's K and ceiling
  (``train/loop.py:309-350``), replicated and row-sharded.
"""

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import _torch_mesh_workers as workers
from pytorch_scalablefhvae_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
)
from pytorch_scalablefhvae_tpu_torch.data.device_store import (
    STORE_TAIL_SLACK,
    DeviceDataSource,
)
from pytorch_scalablefhvae_tpu_torch.data.feature_store import FeatureStore
from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
from pytorch_scalablefhvae_tpu_torch.models.base import build_model
from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
from pytorch_scalablefhvae_tpu_torch.parallel import launch
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train import rounds, step
from pytorch_scalablefhvae_tpu_torch.train.device_step import (
    device_map_pass_rows,
)
from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders
from test_torch_parallel import DIMS, F, T

CPU = torch.device("cpu")
K = 3
BATCH = 4
RUN = "synthetic_np_fbank"
STEM = f"fhvae_{RUN}"
WIDTHS = ["--z1-hus", "16", "16", "--z2-hus", "16", "16", "--x-hus", "16",
          "16", "--z1-dim", "4", "--z2-dim", "4"]
RTOL, ATOL = 1e-4, 1e-5       # tests/test_torch_hier.py's limits
RTOL_TABLE = 1e-5             # a MAP table from fp64 host sums, both sides
SUB = [11, 2, 7, 4, 9]        # (a): the subset view, 5 of 13 sequences
MAP_B, SHIFT = 8, 2           # (a): the pass's batch, the windows' shift


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


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from pytorch_scalablefhvae_tpu.config import DataConfig as JaxDataConfig
    from pytorch_scalablefhvae_tpu.config import (
        ExperimentConfig as JaxExperimentConfig,
    )
    from pytorch_scalablefhvae_tpu.features.pipeline import preprocess_data

    root = tmp_path_factory.mktemp("corpus")
    preprocess_data(JaxExperimentConfig(data=JaxDataConfig(
        dataset="synthetic", synthetic_speakers=6, synthetic_utts=8)),
        root=root)
    return root


def port_store(corpus):
    return build_loaders(ExperimentConfig(data=DataConfig(
        dataset="synthetic", mvn_path=str(corpus / "mvn.json"),
        training_batch_size=BATCH)), corpus, True)[0].dataset


def train_args(corpus, exp_root, *extra):
    return ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(corpus), "--mvn-path", str(corpus / "mvn.json"),
            "--training-batch-size", str(BATCH), "--dev-batch-size", "64",
            "--exp-root", str(exp_root), "--device", "cpu", "--epochs", "2",
            "--hierarchical", "--num-hierarchical-sequences", str(K),
            "--mesh", "2,2", *WIDTHS, *extra]


def run_dir(exp_root) -> Path:
    return Path(exp_root) / RUN / "fhvae_e2_p10_a10.0"


def metrics(d):
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


def arrays(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------ (a), (b): the JAX side


def seeded_store():
    """13 sequences of 9-21 frames of ``F`` features, one array each."""
    rng = np.random.default_rng(4)
    lens = rng.integers(9, 22, 13)
    data = rng.standard_normal((int(lens.sum()), F)).astype(np.float32)
    bounds = np.cumsum([0, *lens])
    return data, lens, {f"s{i}": data[lo:hi] for i, (lo, hi) in
                        enumerate(zip(bounds[:-1], bounds[1:]))}


def jax_map_tables(seqs):
    """JAX-initialised weights and ``make_device_map_pass_rows`` over the
    subset view ``SUB`` of the store staged whole: on one device, and on
    the ``(2, 2)`` mesh replicated and row-sharded. Returns the port's
    parameters, the pass's shape and the three tables."""
    import jax

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
    from pytorch_scalablefhvae_tpu.parallel.mesh import make_mesh
    from pytorch_scalablefhvae_tpu.train.device_step import (
        make_device_map_pass_rows,
    )

    jm = JaxFHVAE(use_pallas="always", lstm_pallas="never",
                  lstm_mm_dtype="float32", **DIMS)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    port_params = ckpt.params_from_jax(params)
    # the pass reads no table; a table of 14 rows divides the model axis
    params = {**params, "mu2_table": np.pad(params["mu2_table"],
                                            ((0, 1), (0, 0)))}
    store = JaxFeatureStore.from_arrays(seqs)
    sub = store.subset([store.seq_keys[i] for i in SUB])
    ds = JaxSegmentDataset(sub, seg_len=T, seg_shift=SHIFT)
    n_batches = -(-len(ds) // MAP_B) + 1
    num_rows = len(SUB) + 1
    pz2_var = float(np.exp(jm.pz2_logvar))
    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    tables = {}
    for name, m, shard in (("one", None, False), ("mesh", mesh, False),
                           ("mesh sharded", mesh, True)):
        src = (JaxDeviceDataSource(store) if m is None else
               JaxDeviceDataSource(store, m, shard_store=shard))
        starts, nsegs, _ = src.stage_meta(ds)
        tables[name] = np.asarray(make_device_map_pass_rows(
            jm, T, SHIFT, MAP_B, n_batches, num_rows, pz2_var, m,
            shard_store=shard)(params, src.data, starts, nsegs))
    return port_params, (n_batches, num_rows, pz2_var), tables


def jax_config(corpus):
    from pytorch_scalablefhvae_tpu.config import DataConfig as JaxDataConfig
    from pytorch_scalablefhvae_tpu.config import (
        ExperimentConfig as JaxExperimentConfig,
    )
    from pytorch_scalablefhvae_tpu.config import ModelConfig as JaxModelConfig
    from pytorch_scalablefhvae_tpu.config import TrainConfig as JaxTrainConfig

    return JaxExperimentConfig(
        data=JaxDataConfig(dataset="synthetic",
                           mvn_path=str(corpus / "mvn.json"),
                           training_batch_size=BATCH, dev_batch_size=64,
                           data_placement="host"),
        model=JaxModelConfig(model_type="fhvae", z1_hus=(16, 16),
                             z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4,
                             z2_dim=4, use_pallas="always",
                             lstm_pallas="never", lstm_mm_dtype="float32"),
        train=JaxTrainConfig(epochs=2, sample_hierarchical=True,
                             num_hierarchical_sequences=K,
                             mesh_shape=(2, 2)))


def jax_turnovers(corpus, root):
    """The JAX loop's two-epoch hierarchical run on the ``(2, 2)`` mesh
    (host loader, one round an epoch): its run directory, the table of each
    turnover, and JAX's noise of the first 64 steps."""
    import jax
    import jax.numpy as jnp

    from pytorch_scalablefhvae_tpu.parallel import mesh as jax_mesh
    from pytorch_scalablefhvae_tpu.train import loop as jax_loop
    from pytorch_scalablefhvae_tpu.train.driver import (
        train_from_config as jax_train_from_config,
    )

    tables = []
    mp = pytest.MonkeyPatch()
    real_mesh, real_swap = jax_mesh.make_mesh, jax_loop._replace_mu2_table
    # the loop's mesh on the first four of conftest's eight devices
    mp.setattr(jax_mesh, "make_mesh", lambda shape=None, devices=None:
               real_mesh(shape, jax.devices()[:4]))

    def swap(state, table):
        tables.append(np.asarray(table))
        return real_swap(state, table)

    mp.setattr(jax_loop, "_replace_mu2_table", swap)
    try:
        cfg = jax_config(corpus)
        jax_train_from_config(cfg, corpus, root, is_preprocessed=True,
                              verbose=False)
    finally:
        mp.undo()
    k_state = jax.random.split(jax.random.PRNGKey(0))[1]
    noise = {}
    for s in range(64):
        k_enc, _ = jax.random.split(jax.random.fold_in(k_state, s))
        k2, k1 = jax.random.split(k_enc)
        noise[f"eps_z2{s}"] = np.asarray(jax.random.normal(
            k2, (BATCH, 4), jnp.float32))
        noise[f"eps_z1{s}"] = np.asarray(jax.random.normal(
            k1, (BATCH, 4), jnp.float32))
    return cfg.exp_dir(root), tables, noise


# ------------------------------------------------------ (c) the CLI runs


def budgets(corpus):
    """The training store's bytes, and a budget under half of them whose
    three quarters hold the K longest sequences and the slack: ``auto``
    stages each round's sub-pack there, replicated and row-sharded on a
    model axis of 2 alike."""
    store = port_store(corpus).store
    nbytes = store.data.shape[0] * store.dim * 4
    budget = nbytes // 2 - 1
    need = int(np.sort(store.lens)[-K:].sum()) + STORE_TAIL_SLACK
    assert (budget * 3 // 4) // (store.dim * 4) >= need
    return nbytes, budget


def first_round_steps(corpus) -> int:
    """Steps of an epoch of the round that starts at epoch 0."""
    full = port_store(corpus)
    keys = rounds.round_keys(full.store.seq_keys, K, 0, 0)
    return len(rounds.round_loader(full, full.store.subset(keys), BATCH, 0,
                                   0))


def cli_runs(corpus, root, budget):
    """The (c) runs, by name: two epochs, a round an epoch, each at
    ``--mesh 2,2``."""
    bud = ["--device-store-max-bytes", str(budget)]
    shard, k3 = "--shard-device-store", ["--steps-per-dispatch", "3"]
    two = ["--hierarchical-round-epochs", "2"]
    stop = first_round_steps(corpus) + 2
    flags = {
        # the host loader's MAP init over every window, as the rows pass
        # of the staged tiers takes them on a mesh
        "host": ["--data-placement", "host", "--map-init-chunk-skip", "1"],
        "device": [],
        "device sharded": [shard],
        "round": bud,
        "round sharded": [*bud, shard],
        "round K3": [*bud, *k3],
        "plan": [*bud, shard, *k3, "--epoch-plan", "device"],
        "full": [*bud, shard, *k3, *two],
        "stopped": [*bud, shard, *k3, *two, "--ckpt-every-steps", "2",
                    "--max-steps", str(stop)],
        "bf16": ["--transfer-dtype", "bfloat16", *k3],
        "int8": [*bud, shard, "--transfer-dtype", "int8"],
    }
    runs = {name: train_args(corpus, root / name.replace(" ", "_"), *f)
            for name, f in flags.items()}
    runs["resumed"] = [
        "train", "--dataset", "synthetic", "--preprocessed", "--data-root",
        str(corpus), "--device", "cpu", "--continue-from",
        str(run_dir(root / "stopped") / f"{STEM}_e1s2.npz"),
        "--resume-override", "max_steps=0"]
    return runs, stop


@pytest.fixture(scope="module")
def mesh_runs(corpus, tmp_path_factory):
    """Every rank-side piece, the ranks started once: (a)'s inputs and
    JAX tables, (b)'s JAX run (copied for the port to resume) and noise,
    (c)'s runs. Returns what the tests compare."""
    tmp = tmp_path_factory.mktemp("hier_mesh")
    data, lens, seqs = seeded_store()
    params, (n_batches, num_rows, pz2_var), map_tables = jax_map_tables(seqs)
    jax_dir, jax_tables, noise = jax_turnovers(corpus, tmp / "jax")
    port_dir = tmp / "port" / jax_dir.name
    shutil.copytree(jax_dir, port_dir)
    nbytes, budget = budgets(corpus)
    runs, stop = cli_runs(corpus, tmp / "cli", budget)
    todo = {"turnover": ["train", "--dataset", "synthetic", "--preprocessed",
                         "--data-root", str(corpus), "--device", "cpu",
                         "--continue-from", str(port_dir / f"{STEM}_e0.npz")],
            "runs": runs}
    (tmp / "runs.json").write_text(json.dumps(todo))
    np.savez(tmp / "in.npz", store_data=data, store_lens=lens,
             sub_idx=np.array(SUB), seg_len=T, seg_shift=SHIFT, batch=MAP_B,
             n_batches=n_batches, num_rows=num_rows, **noise,
             **{f"param.{k}": v.numpy() for k, v in params.items()})
    codes = launch.run_ranks(
        workers.hier_rounds, 4,
        (str(tmp / "in.npz"), str(tmp), (2, 2), DIMS, str(tmp / "runs.json")),
        backend="gloo", device="cpu", timeout_s=60, join_timeout_s=300)
    assert codes == [0] * 4
    return SimpleNamespace(
        ranks=[arrays(tmp / f"rank{r}.npz") for r in range(4)],
        map_tables=map_tables, params=params, seqs=seqs,
        map_shape=(n_batches, num_rows, pz2_var), jax_dir=jax_dir,
        jax_tables=jax_tables, port_dir=port_dir,
        runs={name: run_dir(tmp / "cli" / name.replace(" ", "_"))
              for name in runs if name != "resumed"},
        stop=stop, nbytes=nbytes, budget=budget)


# -------------------------------------------- (a) device_map_pass_rows


def test_map_pass_rows_one_device_matches_jax(mesh_runs):
    """The rows pass on one device, over the subset view's first frames in
    the whole staged store, against JAX's; the padded row exactly 0."""
    n_batches, num_rows, pz2_var = mesh_runs.map_shape
    store = FeatureStore.from_arrays(mesh_runs.seqs)
    sub = store.subset([store.seq_keys[i] for i in SUB])
    ds = SegmentDataset(sub, seg_len=T, seg_shift=SHIFT)
    model = FHVAE(lstm_mm_dtype="float32", **DIMS)
    model.load_state_dict(mesh_runs.params)
    src = DeviceDataSource(store, CPU)
    starts, nsegs = src.stage_meta(ds)
    table = device_map_pass_rows(
        model, src.data, starts, nsegs, seg_len=T, seg_shift=SHIFT,
        batch_size=MAP_B, n_batches=n_batches, num_rows=num_rows,
        pz2_var=pz2_var).numpy()
    assert table.shape == (num_rows, 8) and (table[len(SUB):] == 0).all()
    np.testing.assert_allclose(table, mesh_runs.map_tables["one"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shard", [False, True],
                         ids=["replicated", "row-sharded"])
def test_map_pass_rows_on_a_mesh_matches_jax(mesh_runs, shard):
    """On ``(2, 2)`` every rank holds the whole table, JAX's
    ``P("model", None)`` one gathered, within (a)'s limits; the row-sharded
    store gives the replicated store's bits."""
    want = mesh_runs.map_tables["mesh sharded" if shard else "mesh"]
    for r in mesh_runs.ranks:
        got = r[f"map/{shard}"]
        assert got.shape == want.shape and (got[len(SUB):] == 0).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got, r["map/False"])


# ------------------------------------------------ (b) a turnover vs JAX


def test_turnover_on_a_mesh_matches_jax(mesh_runs):
    """Both packages resume the JAX run's ``e0.npz`` on ``(2, 2)`` for
    epoch 1, a new round: the table of 3 rows padded to 4 (the padded row
    0) within ``RTOL_TABLE`` of JAX's on every rank, then the epoch's
    parameters, moments and metrics within ``RTOL``, ``ATOL``."""
    want_table = mesh_runs.jax_tables[1]
    assert want_table.shape == (4, 4) and (want_table[K:] == 0).all()
    for r in mesh_runs.ranks:
        got, = r["turnover_tables"]
        assert got.shape == (4, 4) and (got[K:] == 0).all()
        np.testing.assert_allclose(got, want_table, rtol=RTOL_TABLE,
                                   atol=1e-7)
    got = arrays(mesh_runs.port_dir / f"{STEM}_e1.npz")
    model = build_model("fhvae", 20 * 80, ModelConfig(
        z1_hus=(16, 16), z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4,
        z2_dim=4), K, feat_dim=80)
    state = step.create_train_state(model)
    ckpt.load_train_state(mesh_runs.jax_dir / f"{STEM}_e1.npz", state)
    want = {**{n: p.detach().numpy() for n, p in model.named_parameters()},
            **{f"adam_mu.{n}": v.numpy() for n, v in state.mu.items()},
            **{f"adam_nu.{n}": v.numpy() for n, v in state.nu.items()}}
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape:  # the mesh's padded table and moments
            assert g.shape == (4, 4) and (g[K:] == 0).all(), name
            g = g[:K]
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
    assert int(got["step"]) == state.step
    g, w = metrics(mesh_runs.port_dir)[-1], metrics(mesh_runs.jax_dir)[-1]
    assert g["epoch"] == w["epoch"] == 1
    for k in ("train_loss", "val_loss", "val_lower_bound", "val_log_qy"):
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# ------------------------------------------------------ (c) the tiers


def assert_close_runs(got: Path, want: Path):
    """The parameters of the two runs' last checkpoints and every metric of
    their epochs within ``RTOL``, ``ATOL`` (the moments are not held: the
    fp32 and fp64 MAP tables' 1e-8 gap grows there, as on one device)."""
    a, b = arrays(got / f"{STEM}_e1.npz"), arrays(want / f"{STEM}_e1.npz")
    assert set(a) == set(b)
    for k in a:
        if not k.startswith(("adam_", "step", "count")):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    for g, w in zip(metrics(got), metrics(want), strict=True):
        for k in ("train_loss", "val_loss", "val_lower_bound", "val_log_qy"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def assert_same_runs(got: Path, want: Path, dev_rtol: float = 0.0):
    """Both epochs' checkpoints bit for bit, the dev metrics to
    ``dev_rtol``, the train loss to 1e-12 (a resumed epoch adds its
    partials in another order)."""
    for e in (0, 1):
        a = arrays(got / f"{STEM}_e{e}.npz")
        b = arrays(want / f"{STEM}_e{e}.npz")
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=(e, k))
    for g, w in zip(metrics(got), metrics(want), strict=True):
        for k in ("train_steps", "step"):
            assert g[k] == w[k], (g["epoch"], k)
        for k in ("val_loss", "val_lower_bound", "val_log_qy"):
            np.testing.assert_allclose(g[k], w[k], rtol=dev_rtol, atol=0,
                                       err_msg=k)
        np.testing.assert_allclose(g["train_loss"], w["train_loss"],
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("tier", ["device", "round"])
def test_staged_tier_matches_host(mesh_runs, tier):
    """Two rounds on a staged tier (the device tier's views, or each round's
    sub-pack staged) against the host loader's, at (b)'s limits."""
    runs = mesh_runs.runs
    assert [r["epoch"] for r in metrics(runs[tier])] == [0, 1]
    assert_close_runs(runs[tier], runs["host"])


@pytest.mark.parametrize("got,want", [
    ("round", "device"), ("round sharded", "round"),
    ("device sharded", "device"), ("round K3", "round")],
    ids=["round-staged vs views", "row-sharded rounds vs replicated",
         "row-sharded views vs replicated", "K = 3 vs K = 1"])
def test_tiers_sharding_and_k_give_the_same_bits(mesh_runs, got, want):
    """Round-staged against the device tier's views, row-sharded against
    replicated, K = 3 against K = 1: the same windows summed in the same
    order, each turnover's MAP table the rows pass's, so every checkpoint
    array bit for bit (dev metrics to 1e-5 where one run stages its dev
    split beside the rounds and the other does not)."""
    assert_same_runs(mesh_runs.runs[got], mesh_runs.runs[want],
                     dev_rtol=RTOL_TABLE)


def test_run_stopped_inside_a_round_resumes_to_the_same_bits(mesh_runs):
    """Two-epoch rounds, row-sharded, K = 3: stopped by ``--max-steps`` two
    steps into the round's second epoch and resumed from its step
    checkpoint (re-entering the round with the restored table), against
    the run never stopped; no step checkpoint outlives the epoch."""
    runs = mesh_runs.runs
    first = int(metrics(runs["full"])[0]["train_steps"])
    assert mesh_runs.stop == first + 2 and first >= 3
    assert_same_runs(runs["stopped"], runs["full"])
    assert not list(runs["stopped"].glob(f"{STEM}_e*s*.npz"))


def test_device_plans_are_the_same_on_every_rank(mesh_runs):
    """``--epoch-plan device``: each rank derives each epoch's plan on its
    own device from the same seed; the four ranks' plans are equal."""
    plans = [r["plans"] for r in mesh_runs.ranks]
    assert plans[0].shape[0] == 2 and plans[0].shape[1] == 2
    for p in plans[1:]:
        np.testing.assert_array_equal(p, plans[0])
    recs = metrics(mesh_runs.runs["plan"])
    assert np.isfinite([r["train_loss"] for r in recs]).all()


@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_other_dtypes_run(mesh_runs, name):
    """bfloat16 rows on the device tier at K = 3, int8 rounds staged
    row-sharded: two rounds, finite."""
    for r in metrics(mesh_runs.runs[name]):
        assert np.isfinite([r["train_loss"], r["val_lower_bound"]]).all()


# ---------------------------------------------- (d) round_ceiling on a mesh


def jax_round_ceiling(store, k, max_bytes, dtype, m, shard):
    """The JAX loop's effective K and ceiling (``train/loop.py:309-350``),
    with its own constants."""
    from pytorch_scalablefhvae_tpu.data.device_store import (
        STORE_TAIL_SLACK as JAX_SLACK,
    )
    from pytorch_scalablefhvae_tpu.data.device_store import (
        staging_itemsize as jax_itemsize,
    )

    hk = min(k, store.num_seqs)
    budget = max_bytes * (m if shard and m > 1 else 1)
    budget_rows = (budget * 3 // 4) // max(store.dim * jax_itemsize(dtype), 1)
    floor = int(store.lens.max()) + JAX_SLACK
    if budget_rows < floor:
        return hk, None
    desc = np.sort(np.asarray(store.lens))[::-1][:hk]
    k_eff = int(np.searchsorted(np.cumsum(desc), int(budget_rows) - JAX_SLACK,
                                side="right"))
    return k_eff, int(desc[:k_eff].sum()) + JAX_SLACK


@pytest.mark.parametrize("shard", [False, True],
                         ids=["replicated", "row-sharded"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_round_ceiling_on_a_mesh_as_jax(corpus, capsys, shard, dtype):
    """K and the ceiling at budgets that hold no sequence, some of the K
    longest and all of them, on a ``(2, 2)`` mesh: the JAX loop's; the
    row-sharded budget counts twice; a reduced K is announced by rank 0
    alone."""
    from pytorch_scalablefhvae_tpu.data.feature_store import (
        FeatureStore as JaxFeatureStore,
    )

    store = port_store(corpus).store
    jstore = JaxFeatureStore.from_arrays(
        {k: store.sequence(i) for i, k in enumerate(store.seq_keys)})
    big_k = 12
    row = store.dim * {"int8": 1}.get(dtype, 4)
    lens = np.sort(store.lens)[::-1]
    for rows in (int(lens[0]) + 100, int(lens[:5].sum()) + STORE_TAIL_SLACK,
                 int(lens[:big_k].sum()) + STORE_TAIL_SLACK + 1):
        max_bytes = -(-rows * row * 4 // 3) // (2 if shard else 1)
        want = jax_round_ceiling(jstore, big_k, max_bytes, dtype, 2, shard)
        for rank in (1, 0):
            mesh = SimpleNamespace(shape=(2, 2), rank=rank)
            capsys.readouterr()
            got = rounds.round_ceiling("auto", store, big_k, max_bytes, dtype,
                                       verbose=False, mesh=mesh,
                                       shard_store=shard)
            assert got == want, (rows, rank)
            said = capsys.readouterr().out
            reduced = want[1] is not None and want[0] < big_k
            assert ("Hierarchical round size reduced" in said) == (
                reduced and rank == 0), (rows, rank, said)
