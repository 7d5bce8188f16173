"""The data tiers of a mesh: ``train --mesh d,m`` on the device-resident
store, the streamed tier and the host loader, in every transfer dtype, with
and without ``--shard-device-store``.

Ranks are real processes (gloo on the CPU, one torch thread each), started
by the CLI itself or by ``parallel/launch.run_ranks`` for the gather, whose
rank side lives in ``tests/_torch_mesh_workers.py``. The JAX side runs in
this process on the virtual CPU mesh of ``tests/conftest.py``.

- (a) the row-sharded gather against JAX ``_make_gather(shard_store=True)``
  on a ``(2, 2)`` mesh, windows across the shard boundary included: equal;
- (b) ``--shard-device-store`` against the replicated store on the device
  tier and the streamed tier in float32 and int8: the same bits (metrics
  and every array of the last checkpoint);
- (c) a streamed ``--mesh 2,2`` run against the single-device streamed
  run, to ``tests/test_torch_parallel.py``'s ``assert_same_run`` limits;
- (d) a streamed mesh run stopped by ``--max-steps`` inside a chunk and
  resumed, against the run never stopped (``train_loss`` to 1e-12, all
  else bit for bit);
- (e) ``auto`` on a mesh over the budget, with and without sharding,
  against JAX ``resolve_data_mode``, and the line it prints;
- (f) ``--shard-device-store`` on one device: a no-op, the same bits.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import _torch_mesh_workers as workers
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    TrainConfig,
)
from pytorch_scalablefhvae_tpu_torch.data.device_store import (
    STORE_TAIL_SLACK,
    DeviceDataSource,
    Quantized,
    RowShard,
)
from pytorch_scalablefhvae_tpu_torch.data.stream_store import (
    StreamingDeviceSource,
    resolve_data_mode,
    resolve_tier,
)
from pytorch_scalablefhvae_tpu_torch.parallel import launch
from pytorch_scalablefhvae_tpu_torch.parallel import mesh as pmesh
from pytorch_scalablefhvae_tpu_torch.train.driver import resolve_run_config
from test_torch_parallel import WIDTHS, FakeMesh, assert_same_run

CPU = torch.device("cpu")
RUN = "synthetic_np_fbank"
STEM = f"fhvae_{RUN}"
CHUNK = 200_000   # float32 chunk bytes: three chunks of the train store
MESH = ["--mesh", "2,2", "--dist-backend", "gloo", "--dist-timeout", "60"]
DTYPES = ["float32", "bfloat16", "int8"]


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
    from pytorch_scalablefhvae_tpu_torch.features.pipeline import (
        preprocess_data,
    )

    root = tmp_path_factory.mktemp("corpus")
    preprocess_data(ExperimentConfig(data=DataConfig(
        dataset="synthetic", synthetic_speakers=9, synthetic_utts=5)),
        root=root)
    return root


def loaders(corpus):
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

    cfg = ExperimentConfig(data=DataConfig(
        dataset="synthetic", mvn_path=str(corpus / "mvn.json"),
        training_batch_size=32, dev_batch_size=64))
    return build_loaders(cfg, corpus, True)


@pytest.fixture(scope="module")
def store_bytes(corpus):
    """The training store's bytes in float32."""
    store = loaders(corpus)[0].dataset.store
    return store.data.shape[0] * store.dim * 4


def train_args(corpus, exp_root, *extra):
    return ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(corpus), "--mvn-path", str(corpus / "mvn.json"),
            "--training-batch-size", "32", "--dev-batch-size", "64",
            "--exp-root", str(exp_root), "--device", "cpu", "--epochs", "2",
            *WIDTHS, *extra]


def run_dir(exp_root):
    return exp_root / RUN / "fhvae_e2_p10_a10.0"


def metrics(d):
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


def assert_same_bits(got, want, loss_rtol=0.0):
    """Two runs' metrics (``train_loss`` to ``loss_rtol``; 0: equal) and
    every array of their last checkpoint, bit for bit."""
    g, w = metrics(got), metrics(want)
    assert [r["epoch"] for r in g] == [r["epoch"] for r in w] == [0, 1]
    for a, b in zip(g, w):
        for k in ("train_steps", "step", "val_loss", "val_lower_bound",
                  "val_log_qy"):
            assert a[k] == b[k], (a["epoch"], k)
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=loss_rtol, atol=0)
    with np.load(got / f"{STEM}_e1.npz") as x, \
            np.load(want / f"{STEM}_e1.npz") as y:
        assert set(x.files) == set(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def tier_flags(name, store_bytes):
    """The flags of each run of (b)-(d)."""
    shard = "--shard-device-store"
    f32 = ["--data-placement", "stream", "--stream-chunk-bytes", str(CHUNK)]
    int8 = ["--data-placement", "stream", "--transfer-dtype", "int8",
            "--stream-chunk-bytes", str(CHUNK // 4)]
    return {
        # the dev split on the host in both: no budget left beside the store
        "device": ["--data-placement", "device", "--device-store-max-bytes",
                   str(store_bytes)],
        "device sharded": ["--device-store-max-bytes", str(store_bytes - 1),
                           shard],
        # the dev split staged, row-sharded with the chunks
        "stream float32": f32, "stream float32 sharded": [*f32, shard],
        "stream int8": int8, "stream int8 sharded": [*int8, shard],
    }[name]


@pytest.fixture(scope="module")
def mesh_run(corpus, store_bytes, tmp_path_factory):
    """``name -> run directory`` of a two-epoch ``--mesh 2,2`` run, each
    trained once."""
    done = {}

    def get(name):
        if name not in done:
            root = tmp_path_factory.mktemp(name.replace(" ", "_"))
            assert main(train_args(corpus, root, *MESH,
                                   *tier_flags(name, store_bytes))) == 0
            done[name] = run_dir(root)
        return done[name]

    return get


# ------------------------------------------------------ no process group


class RankAt(FakeMesh):
    """A rank's position in a mesh without its groups, staging rules
    included."""

    store_rows = pmesh.Mesh.store_rows


def test_store_rows_of_a_rank():
    """A rank stages the table's rows of a store: ``[j R/m, (j+1) R/m)``."""
    mesh = RankAt((2, 4), 6)
    assert mesh.store_rows(64) == slice(32, 48) == mesh.table_rows(64)
    with pytest.raises(ValueError, match="row-sharded store rows"):
        mesh.store_rows(63)


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_sharded_source_stages_its_window(dtype):
    """61 rows on a model axis of 2: padded to 62, no tail slack on a mesh,
    rank ``(1, 1)`` stages rows 31-61 (the last one zero) and an int8
    store's scale and offset are the whole store's; without a mesh the
    replicated store and its slack, as before."""
    data = np.random.default_rng(3).standard_normal((61, 6)) \
        .astype(np.float32)
    store = SimpleNamespace(data=data)
    whole = DeviceDataSource(store, CPU, dtype)
    assert whole.rows.shape[0] == 61 + STORE_TAIL_SLACK
    src = DeviceDataSource(store, CPU, dtype, mesh=RankAt((2, 2), 3),
                           shard_store=True)
    assert isinstance(src.data, RowShard) and src.shard_store
    assert (src.data.lo, src.data.per, src.data.period) == (31, 31, 62)
    assert src.rows.shape == (31, 6)
    np.testing.assert_array_equal(src.rows[:30].float().numpy(),
                                  whole.rows[31:61].float().numpy())
    assert not src.rows[30].float().any()
    if dtype == "int8":
        assert isinstance(src.staged, Quantized)
        np.testing.assert_array_equal(src.staged.scale, whole.data.scale)
        np.testing.assert_array_equal(src.staged.offset, whole.data.offset)
    replicated = DeviceDataSource(store, CPU, dtype,
                                  mesh=RankAt((2, 2), 3))
    assert replicated.rows.shape[0] == 61 and not replicated.shard_store
    one_model_rank = DeviceDataSource(store, CPU, dtype,
                                      mesh=RankAt((2, 1), 1),
                                      shard_store=True)
    assert not one_model_rank.shard_store
    assert one_model_rank.rows.shape[0] == 61


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_sharded_chunks_fill_a_ranks_rows(corpus, dtype):
    """A streamed chunk row-sharded over a model axis of 2: ``chunk_rows``
    padded to even, the same chunks and plans, half the link bytes a rank,
    and each rank's host buffer the rows of its half of the replicated
    source's (an int8 chunk quantized whole: the same bytes and scale)."""
    ds = loaders(corpus)[0].dataset
    chunk = CHUNK // (4 if dtype == "int8" else 2 if dtype == "bfloat16"
                      else 1)
    want = StreamingDeviceSource(ds, chunk, 32, CPU, dtype)
    spec = want.chunks[1]
    want._fill(spec, 0)
    padded = want.chunk_rows + want.chunk_rows % 2
    got_bytes = 0
    for rank in (0, 1):
        got = StreamingDeviceSource(ds, chunk, 32, CPU, dtype,
                                    mesh=RankAt((1, 2), rank),
                                    shard_store=True)
        assert got.chunks == want.chunks and got.plan_rows == want.plan_rows
        assert got.chunk_rows == padded
        assert isinstance(got.data, RowShard)
        assert got.data.period == padded and got.data.per == padded // 2
        got._fill(spec, 0)
        lo = rank * padded // 2
        n = min(padded // 2, want.chunk_rows - lo)
        np.testing.assert_array_equal(got._host[0][:n].float().numpy(),
                                      want._host[0][lo:lo + n].float().numpy())
        assert not got._host[0][n:].float().any()
        if dtype == "int8":
            np.testing.assert_array_equal(got._host_q[0], want._host_q[0])
        got_bytes += got.host_bytes_per_epoch()
    extra = 2 * ds.store.dim * 4 * len(want.chunks) if dtype == "int8" else 0
    assert got_bytes == want.host_bytes_per_epoch() + extra + (
        padded - want.chunk_rows) * ds.store.dim * want.itemsize \
        * len(want.chunks)


@pytest.mark.parametrize("placement", ["auto", "device", "stream", "host"])
def test_a_mesh_takes_every_tier_dtype_and_sharding(placement):
    """A mesh takes every setting, not only a data tier's: at K = 1 or 8
    (``tests/test_torch_mesh_k.py``), with hierarchical rounds
    (``tests/test_torch_mesh_hier.py``) and with orbax checkpoints, which
    ``check_ported`` refused until ``train/orbax_backend.py`` (and with it
    ``check_ported`` itself) came: the run's config passes
    ``resolve_run_config`` unchanged."""
    for dtype in DTYPES:
        for shard in (False, True):
            for shape in ((2, 2), (1, 1)):
                for k in (1, 8):
                    for hier in (False, True):
                        cfg = ExperimentConfig(
                            data=DataConfig(data_placement=placement,
                                            transfer_dtype=dtype,
                                            shard_device_store=shard),
                            train=TrainConfig(mesh_shape=shape,
                                              steps_per_dispatch=k,
                                              sample_hierarchical=hier))
                        assert resolve_run_config(cfg, verbose=False) == cfg
    for train in (dict(sample_hierarchical=True, ckpt_backend="orbax"),
                  dict(ckpt_backend="orbax")):
        cfg = ExperimentConfig(data=DataConfig(data_placement=placement),
                               train=TrainConfig(mesh_shape=(2, 2), **train))
        assert resolve_run_config(cfg, verbose=False) == cfg


# ----------------------------------------------------------- (e) the tier


@pytest.mark.parametrize("shard", [False, True], ids=["replicated",
                                                      "row-sharded"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_auto_tier_on_a_mesh_as_jax(corpus, store_bytes, capsys, dtype,
                                    shard):
    """``auto`` on a ``(2, 2)`` mesh at budgets around the store and its
    half, against JAX ``resolve_data_mode``: row-sharded, the budget counts
    twice; the line says so."""
    from pytorch_scalablefhvae_tpu.data.stream_store import (
        resolve_data_mode as jax_resolve_data_mode,
    )

    store = loaders(corpus)[0].dataset.store
    nbytes = store_bytes * {"bfloat16": 2, "int8": 1}.get(dtype, 4) // 4
    mesh = SimpleNamespace(shape=(2, 2))
    jax_mesh = SimpleNamespace(shape={"data": 2, "model": 2})
    for max_bytes in (nbytes, nbytes - 1, nbytes // 2, nbytes // 2 - 1):
        kw = dict(shard_store=shard, max_bytes=max_bytes, store_dtype=dtype)
        want = jax_resolve_data_mode("auto", store, jax_mesh, **kw)
        assert resolve_data_mode("auto", store, mesh, **kw) == want
        capsys.readouterr()
        assert resolve_tier("auto", store, max_bytes, dtype, mesh=mesh,
                            shard_store=shard) == want
        line = capsys.readouterr().out
        budget = max_bytes * (2 if shard else 1)
        assert ("within" if nbytes <= budget else "over") in line
        assert f"budget of {budget / 1e6:.1f} MB" in line
        assert ("row-sharded over the model axis" in line) == shard
        assert ("staging it whole" if want == "device"
                else "streaming it") in line


def test_auto_over_the_budget_stages_row_sharded_on_a_mesh(
        corpus, store_bytes, tmp_path, capfd):
    """A store one byte over the budget: ``auto`` on ``--mesh 2,2`` with
    ``--shard-device-store`` stages it row-sharded (twice the budget), and
    rank 0 alone says so."""
    assert main(train_args(corpus, tmp_path, *MESH, "--epochs", "1",
                           "--device-store-max-bytes", str(store_bytes - 1),
                           "--shard-device-store")) == 0
    out = capfd.readouterr().out
    assert out.count("data placement auto") == 1
    assert ("over the device-store budget" not in out
            and "row-sharded over the model axis); staging it whole" in out)
    assert out.count("MB staged, row-sharded)") == 1


# ------------------------------------------------------------ (a) gather


@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    """61 rows (padded to 62: shards of 31), 12 windows of 10 frames, five
    of them across row 31; every rank's windows and staged rows."""
    tmp = tmp_path_factory.mktemp("gather")
    data = np.random.default_rng(11).standard_normal((61, 8)) \
        .astype(np.float32)
    starts = np.array([0, 21, 22, 25, 28, 30, 31, 40, 51, 5, 29, 26],
                      np.int32)
    np.savez(tmp / "in.npz", data=data, starts=starts, seg_len=10)
    codes = launch.run_ranks(
        workers.sharded_gather, 4, (str(tmp / "in.npz"), str(tmp), (2, 2)),
        backend="gloo", device="cpu", timeout_s=60, join_timeout_s=120)
    assert codes == [0] * 4
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return data, starts, ranks


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_gather_matches_jax(gathered, dtype):
    """Each rank's windows against JAX's ``shard_map`` gather and ``psum``
    on the same store and starts: equal values (fp32 here; JAX keeps bf16
    windows in bf16), the ranks of a model group equal, the staged rows
    JAX's shards."""
    import jax
    import jax.numpy as jnp

    from pytorch_scalablefhvae_tpu.data.device_store import (
        DeviceDataSource as JaxDeviceDataSource,
    )
    from pytorch_scalablefhvae_tpu.parallel.mesh import make_mesh
    from pytorch_scalablefhvae_tpu.train.device_step import _make_gather

    data, starts, ranks = gathered
    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    src = JaxDeviceDataSource(SimpleNamespace(data=data), mesh,
                              shard_store=True, store_dtype=dtype)
    want = np.asarray(_make_gather(10, mesh, True)(
        src.data, jnp.asarray(starts))).astype(np.float32)
    rows = np.asarray((src.data[0] if dtype == "int8" else src.data)
                      ).astype(np.float32)
    assert rows.shape[0] == 62
    for r, got in enumerate(ranks):
        i, j = divmod(r, 2)
        assert got[dtype].dtype == np.float32
        np.testing.assert_array_equal(got[dtype], want[6 * i:6 * i + 6])
        np.testing.assert_array_equal(got[f"{dtype}.rows"],
                                      rows[31 * j:31 * j + 31])


# ------------------------------------------------ (b) sharded = replicated


@pytest.mark.parametrize("tier", ["device", "stream float32", "stream int8"])
def test_sharded_equals_replicated(mesh_run, tier):
    """Two epochs on ``--mesh 2,2``: the row-sharded store (the device
    tier's, whose dev pass runs on the host; or the streamed chunks and the
    staged dev split) trains to the replicated store's bits."""
    assert_same_bits(mesh_run(f"{tier} sharded"), mesh_run(tier))


# --------------------------------------------- (c) against one device


def test_streamed_mesh_run_matches_one_device(mesh_run, corpus,
                                              store_bytes, tmp_path):
    """The streamed ``--mesh 2,2`` run against the same streamed run on
    one device, chunk switches and the staged dev split included."""
    assert main(train_args(corpus, tmp_path,
                           *tier_flags("stream float32", store_bytes))) == 0
    assert_same_run(metrics(mesh_run("stream float32")),
                    metrics(run_dir(tmp_path)))


# ------------------------------------------------- (d) stop and resume


def chunk_batches(corpus, epoch: int) -> list[int]:
    """The batch counts of ``epoch``'s chunks, in its schedule's order."""
    from pytorch_scalablefhvae_tpu_torch.train.loop import stream_seed

    loader = loaders(corpus)[0]
    src = StreamingDeviceSource(loader.dataset, CHUNK, 32, CPU)
    loader.set_epoch(epoch)
    return [-(-len(order) // 32)
            for _, order in src.epoch_schedule(stream_seed(loader, epoch))]


def test_stopped_streamed_mesh_run_resumes_to_the_same_bits(
        mesh_run, corpus, store_bytes, tmp_path):
    """The row-sharded streamed run stopped by ``--max-steps`` one batch
    into a chunk of epoch 1 that has more, then resumed: the run never
    stopped, bit for bit (``train_loss`` to 1e-12: the stopped epoch's
    partials are added in another order)."""
    n0 = sum(chunk_batches(corpus, 0))
    counts = chunk_batches(corpus, 1)
    c = next(k for k, n in enumerate(counts) if n >= 2)
    stop = n0 + sum(counts[:c]) + 1
    flags = tier_flags("stream float32 sharded", store_bytes)
    assert main(train_args(corpus, tmp_path, *MESH, *flags, "--max-steps",
                           str(stop))) == 0
    d = run_dir(tmp_path)
    last, = d.glob(f"{STEM}_e1s*.npz")
    assert last.name == f"{STEM}_e1s{stop - n0}.npz"
    assert main(["train", "--dataset", "synthetic", "--preprocessed",
                 "--data-root", str(corpus), "--device", "cpu",
                 "--dist-backend", "gloo", "--dist-timeout", "60",
                 "--continue-from", str(last), "--resume-override",
                 "max_steps=0"]) == 0
    assert not list(d.glob(f"{STEM}_e*s*.npz"))
    assert_same_bits(d, mesh_run("stream float32 sharded"), loss_rtol=1e-12)


# ------------------------------------------------------- (f) one device


def test_shard_device_store_on_one_device_is_a_no_op(corpus, tmp_path,
                                                     capsys):
    """``--shard-device-store`` without a mesh runs, stages the whole store
    and gives the bits of the run without it."""
    assert main(train_args(corpus, tmp_path / "plain")) == 0
    capsys.readouterr()
    assert main(train_args(corpus, tmp_path / "flag",
                           "--shard-device-store")) == 0
    out = capsys.readouterr().out
    assert "device-resident" in out and "row-sharded" not in out
    assert_same_bits(run_dir(tmp_path / "flag"), run_dir(tmp_path / "plain"))
