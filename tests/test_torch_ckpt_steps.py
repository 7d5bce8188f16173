"""The port's step cadence (``--ckpt-every-steps``, ``--max-steps``) and
mid-epoch resume, on the CPU.

The contract of the JAX package's ``tests/test_ckpt_steps.py``: a run killed
at an optimizer step and resumed from its step checkpoint follows the
trajectory of the run that was never killed. In the port it holds bit for
bit, since each step's noise comes from ``(seed, step)`` and each tier's
batch order from ``(seed, epoch)``: every tensor of the epoch checkpoint and
the dev bound are equal. The resumed epoch's ``train_loss`` adds the
pre-kill partials to the rest, ``(prefix + suffix) / count``, a sum in
another order than the uninterrupted run's one running sum: it is held to
a relative 1e-12.

Also: the checkpoint names and their cleanup against the JAX package's; the
stopped run's step is ``max_steps`` exactly; no step checkpoint outlives
the next epoch checkpoint; a non-finite loss before a save exits 2 and
writes nothing; a resume at the cap trains nothing; ``--finetune`` ignores
the cursor; a step checkpoint written by the JAX package's
``save_checkpoint`` resumes at its cursor; ``--mesh 2,1`` on gloo; and
``--ckpt-backend orbax`` on the device tier at K = 3 and in two-epoch
hierarchical rounds (JAX ``tests/test_ckpt_steps.py``'s orbax cases),
stopped and resumed to the npz run's bits.
Tiny widths (H 16, batch 32) on 36 synthetic utterances: 7 steps an epoch.
"""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint import FileSystemReader

from pytorch_scalablefhvae_tpu.config import DataConfig, ExperimentConfig
from pytorch_scalablefhvae_tpu.features.pipeline import preprocess_data
from pytorch_scalablefhvae_tpu.train import checkpoint as jax_ckpt
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt

WIDTHS = ["--z1-hus", "16", "16", "--z2-hus", "16", "16", "--x-hus", "16",
          "16", "--z1-dim", "4", "--z2-dim", "4"]
RUN = "synthetic_np_fbank"
STEM = f"fhvae_{RUN}"
CHUNK_ROWS = 600  # the streamed case: 4 chunks of 2 batches an epoch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The mesh case starts two ranks beside the test process while other
    test processes run: every process keeps to one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    preprocess_data(ExperimentConfig(data=DataConfig(
        dataset="synthetic", synthetic_speakers=6, synthetic_utts=8)),
        root=root)
    return root


def train_args(corpus, exp_root, *extra):
    return ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(corpus), "--mvn-path", str(corpus / "mvn.json"),
            "--training-batch-size", "32", "--dev-batch-size", "64",
            "--exp-root", str(exp_root), "--device", "cpu", "--epochs", "2",
            *WIDTHS, *extra]


def run_dir(exp_root) -> Path:
    return Path(exp_root) / RUN / "fhvae_e2_p10_a10.0"


def metrics(d):
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


def step_checkpoints(d, ext: str = "npz") -> list[Path]:
    """The step checkpoints of ``d``, in (epoch, batch) order."""
    def cursor(p):
        e, b = p.stem.rsplit("_e", 1)[1].split("s")
        return int(e), int(b)

    return sorted(d.glob(f"*_e*s*.{ext}"), key=cursor)


def orbax_arrays(path: Path) -> dict[str, np.ndarray]:
    """Every tensor of an ``--ckpt-backend orbax`` directory, read whole."""
    md = FileSystemReader(str(path)).read_metadata().state_dict_metadata
    out = {k: torch.empty(tuple(v.size), dtype=v.properties.dtype)
           for k, v in md.items()}
    dcp.load(out, storage_reader=FileSystemReader(str(path)), no_dist=True)
    return {k: v.numpy() for k, v in out.items()}


def assert_same_checkpoint(a: Path, b: Path):
    with np.load(a) as x, np.load(b) as y:
        assert set(x.files) == set(y.files)
        assert any(k.startswith("adam_nu.") for k in x.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def assert_same_run(got: Path, want: Path):
    """Killed and resumed against uninterrupted: the last epoch checkpoint
    bit for bit, the dev metrics equal, ``train_loss`` to 1e-12."""
    assert_same_checkpoint(got / f"{STEM}_e1.npz", want / f"{STEM}_e1.npz")
    assert_same_metrics(got, want)


def assert_same_metrics(got: Path, want: Path):
    g, w = metrics(got), metrics(want)
    assert [r["epoch"] for r in g] == [r["epoch"] for r in w] == [0, 1]
    for a, b in zip(g, w):
        for k in ("train_steps", "step", "val_loss", "val_lower_bound",
                  "val_log_qy"):
            assert a[k] == b[k], (a["epoch"], k)
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=1e-12, atol=0)


# ---------------------------------------------------------------- naming


@pytest.mark.parametrize("name", [
    "m_run_e3.npz", "m_run_e3s40.npz", "m_run_e12s7.orbax", "m_run_e10.orbax",
    "best_model_m_run_e2.npz", "m_run_e3s40.json", "m_run.npz",
])
def test_epoch_of_as_the_jax_package(name):
    """A step checkpoint is never an epoch's: ``find_epoch_checkpoint``,
    ``find_best_checkpoint`` and ``eval`` skip it."""
    assert ckpt._epoch_of(Path(name)) == jax_ckpt._epoch_of(Path(name))
    if "s" in name.rsplit("_e", 1)[-1]:
        assert ckpt._epoch_of(Path(name)) == -1


@pytest.mark.parametrize("names,upto", [
    (["m_run_e0s3.npz", "m_run_e0s3.json", "m_run_e1s5.npz",
      "m_run_e2s4.npz", "m_run_e1.npz", "other_run_e0s3.npz"], 1),
    (["m_run_e0s3.npz", "m_run_e0s3.json", "m_run_e0.npz",
      "best_model_m_run_e0.npz", "m_run_e1s2.json"], 0),
    (["m_run_e10s1.npz", "m_run_e9s1.npz", "m_run2_e0s1.npz",
      "m_runx_e0s1.npz"], 9),
], ids=["two epochs", "best copy stays", "another run's files stay"])
def test_cleanup_mid_epoch_as_the_jax_package(tmp_path, names, upto):
    left = {}
    for pkg, mod in (("jax", jax_ckpt), ("port", ckpt)):
        d = tmp_path / pkg
        d.mkdir()
        for n in names:
            (d / n).write_text("x")
        (d / "m_run_e1s9.orbax").mkdir()
        mod.cleanup_mid_epoch(d, "m", "run", upto_epoch=upto)
        left[pkg] = sorted(p.name for p in d.iterdir())
    assert left["port"] == left["jax"]
    assert len(left["port"]) < len(names) + 1


# -------------------------------------------------------- kill and resume

CASES = {
    # name: (flags, ckpt_every, max_steps; None: epoch 0's steps + 3)
    "host K=1": (["--data-placement", "host"], 3, 10),
    "host K=3": (["--data-placement", "host", "--steps-per-dispatch", "3"],
                 3, 11),
    "device K=1": (["--data-placement", "device"], 2, 9),
    # the clamp runs: epoch 0 leaves 3 steps to the cap, so epoch 1 takes
    # a bundle of 2 (step 9), then one eager step in place of a bundle
    "device K=2": (["--data-placement", "device", "--steps-per-dispatch",
                    "2"], 4, 10),
    "stream K=2": (["--data-placement", "stream", "--stream-chunk-bytes",
                    str(CHUNK_ROWS * 80 * 4), "--steps-per-dispatch", "2"],
                   3, None),
}


@pytest.fixture(scope="module")
def uninterrupted(corpus, tmp_path_factory):
    runs = {}

    def get(name):
        if name not in runs:
            root = tmp_path_factory.mktemp("full")
            assert main(train_args(corpus, root, *CASES[name][0])) == 0
            runs[name] = run_dir(root)
        return runs[name]

    return get


def kill(corpus, exp_root, flags, every, max_steps):
    """The run stopped at ``--max-steps``: its directory and last step
    checkpoint, whose step is ``max_steps`` exactly."""
    assert main(train_args(corpus, exp_root, *flags, "--ckpt-every-steps",
                           str(every), "--max-steps", str(max_steps))) == 0
    d = run_dir(exp_root)
    last = step_checkpoints(d)[-1]
    assert ckpt.read_checkpoint_meta(last)["step"] == max_steps
    with np.load(last) as z:
        assert int(z["step"]) == int(z["adam_count"]) == max_steps
    return d, last


def resume(corpus, last: Path, *extra):
    return main(["train", "--dataset", "synthetic", "--preprocessed",
                 "--data-root", str(corpus), "--device", "cpu",
                 "--continue-from", str(last), "--resume-override",
                 "max_steps=0", *extra])


def stream_source(corpus):
    """The streamed case's source on the CPU and the training loader."""
    from pytorch_scalablefhvae_tpu_torch.config import (
        DataConfig as PortDataConfig,
        ExperimentConfig as PortExperimentConfig,
    )
    from pytorch_scalablefhvae_tpu_torch.data.stream_store import (
        StreamingDeviceSource,
    )
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

    cfg = PortExperimentConfig(data=PortDataConfig(
        dataset="synthetic", mvn_path=str(corpus / "mvn.json"),
        training_batch_size=32, dev_batch_size=64))
    loader, _ = build_loaders(cfg, corpus, True)
    return StreamingDeviceSource(loader.dataset, CHUNK_ROWS * 80 * 4, 32,
                                 torch.device("cpu")), loader


def stream_chunk_starts(corpus, epoch: int) -> list[int]:
    """The first batch of each chunk of ``epoch``'s stream schedule."""
    from pytorch_scalablefhvae_tpu_torch.train.loop import stream_seed

    src, loader = stream_source(corpus)
    loader.set_epoch(epoch)
    starts, at = [], 0
    for _, order in src.epoch_schedule(stream_seed(loader, epoch)):
        starts.append(at)
        at += -(-len(order) // 32)
    return starts


@pytest.mark.parametrize("where", ["start", "inside a chunk",
                                   "the last chunk alone", "the end"])
def test_stream_cursor_stages_only_the_chunks_ahead(corpus, where):
    """``epoch_batches(skip_batches=)``: the chunks wholly behind the
    cursor are never staged, the first one left starts at the cursor, and
    every chunk staged holds what the uninterrupted epoch's does."""
    src, _ = stream_source(corpus)
    rows = src.chunk_rows

    def staged(skip):
        out = []
        for c in src.epoch_batches(7, skip_batches=skip):
            out.append((c.start_batch, c.plan.n_batches, c.arrays[0].clone(),
                        c.arrays[1] - c.slot * rows,
                        src.data.view(2, rows, -1)[c.slot].clone()))
        return out

    full = staged(0)
    sizes = [n for _, n, *_ in full]
    assert len(sizes) == 4 and min(sizes) >= 2
    skip = {"start": 0, "inside a chunk": sizes[0] + 1,
            "the last chunk alone": sum(sizes) - 1,
            "the end": sum(sizes)}[where]
    got = staged(skip)
    ahead = [i for i in range(len(sizes)) if sum(sizes[:i + 1]) > skip]
    assert len(got) == len(ahead) == len(src.switch_waits())
    for (start, n, *arrays), i in zip(got, ahead):
        assert start == max(skip - sum(sizes[:i]), 0) and n == sizes[i]
        for a, b in zip(arrays, full[i][2:]):
            assert torch.equal(a, b)
    # a stop inside a chunk closes the generator: its filler thread ends
    chunks = src.epoch_batches(7, skip_batches=skip)
    next(chunks, None)
    chunks.close()


@pytest.mark.parametrize("case", list(CASES))
def test_killed_and_resumed_equals_uninterrupted(corpus, tmp_path, capsys,
                                                 uninterrupted, case):
    flags, every, max_steps = CASES[case]
    full = uninterrupted(case)
    n0 = int(metrics(full)[0]["train_steps"])
    assert n0 == metrics(full)[1]["train_steps"] >= 7
    if max_steps is None:
        max_steps = n0 + 3
    d, last = kill(corpus, tmp_path, flags, every, max_steps)
    out = capsys.readouterr().out
    assert f"Reached --max-steps {max_steps} at epoch 1" in out
    # epoch 0's step checkpoints went with its epoch checkpoint; the kill
    # left epoch 1's, its dev pass and epoch checkpoint not run
    assert all("_e1s" in p.name for p in step_checkpoints(d))
    assert not (d / f"{STEM}_e1.npz").exists()
    assert [r["epoch"] for r in metrics(d)] == [0]
    meta = ckpt.read_checkpoint_meta(last)
    mid = meta["mid_epoch"]
    assert mid["epoch"] == 1 and mid["batches_done"] == max_steps - n0
    assert last.name == f"{STEM}_e1s{mid['batches_done']}.npz"
    assert not (d / f"best_model_{last.name}").exists()

    assert resume(corpus, last) == 0
    out = capsys.readouterr().out
    assert f"mid-epoch at batch {mid['batches_done']}" in out
    if case.startswith("stream"):
        starts = stream_chunk_starts(corpus, 1)
        assert mid["batches_done"] not in starts  # inside a chunk
        behind = sum(s + 2 <= mid["batches_done"] for s in starts)
        assert behind >= 1
        assert (f"staged {len(starts) - behind} of {len(starts)} chunks"
                in out)
    assert_same_run(d, full)
    assert step_checkpoints(d) == []


def test_nan_gate_writes_no_step_checkpoint(corpus, tmp_path):
    """A run whose last dispatch before the cap diverges exits 2 and
    saves nothing: the lag-one loss read would see that dispatch only after
    the save, so the save reads it first."""
    assert main(train_args(corpus, tmp_path, "--data-placement", "host",
                           "--steps-per-dispatch", "4", "--max-steps", "4",
                           "--learning-rate", "1e18")) == 2
    assert list(run_dir(tmp_path).glob(f"{STEM}_e*")) == []


def test_resume_at_the_cap_trains_nothing(corpus, tmp_path, capsys):
    d, last = kill(corpus, tmp_path, ["--data-placement", "host"], 3, 5)
    before = {p.name: p.read_bytes() for p in d.iterdir()}
    assert main(["train", "--dataset", "synthetic", "--preprocessed",
                 "--data-root", str(corpus), "--device", "cpu",
                 "--continue-from", str(last)]) == 0
    assert "--max-steps 5 already reached at restore (step 5)" in \
        capsys.readouterr().out
    after = {p.name: p.read_bytes() for p in d.iterdir()}
    assert after.keys() == before.keys()
    for name in before:
        if name != "config.json":
            assert after[name] == before[name], name


def test_finetune_ignores_the_cursor(corpus, tmp_path, capsys):
    d, last = kill(corpus, tmp_path / "kill", ["--data-placement", "host"],
                   3, 10)
    capsys.readouterr()
    assert main(train_args(corpus, tmp_path / "ft", "--continue-from",
                           str(last), "--finetune", "--resume-override",
                           "max_steps=0")) == 0
    assert "mid-epoch at batch" not in capsys.readouterr().out
    ft = next((tmp_path / "ft").glob(f"{RUN}/*/metrics.jsonl")).parent
    recs = metrics(ft)
    assert [r["epoch"] for r in recs] == [0, 1]
    n = recs[0]["train_steps"]
    assert recs[1]["train_steps"] == n and recs[1]["step"] == 2 * n


def test_jax_written_step_checkpoint_resumes_at_its_cursor(
        corpus, tmp_path, uninterrupted):
    """The killed run's step checkpoint, rewritten by the JAX package's
    ``save_checkpoint`` (a ``TrainState``'s leaves, ``extra_meta`` with
    ``mid_epoch``, ``suffix="s<B>"``): the port resumes it at its cursor and
    trains exactly the rest of the epoch, to the uninterrupted run's
    bits."""
    from pytorch_scalablefhvae_tpu.config import ModelConfig
    from pytorch_scalablefhvae_tpu.models.base import build_model as jax_build
    from pytorch_scalablefhvae_tpu.train import step as jax_step

    flags, every, max_steps = CASES["device K=1"]
    d, last = kill(corpus, tmp_path / "kill", flags, every, max_steps)
    meta = ckpt.read_checkpoint_meta(last)
    jm = jax_build("fhvae", meta["model_params"][0], ModelConfig(
        z1_hus=(16, 16), z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4, z2_dim=4,
        use_pallas="never", lstm_pallas="never", lstm_mm_dtype="float32"),
        meta["num_seqs"], feat_dim=meta["feat_dim"])
    template = jax_step.create_train_state(
        jm, jax_step.make_optimizer(1e-3, 0.95, 0.999), seed=0)
    leaves, treedef = jax.tree_util.tree_flatten(template)
    with np.load(last) as z:
        names = ckpt.jax_leaf_names(
            [k for k in z.files if not k.startswith(("adam_", "step"))])
        ours = ([z[n] for n in names] + [np.int32(z["adam_count"])]
                + [z["adam_mu." + n] for n in names]
                + [z["adam_nu." + n] for n in names]
                + [np.int32(z["step"]), leaves[-1]])
    assert [np.shape(a) for a in ours] == [np.shape(a) for a in leaves]
    jdir = tmp_path / "jax_written"
    jdir.mkdir()
    shutil.copyfile(d / "config.json", jdir / "config.json")
    mid = meta["mid_epoch"]
    written = jax_ckpt.save_checkpoint(
        jdir, jax.tree_util.tree_unflatten(treedef, ours),
        model_type="fhvae", model_params=tuple(meta["model_params"]),
        run_info=RUN, epoch=1, best_epoch=meta["best_epoch"],
        best_val_lb=meta["best_val_lb"], values=meta["values"],
        extra_meta={k: meta[k] for k in ("num_seqs", "feat_dim", "seg_len",
                                         "corpus_fingerprint")}
        | {"mid_epoch": {"epoch": 1, "batches_done": mid["batches_done"],
                         "loss_sum": mid["loss_sum"],
                         "count_sum": float(mid["count_sum"]),
                         "elapsed_s": mid["elapsed_s"]}},
        suffix=f"s{mid['batches_done']}")
    assert written.name == last.name
    assert "format" not in ckpt.read_checkpoint_meta(written)
    shutil.copyfile(d / "metrics.jsonl", jdir / "metrics.jsonl")
    assert resume(corpus, written) == 0
    full = uninterrupted("device K=1")
    assert_same_run(jdir, full)
    assert metrics(jdir)[1]["train_steps"] == metrics(full)[1]["train_steps"]


def test_mesh_killed_and_resumed(corpus, tmp_path, monkeypatch):
    """``--mesh 2,1`` on gloo: every rank takes the same save and stop
    decisions and rank 0 writes; killed and resumed equals uninterrupted,
    and the step checkpoint also resumes on one device."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    mesh = ["--mesh", "2,1", "--dist-backend", "gloo", "--dist-timeout", "60"]
    assert main(train_args(corpus, tmp_path / "full", *mesh)) == 0
    full = run_dir(tmp_path / "full")
    d, last = kill(corpus, tmp_path / "kill", mesh, 3, 10)
    one = tmp_path / "one"
    shutil.copytree(d, one)
    assert resume(corpus, last, "--dist-backend", "gloo",
                  "--dist-timeout", "60") == 0
    assert_same_run(d, full)
    assert step_checkpoints(d) == []

    assert resume(corpus, one / last.name, "--resume-override",
                  "mesh_shape=1,1") == 0
    got, want = metrics(one), metrics(full)
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for k in ("train_loss", "val_lower_bound"):
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=2e-4,
                                   err_msg=k)
    assert step_checkpoints(one) == []


ORBAX_CASES = {
    # name: (flags, ckpt_every, max_steps; None: epoch 0's steps + 1)
    "device K=3": (["--data-placement", "device", "--steps-per-dispatch",
                    "3"], 2, 9),
    # the kill lands in the round's second epoch: the resume rebuilds the
    # round's draw and keeps the restored table
    "hierarchical two-epoch rounds": (
        ["--hierarchical", "--num-hierarchical-sequences", "6",
         "--hierarchical-round-epochs", "2", "--training-batch-size", "8"],
        2, None),
}


@pytest.mark.parametrize("case", list(ORBAX_CASES))
def test_orbax_killed_and_resumed_equals_the_npz_run(corpus, tmp_path,
                                                     capsys, case):
    """``--ckpt-backend orbax`` stopped by ``--max-steps`` and resumed from
    its last step directory: every tensor of its epoch-1 checkpoint equals
    the npz backend's uninterrupted run's bit for bit, and its metrics as
    :func:`assert_same_run` holds them; no step directory or sidecar is
    left."""
    flags, every, max_steps = ORBAX_CASES[case]
    assert main(train_args(corpus, tmp_path / "npz", *flags)) == 0
    full = run_dir(tmp_path / "npz")
    n0 = int(metrics(full)[0]["train_steps"])
    if max_steps is None:
        max_steps = n0 + 1
    assert main(train_args(corpus, tmp_path / "orbax", *flags,
                           "--ckpt-backend", "orbax", "--ckpt-every-steps",
                           str(every), "--max-steps", str(max_steps))) == 0
    d = run_dir(tmp_path / "orbax")
    last = step_checkpoints(d, "orbax")[-1]
    assert last.name == f"{STEM}_e1s{max_steps - n0}.orbax"
    stopped = orbax_arrays(last)
    assert int(stopped["step"]) == int(stopped["adam_count"]) == max_steps
    assert not (d / f"{STEM}_e1.orbax").exists()
    pointer = json.loads((d / "best_model_pointer.json").read_text())
    assert Path(pointer["path"]).name == f"{STEM}_e0.orbax"  # an epoch's
    capsys.readouterr()
    assert resume(corpus, last) == 0
    assert f"mid-epoch at batch {max_steps - n0}" in capsys.readouterr().out
    got = orbax_arrays(d / f"{STEM}_e1.orbax")
    with np.load(full / f"{STEM}_e1.npz") as z:
        assert set(got) == set(z.files)
        for k in z.files:
            np.testing.assert_array_equal(got[k], z[k], err_msg=k)
    assert_same_metrics(d, full)
    assert step_checkpoints(d, "orbax") == step_checkpoints(d, "json") == []
