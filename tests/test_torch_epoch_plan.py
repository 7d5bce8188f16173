"""The port's on-device epoch plans (``train --epoch-plan device``), on the
CPU.

The planner (``data/device_store.py`` ``make_device_epoch_plan``) derives an
epoch's segment schedule on the device from the per-sequence first frames
and window counts and a seeded generator, instead of uploading the host
loader's plan. Any uniform permutation is an epoch order: the shuffle is
``torch.randperm`` and does not reproduce ``jax.random``'s bits.

Limits and their reasons:
- unshuffled, the plan against the JAX planner and against the host plan of
  ``np.arange``: equal element for element (integer arithmetic);
- shuffled: a permutation of the unshuffled plan's real rows, the padding
  ``(0, 0)`` at the tail, the same seed the same plan, two epochs two
  orders;
- through the CLI (tiny widths, batch 8): K = 3 against K = 1, a run killed
  mid-epoch and resumed against the run never killed, and hierarchical
  rounds at K = 3 against K = 1, bit for bit (the folded train loss of a
  resumed epoch to 1e-12, as ``tests/test_torch_ckpt_steps.py`` holds it);
  the host loader and the streamed tier ignore the flag with the JAX
  package's note and train their own plans bit for bit; random windows
  raise the JAX package's ``ValueError``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.config import DataConfig, ExperimentConfig
from pytorch_scalablefhvae_tpu.data.device_store import (
    make_device_epoch_plan as jax_make_plan,
)
from pytorch_scalablefhvae_tpu.features.pipeline import preprocess_data
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.data.device_store import (
    DeviceDataSource,
    DeviceEpochPlanner,
    build_epoch_plan,
    make_device_epoch_plan,
    plan_seed,
)
from pytorch_scalablefhvae_tpu_torch.data.feature_store import FeatureStore
from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset

CPU = torch.device("cpu")
WIDTHS = ["--z1-hus", "16", "16", "--z2-hus", "16", "16", "--x-hus", "16",
          "16", "--z1-dim", "4", "--z2-dim", "4"]
RUN = "synthetic_np_fbank"
NOTE = "epoch_plan=device ignored: training data is "


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CLI runs here train on the CPU while other test processes run:
    every process keeps to one torch thread, so that none waits for a
    core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def dataset(lens=(21, 40, 57, 20, 95, 33), seg_shift=8):
    rng = np.random.default_rng(0)
    store = FeatureStore.from_arrays({f"u{i}": rng.standard_normal(
        (n, 3)).astype(np.float32) for i, n in enumerate(lens)})
    return SegmentDataset(store, seg_len=20, seg_shift=seg_shift)


@pytest.mark.parametrize("pad", [0, 5, 11])
@pytest.mark.parametrize("seg_shift", [8, 3])
def test_unshuffled_plan_equals_jax_and_the_host_plan(pad, seg_shift):
    ds = dataset(seg_shift=seg_shift)
    n_real, n_rows = len(ds), len(ds) + pad
    starts = np.asarray(ds.store.seq_starts, np.int32)
    nsegs = np.asarray(ds.nsegs, np.int32)
    seq, abs_starts = make_device_epoch_plan(
        None, torch.from_numpy(starts), torch.from_numpy(nsegs), n_real,
        n_rows, seg_shift, shuffle=False)
    fn = jax_make_plan(ds.num_seqs, n_rows, seg_shift, shuffle=False)
    want_seq, want_starts = fn(jax.random.PRNGKey(0), jnp.asarray(starts),
                               jnp.asarray(nsegs), np.int32(n_real))
    np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))
    np.testing.assert_array_equal(abs_starts.numpy(), np.asarray(want_starts))
    host = build_epoch_plan(ds, np.arange(n_real), 1, pad_rows=n_rows)
    np.testing.assert_array_equal(seq.numpy(), host.seq_idx)
    np.testing.assert_array_equal(abs_starts.numpy(), host.abs_starts)
    assert seq.dtype == abs_starts.dtype == torch.long


def test_padded_sequences_contribute_no_rows():
    """A round's vectors padded with sequences of no window (a staged
    round's ``pad_seqs``) leave the plan as it was."""
    ds = dataset()
    starts = torch.from_numpy(np.asarray(ds.store.seq_starts, np.int64))
    nsegs = torch.from_numpy(np.asarray(ds.nsegs, np.int64))
    plain = make_device_epoch_plan(None, starts, nsegs, len(ds), len(ds) + 4,
                                   8, shuffle=False)
    padded = make_device_epoch_plan(
        None, torch.cat([starts, torch.zeros(3, dtype=torch.long)]),
        torch.cat([nsegs, torch.zeros(3, dtype=torch.long)]), len(ds),
        len(ds) + 4, 8, shuffle=False)
    for a, b in zip(plain, padded):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="do not fit"):
        make_device_epoch_plan(None, starts, nsegs, len(ds), len(ds) - 1, 8)


def test_shuffled_plan_is_a_permutation_with_the_padding_at_the_tail():
    ds = dataset()
    n_real, n_rows = len(ds), len(ds) + 7
    source = DeviceDataSource(ds.store, CPU)
    planner = DeviceEpochPlanner(source, seed=3, seg_shift=8, n_rows=n_rows)
    planner.stage(ds)
    base = build_epoch_plan(ds, np.arange(n_real), 1)
    want = sorted(zip(base.seq_idx.tolist(), base.abs_starts.tolist()))
    plans = {}
    for epoch in (0, 1, 0):
        plan, (seq, starts, nsegs_tab) = planner.plan(epoch, n_real, 8)
        assert plan.n_real == n_real and plan.n_batches == -(-n_real // 8)
        assert seq.shape == starts.shape == (n_rows,)
        real = list(zip(seq[:n_real].tolist(), starts[:n_real].tolist()))
        assert sorted(real) == want
        assert (seq[n_real:] == 0).all() and (starts[n_real:] == 0).all()
        np.testing.assert_array_equal(nsegs_tab.numpy(), ds.nsegs)
        if epoch in plans:
            assert real == plans[epoch]  # the same seed, the same plan
        plans[epoch] = real
    assert plans[0] != plans[1] and plans[0] != want
    assert plan_seed(3, 1) != plan_seed(3, 0) != plan_seed(4, 0)


# ------------------------------------------------------------------ CLI


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    preprocess_data(ExperimentConfig(data=DataConfig(
        dataset="synthetic", synthetic_speakers=6, synthetic_utts=6)),
        root=root)
    return root


def train_args(corpus, exp_root, *extra, model="simple_fhvae"):
    return ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(corpus), "--mvn-path", str(corpus / "mvn.json"),
            "--training-batch-size", "8", "--dev-batch-size", "64",
            "--exp-root", str(exp_root), "--device", "cpu", "--epochs", "2",
            "--model-type", model, *WIDTHS, *extra]


def run_dir(exp_root, model="simple_fhvae") -> Path:
    return Path(exp_root) / RUN / f"{model}_e2_p10_a10.0"


def metrics(d):
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


def assert_same_run(got: Path, want: Path, model="simple_fhvae",
                    loss_rtol: float = 0.0):
    last = f"{model}_{RUN}_e1.npz"
    with np.load(got / last) as a, np.load(want / last) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for g, w in zip(metrics(got), metrics(want), strict=True):
        for k in ("epoch", "train_steps", "step", "val_loss",
                  "val_lower_bound", "val_log_qy"):
            assert g[k] == w[k], k
        assert abs(g["train_loss"] - w["train_loss"]) \
            <= loss_rtol * abs(w["train_loss"])


@pytest.fixture(scope="module")
def planned(corpus, tmp_path_factory):
    """Two epochs with device plans at K = 1, and the same run's output."""
    root = tmp_path_factory.mktemp("planned")
    assert main(train_args(corpus, root, "--epoch-plan", "device")) == 0
    return run_dir(root)


@pytest.mark.parametrize("model", ["simple_fhvae", "fhvae"])
def test_device_plans_at_k3_equal_k1(corpus, tmp_path, planned, model,
                                     capsys):
    """The K-step bundle reads each epoch's device plan from its persistent
    buffers: a replay that read the last epoch's plan would differ."""
    if model == "simple_fhvae":
        k1 = planned
    else:
        assert main(train_args(corpus, tmp_path / "k1", "--epoch-plan",
                               "device", model=model)) == 0
        k1 = run_dir(tmp_path / "k1", model)
    capsys.readouterr()
    assert main(train_args(corpus, tmp_path / "k3", "--epoch-plan", "device",
                           "--steps-per-dispatch", "3", model=model)) == 0
    out = capsys.readouterr().out
    assert "Epoch plans derive on the device" in out
    assert_same_run(run_dir(tmp_path / "k3", model), k1, model)


def test_device_plans_differ_from_the_host_plan(corpus, tmp_path, planned):
    assert main(train_args(corpus, tmp_path)) == 0
    host_plan = metrics(run_dir(tmp_path))
    assert [r["train_steps"] for r in host_plan] == \
        [r["train_steps"] for r in metrics(planned)]
    assert host_plan[0]["train_loss"] != metrics(planned)[0]["train_loss"]


def test_a_resumed_run_derives_the_plans_it_had(corpus, tmp_path, planned,
                                                capsys):
    """Killed at epoch 1, batch 2 and resumed in another call: the plan is
    a function of the seed and the epoch."""
    cap = int(metrics(planned)[0]["train_steps"]) + 2
    args = train_args(corpus, tmp_path, "--epoch-plan", "device",
                      "--ckpt-every-steps", "2", "--max-steps", str(cap))
    assert main(args) == 0
    exp = run_dir(tmp_path)
    stop = sorted(exp.glob("*_e1s*.npz"))
    assert [p.name for p in stop] == [f"simple_fhvae_{RUN}_e1s2.npz"]
    assert main(["train", "--dataset", "synthetic", "--preprocessed",
                 "--data-root", str(corpus), "--device", "cpu",
                 "--continue-from", str(stop[0]), "--resume-override",
                 "max_steps=0"]) == 0
    assert "mid-epoch at batch 2" in capsys.readouterr().out
    assert_same_run(exp, planned, loss_rtol=1e-12)


def test_hierarchical_rounds_plan_on_the_device(corpus, tmp_path, capsys):
    """Two one-epoch rounds of K = 6 sequences on the device tier: K = 3
    against K = 1 across the turnover, and the round's vectors staged on a
    re-entry that keeps the restored table."""
    hier = ["--epoch-plan", "device", "--hierarchical",
            "--num-hierarchical-sequences", "6"]
    runs = {}
    for k in (1, 3):
        assert main(train_args(corpus, tmp_path / f"k{k}", *hier,
                               "--steps-per-dispatch", str(k))) == 0
        runs[k] = run_dir(tmp_path / f"k{k}")
    out = capsys.readouterr().out
    assert out.count("Round at epoch 1 (6 sequences") == 2
    assert_same_run(runs[3], runs[1])
    assert main(train_args(corpus, tmp_path / "w", *hier,
                           "--hierarchical-round-epochs", "2")) == 0
    cap = int(metrics(run_dir(tmp_path / "w"))[0]["train_steps"]) + 2
    assert main(train_args(corpus, tmp_path / "r", *hier,
                           "--hierarchical-round-epochs", "2",
                           "--ckpt-every-steps", "2", "--max-steps",
                           str(cap))) == 0
    stop = sorted(run_dir(tmp_path / "r").glob("*_e1s*.npz"))
    assert len(stop) == 1
    assert main(["train", "--dataset", "synthetic", "--preprocessed",
                 "--data-root", str(corpus), "--device", "cpu",
                 "--continue-from", str(stop[0]), "--resume-override",
                 "max_steps=0"]) == 0
    assert "re-entered: the restored table kept" in capsys.readouterr().out
    assert_same_run(run_dir(tmp_path / "r"), run_dir(tmp_path / "w"),
                    loss_rtol=1e-12)


@pytest.mark.parametrize("tier,extra", [
    ("host-resident", ["--data-placement", "host"]),
    ("chunk-streamed", ["--data-placement", "stream",
                        "--stream-chunk-bytes", "40000"]),
])
def test_host_and_stream_ignore_the_flag_with_the_note(corpus, tmp_path,
                                                       capsys, tier, extra):
    assert main(train_args(corpus, tmp_path / "plain", *extra)) == 0
    capsys.readouterr()
    assert main(train_args(corpus, tmp_path / "flag", *extra,
                           "--epoch-plan", "device")) == 0
    assert NOTE + tier in capsys.readouterr().out
    assert_same_run(run_dir(tmp_path / "flag"), run_dir(tmp_path / "plain"))


def test_random_windows_raise(corpus, tmp_path):
    with pytest.raises(ValueError, match="deterministic windowing"):
        main(train_args(corpus, tmp_path, "--epoch-plan", "device",
                        "--rand-seg", "true"))
