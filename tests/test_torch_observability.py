"""The port's ``--tensorboard``, ``--log-params``, ``--visdom`` and
``--profile-dir`` on the CPU, against the JAX package.

The JAX side runs at ``lstm_pallas="never"`` with fp32 LSTM operands; both
packages train from the JAX initial parameters with the JAX noise handed
to the port's steps.

Limits and their reasons:
- the TensorBoard event files of one epoch, read back with
  ``EventAccumulator``: the scalar and histogram tags equal as sets, and
  each scalar (but the epoch's segments per second, a wall-clock rate)
  within rtol 1e-6 of the other package's and of the run's own JSONL
  record (the event file stores float32);
- a resumed run writes the epochs before it to TensorBoard again, equal to
  their JSONL records within float32 rounding;
- ``make_grad_step`` against JAX ``make_grad_step`` on the same batch, the
  same parameters and the same noise: every gradient within rtol 1e-4 /
  atol 1e-6 (fp32 sums in another order through the recurrences).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.config import DataConfig as JaxDataConfig
from pytorch_scalablefhvae_tpu.config import (
    ExperimentConfig as JaxExperimentConfig,
)
from pytorch_scalablefhvae_tpu.config import ModelConfig as JaxModelConfig
from pytorch_scalablefhvae_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_scalablefhvae_tpu.features.pipeline import preprocess_data
from pytorch_scalablefhvae_tpu.models.base import build_model as jax_build
from pytorch_scalablefhvae_tpu.train.driver import (
    train_from_config as jax_train_from_config,
)
from pytorch_scalablefhvae_tpu.train.step import (
    make_grad_step as jax_make_grad_step,
)
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train import loop, step
from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders
from pytorch_scalablefhvae_tpu_torch.train.metrics import (
    MetricHistory,
    MetricWriter,
    histogram_tag,
)

RUN = "synthetic_np_fbank"
STEM = f"fhvae_{RUN}"
WIDTHS = ["--z1-hus", "16", "16", "--z2-hus", "16", "16", "--x-hus", "16",
          "16", "--z1-dim", "4", "--z2-dim", "4"]
RTOL_SCALAR = 1e-6
RTOL_GRAD, ATOL_GRAD = 1e-4, 1e-6
HISTORY_TAGS = ("train_loss", "val_loss", "val_lower_bound", "val_log_qy")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    preprocess_data(JaxExperimentConfig(data=JaxDataConfig(
        dataset="synthetic", synthetic_speakers=6, synthetic_utts=4)),
        root=root)
    return root


def configs(corpus, tb_dir: Path):
    kw = dict(
        data=dict(dataset="synthetic", mvn_path=str(corpus / "mvn.json"),
                  training_batch_size=32, dev_batch_size=64,
                  data_placement="host"),
        model=dict(model_type="fhvae", z1_hus=(16, 16), z2_hus=(16, 16),
                   x_hus=(16, 16), z1_dim=4, z2_dim=4, use_pallas="never",
                   lstm_pallas="never", lstm_mm_dtype="float32",
                   scan_unroll=1),
        train=dict(epochs=1, tensorboard=True, log_params=True,
                   tb_log_dir=str(tb_dir)))
    return (ExperimentConfig(data=DataConfig(**kw["data"]),
                             model=ModelConfig(**kw["model"]),
                             train=TrainConfig(**kw["train"])),
            JaxExperimentConfig(data=JaxDataConfig(**kw["data"]),
                                model=JaxModelConfig(**kw["model"]),
                                train=JaxTrainConfig(**kw["train"])))


def key_noise(key, rows, model):
    """The noise ``FHVAE.apply`` draws from ``key`` with ``sample=True``."""
    k_enc, _ = jax.random.split(key)
    k2, k1 = jax.random.split(k_enc)
    return {"z2": torch.tensor(np.asarray(jax.random.normal(
                k2, (rows, model.z2_dim), jnp.float32))),
            "z1": torch.tensor(np.asarray(jax.random.normal(
                k1, (rows, model.z1_dim), jnp.float32)))}


@pytest.fixture(scope="module")
def jax_init(corpus, tmp_path_factory):
    cfg, jcfg = configs(corpus, tmp_path_factory.mktemp("unused"))
    ds = build_loaders(cfg, corpus, True)[0].dataset
    jm = jax_build("fhvae", ds.seg_len * ds.store.dim, jcfg.model,
                   ds.num_seqs, feat_dim=ds.store.dim)
    k_init, k_state = jax.random.split(jax.random.PRNGKey(0))
    return jm, jax.tree_util.tree_map(np.asarray, jm.init(k_init)), k_state


def port_from_jax(monkeypatch, jax_init):
    jm, params, k_state = jax_init
    real_build = loop.build_model

    def build_from_jax(*args, **kw):
        model = real_build(*args, **kw)
        model.load_state_dict(ckpt.params_from_jax(params))
        return model

    monkeypatch.setattr(loop, "build_model", build_from_jax)
    monkeypatch.setattr(step, "step_noise", lambda st, rows, device, mesh:
                        key_noise(jax.random.fold_in(k_state, st.step),
                                  rows, st.model))


def events(tb_dir: Path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(tb_dir), size_guidance={"scalars": 0,
                                                       "histograms": 0})
    acc.Reload()
    return acc


def metrics(d):
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


def test_tensorboard_tags_and_scalars_match_jax(corpus, tmp_path, monkeypatch,
                                                jax_init):
    """One epoch of both packages with ``--tensorboard --log-params``: the
    same scalar tags (``<run_id>/<key>`` at step 1) and histogram tags
    (every parameter and ``grads/`` every gradient, under the JAX tree's
    paths), and the same scalars."""
    cfg, jcfg = configs(corpus, tmp_path / "tb_port")
    _, jcfg = configs(corpus, tmp_path / "tb_jax")
    jax_train_from_config(jcfg, corpus, tmp_path / "jax",
                          is_preprocessed=True, verbose=False)
    port_from_jax(monkeypatch, jax_init)
    train_loader, dev_loader = build_loaders(cfg, corpus, True)
    loop.run_training(cfg, train_loader, dev_loader, tmp_path / "port",
                      device="cpu", verbose=False)
    got, want = events(tmp_path / "tb_port"), events(tmp_path / "tb_jax")
    assert set(got.Tags()["scalars"]) == set(want.Tags()["scalars"])
    assert set(got.Tags()["histograms"]) == set(want.Tags()["histograms"])
    names = ckpt.jax_leaf_names(ckpt.params_from_jax(jax_init[1]))
    assert set(got.Tags()["histograms"]) == {
        histogram_tag(n, p) for n in names for p in ("", "grads/")}
    rec, = metrics(tmp_path / "port")
    run_id = cfg.run_id()
    for tag in want.Tags()["scalars"]:
        (g,), (w,) = got.Scalars(tag), want.Scalars(tag)
        assert g.step == w.step == 1
        key = tag.removeprefix(f"{run_id}/")
        np.testing.assert_allclose(g.value, rec[key], rtol=RTOL_SCALAR,
                                   err_msg=tag)
        if key != "train_segments_per_sec":
            np.testing.assert_allclose(g.value, w.value, rtol=RTOL_SCALAR,
                                       err_msg=tag)


def test_tensorboard_replays_history_on_resume(corpus, tmp_path):
    """A run resumed after epoch 0 writes epoch 0's four history series to
    TensorBoard again at step 1, then epoch 1's at step 2."""
    args = ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(corpus), "--mvn-path",
            str(corpus / "mvn.json"), "--training-batch-size", "32",
            "--dev-batch-size", "64", "--exp-root", str(tmp_path), "--device",
            "cpu", *WIDTHS]
    assert main(args + ["--epochs", "1"]) == 0
    exp = tmp_path / RUN / "fhvae_e1_p10_a10.0"
    # the saved config wins on a resume: the flags go in as overrides
    assert main(args + ["--continue-from", str(exp / f"{STEM}_e0.npz"),
                        "--resume-override", "epochs=2",
                        "--resume-override", "tensorboard=true",
                        "--resume-override",
                        f"tb_log_dir={tmp_path / 'tb'}"]) == 0
    acc = events(tmp_path / "tb")
    recs = metrics(exp)
    run_id = ExperimentConfig.load(exp / "config.json").run_id()
    for tag in HISTORY_TAGS:
        got = acc.Scalars(f"{run_id}/{tag}")
        assert [e.step for e in got] == [1, 2]
        np.testing.assert_allclose([e.value for e in got],
                                   [r[tag] for r in recs], rtol=RTOL_SCALAR)
    assert [e.step for e in acc.Scalars(f"{run_id}/val_log_px_z")] == [2]


def test_tensorboard_missing_falls_back_to_jsonl(tmp_path, monkeypatch,
                                                 capsys):
    """Without ``torch.utils.tensorboard`` the writer says so and writes the
    JSONL alone, as the JAX writer does."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = MetricWriter(tmp_path, "run", tensorboard=True,
                     tb_log_dir=tmp_path / "tb", log_params=True)
    assert "falling back to JSONL only" in capsys.readouterr().out
    w.write_epoch(0, {"train_loss": 1.5}, params={"a": torch.ones(2)})
    w.replay_history(MetricHistory(), 1)
    w.close()
    assert metrics(tmp_path) == [{"epoch": 0, "run_id": "run",
                                  "train_loss": 1.5}]
    assert not (tmp_path / "tb").exists()


def test_visdom_curves_and_profile_trace(corpus, tmp_path, capsys):
    """``--visdom`` writes ``curves.svg`` after every epoch; ``--profile-dir``
    traces the training of epoch ``min(--profile-epoch, epochs - 1)`` alone
    into a Chrome trace that parses and holds the epoch's steps, with the
    loop's ``sfhvae.*`` spans around them (``train/trace.py``)."""
    args = ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(corpus), "--mvn-path",
            str(corpus / "mvn.json"), "--training-batch-size", "32",
            "--dev-batch-size", "64", "--exp-root", str(tmp_path), "--device",
            "cpu", *WIDTHS, "--epochs", "2", "--visdom", "--profile-dir",
            str(tmp_path / "prof"), "--profile-epoch", "7"]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert out.count(f"Wrote profiler trace to {tmp_path / 'prof'}") == 1
    exp = tmp_path / RUN / "fhvae_e2_p10_a10.0"
    svg = (exp / "curves.svg").read_text()
    assert svg.startswith("<?xml") and "</svg>" in svg
    traces = list((tmp_path / "prof").iterdir())
    run_id = ExperimentConfig.load(exp / "config.json").run_id()
    assert [p.name for p in traces] == [f"{run_id}_e1.pt.trace.json"]
    trace = json.loads(traces[0].read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    assert {"sfhvae.steps", "sfhvae.dispatch.launch", "sfhvae.loss_read"} \
        <= names


def test_grad_step_matches_jax(corpus, jax_init):
    """The gradient snapshot of one batch at the JAX initial parameters,
    with the noise of one JAX key handed to the port."""
    jm, params, _ = jax_init
    cfg, _ = configs(corpus, Path("unused"))
    loader = build_loaders(cfg, corpus, True)[0]
    loader.set_epoch(3)
    b = next(iter(loader))
    key = jax.random.fold_in(jax.random.PRNGKey(17), 100003)
    want = jax_make_grad_step(jm, 10.0)(
        jax.tree_util.tree_map(jnp.asarray, params), b.feats, b.seq_idx,
        b.nsegs, b.weight, key)

    from pytorch_scalablefhvae_tpu_torch.models.base import build_model

    ds = loader.dataset
    model = build_model("fhvae", ds.seg_len * ds.store.dim, cfg.model,
                        ds.num_seqs, feat_dim=ds.store.dim)
    model.load_state_dict(ckpt.params_from_jax(params))
    state = step.create_train_state(model)
    got = step.make_grad_step(10.0)(
        state, *(torch.from_numpy(a) for a in (b.feats, b.seq_idx, b.nsegs,
                                               b.weight)),
        key_noise(key, b.feats.shape[0], model))
    names = ckpt.jax_leaf_names(got)
    assert list(got) == names
    for n, w in zip(names, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(got[n].numpy(), np.asarray(w),
                                   rtol=RTOL_GRAD, atol=ATOL_GRAD, err_msg=n)
    # the snapshot updates nothing
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      ckpt.params_from_jax(params)[n].numpy())


def test_snapshot_noise_is_the_epochs():
    """The snapshot's noise is a function of the seed and the epoch alone,
    apart from every step's."""
    from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE

    state = step.create_train_state(FHVAE(40, z1_hus=(8, 8), z2_hus=(8, 8),
                                          x_hus=(8, 8), z1_dim=3, z2_dim=2,
                                          feat_dim=8), seed=5)
    cpu = torch.device("cpu")
    a = step.snapshot_noise(state, 2, 4, cpu)
    b = step.snapshot_noise(state, 2, 4, cpu)
    c = step.snapshot_noise(state, 3, 4, cpu)
    s = step.step_noise(state, 4, cpu)
    assert a["z2"].shape == (4, 2) and a["z1"].shape == (4, 3)
    assert torch.equal(a["z1"], b["z1"]) and torch.equal(a["z2"], b["z2"])
    assert not torch.equal(a["z1"], c["z1"])
    assert not torch.equal(a["z1"], s["z1"])
