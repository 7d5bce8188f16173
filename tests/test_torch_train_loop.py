"""The port's ``train`` on a tiny synthetic corpus, on the CPU.

The corpus comes from the shared ``preprocess_data``; training runs through
the port's CLI (``--device cpu``: the plain versions, with the explicit
plain backward) at small widths. Checks: the loss falls and the epoch
checkpoints, the best-model copy and finite dev metrics are written; a run
resumed after one epoch equals an uninterrupted one bit for bit; the dev
pass matches the JAX package's on the same parameters and loader; a JAX
``TrainState`` checkpoint resumes in the port; divergence exits 2; every
setting not yet ported (orbax checkpoints) raises; and the port's own ``preprocess`` / ``extract``
with ``--extractor jax`` write what the JAX package's ``prepare_jax`` writes.
"""

import json

import jax
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.config import (
    DataConfig,
    ExperimentConfig,
    FeatureConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_scalablefhvae_tpu.features.pipeline import preprocess_data
from pytorch_scalablefhvae_tpu.train import loop as jax_loop
from pytorch_scalablefhvae_tpu.train import step as jax_step
from pytorch_scalablefhvae_tpu.train.driver import (
    train_from_config as jax_train_from_config,
)
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.models.base import build_model
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train import loop
from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

WIDTHS = ["--z1-hus", "16", "16", "--z2-hus", "16", "16", "--x-hus", "16",
          "16", "--z1-dim", "4", "--z2-dim", "4"]
RUN = "synthetic_np_fbank"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    cfg = ExperimentConfig(data=DataConfig(dataset="synthetic",
                                           synthetic_speakers=6,
                                           synthetic_utts=4))
    preprocess_data(cfg, root=root)
    return root


def train_args(corpus, exp_root, *extra):
    return ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(corpus), "--mvn-path", str(corpus / "mvn.json"),
            "--training-batch-size", "32", "--dev-batch-size", "64",
            "--exp-root", str(exp_root), "--device", "cpu", *WIDTHS, *extra]


def exp_dir(exp_root, epochs):
    return exp_root / RUN / f"fhvae_e{epochs}_p10_a10.0"


def metrics(d):
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def two_epochs(corpus, tmp_path_factory):
    root = tmp_path_factory.mktemp("two")
    assert main(train_args(corpus, root, "--epochs", "2")) == 0
    return exp_dir(root, 2)


def test_train_two_epochs(two_epochs):
    d = two_epochs
    recs = metrics(d)
    assert [r["epoch"] for r in recs] == [0, 1]
    assert recs[1]["train_loss"] < recs[0]["train_loss"]
    for r in recs:
        for k in ("val_loss", "val_lower_bound", "val_log_qy",
                  "train_segments_per_sec"):
            assert r[k] is not None and np.isfinite(r[k]), (k, r)
    for e in (0, 1):
        assert (d / f"fhvae_{RUN}_e{e}.npz").is_file()
    best = ckpt.find_best_checkpoint(d)
    meta = ckpt.read_checkpoint_meta(best)
    assert best.name == f"best_model_fhvae_{RUN}_e{meta['best_epoch']}.npz"
    last = ckpt.read_checkpoint_meta(d / f"fhvae_{RUN}_e1.npz")
    assert last["step"] == recs[0]["train_steps"] + recs[1]["train_steps"]


def test_resume_equals_uninterrupted_bitwise(corpus, tmp_path, two_epochs):
    assert main(train_args(corpus, tmp_path, "--epochs", "1")) == 0
    first = exp_dir(tmp_path, 1) / f"fhvae_{RUN}_e0.npz"
    assert main(train_args(corpus, tmp_path, "--continue-from", str(first),
                           "--resume-override", "epochs=2")) == 0
    resumed = exp_dir(tmp_path, 1) / f"fhvae_{RUN}_e1.npz"
    whole = two_epochs / f"fhvae_{RUN}_e1.npz"
    with np.load(resumed) as a, np.load(whole) as b:
        assert set(a.files) == set(b.files)
        assert any(k.startswith("adam_mu.") for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert metrics(exp_dir(tmp_path, 1))[-1]["train_loss"] == \
        metrics(two_epochs)[-1]["train_loss"]


def small_config(corpus, **train_kw):
    return ExperimentConfig(
        data=DataConfig(dataset="synthetic", mvn_path=str(corpus / "mvn.json"),
                        training_batch_size=32, dev_batch_size=64),
        model=ModelConfig(model_type="fhvae", z1_hus=(16, 16),
                          z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4, z2_dim=4,
                          use_pallas="never", lstm_pallas="never",
                          lstm_mm_dtype="float32"),
        train=TrainConfig(**train_kw))


def test_dev_pass_matches_jax(corpus, two_epochs):
    """MAP table and dev metrics of the port's trained weights, scored by
    both packages on the same loader."""
    cfg = small_config(corpus)
    _, dev_loader = build_loaders(cfg, corpus, True)
    best = ckpt.find_best_checkpoint(two_epochs)
    meta = ckpt.read_checkpoint_meta(best)
    tm = build_model("fhvae", meta["model_params"][0], cfg.model,
                     meta["num_seqs"], feat_dim=meta["feat_dim"])
    ckpt.load_params(best, tm)
    cpu = torch.device("cpu")
    pz2_var = 0.25
    n_dev = dev_loader.dataset.num_seqs
    table = loop.estimate_split_mu2(tm, dev_loader, n_dev, pz2_var, cpu)
    got = loop.evaluate_split(tm, dev_loader, 10.0, cpu,
                              torch.from_numpy(table))

    from pytorch_scalablefhvae_tpu.models.base import build_model as jax_build

    jm = jax_build("fhvae", meta["model_params"][0], cfg.model,
                   meta["num_seqs"], feat_dim=meta["feat_dim"])
    params = jax.tree_util.tree_map(
        jax.numpy.asarray, ckpt.params_to_jax(tm.state_dict()))
    want_table = jax_loop.estimate_split_mu2(
        jax_step.make_encode_step(jm), params, dev_loader, n_dev, pz2_var,
        z2_dim=4)
    np.testing.assert_allclose(table, want_table, rtol=1e-5, atol=1e-6)
    want = jax_loop.evaluate_split(
        jax_step.make_eval_step(jm, 10.0, with_table_override=True), params,
        dev_loader, jax.random.PRNGKey(0), table=want_table)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_jax_train_state_resumes_in_port(corpus, tmp_path):
    res = jax_train_from_config(small_config(corpus, epochs=1), corpus,
                                tmp_path, is_preprocessed=True, verbose=False)
    jax_ckpt = exp_dir(tmp_path, 1) / f"fhvae_{RUN}_e0.npz"
    jax_steps = int(res.state.step)
    assert jax_steps > 0

    # the JAX leaves land in the port's state: params, Adam moments, count
    cfg = small_config(corpus)
    meta = ckpt.read_checkpoint_meta(jax_ckpt)
    from pytorch_scalablefhvae_tpu_torch.train.step import create_train_state

    tstate = create_train_state(build_model(
        "fhvae", meta["model_params"][0], cfg.model, meta["num_seqs"],
        feat_dim=meta["feat_dim"]))
    meta = ckpt.load_train_state(jax_ckpt, tstate)
    assert meta["start_epoch"] == 1
    assert tstate.step == tstate.count == jax_steps
    leaves = jax.tree_util.tree_leaves(res.state)
    n = len(tstate.mu)
    names = ckpt.jax_leaf_names(tstate.mu)
    for i, name in enumerate(names):
        np.testing.assert_array_equal(tstate.mu[name].numpy(),
                                      np.asarray(leaves[n + 1 + i]))
        np.testing.assert_array_equal(tstate.nu[name].numpy(),
                                      np.asarray(leaves[2 * n + 1 + i]))

    # and the port's CLI continues the run for one more epoch
    assert main(train_args(corpus, tmp_path, "--continue-from", str(jax_ckpt),
                           "--resume-override", "epochs=2")) == 0
    nxt = ckpt.read_checkpoint_meta(exp_dir(tmp_path, 1) / f"fhvae_{RUN}_e1.npz")
    assert nxt["step"] == 2 * jax_steps
    assert nxt["format"] == ckpt.PORT_FORMAT


def test_divergence_exits_2(corpus, tmp_path, capsys):
    assert main(train_args(corpus, tmp_path, "--epochs", "2",
                           "--learning-rate", "1e18")) == 2
    assert "Training diverged" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--mesh", "2,1", "--ckpt-backend", "orbax"],
    ["--ckpt-backend", "orbax"], ["--lstm-pallas", "never"],
], ids=lambda f: " ".join(f))
def test_unported_flag_raises(corpus, tmp_path, monkeypatch, flags):
    """What the port refuses: ``--lstm-pallas never`` (by design: the port
    runs its kernels on cuda and their plain versions on the CPU). The
    orbax cases were refused until ``train/orbax_backend.py``; they now
    train, on one device and on a gloo mesh, into ``.orbax`` directories
    with the best pointer (``tests/test_torch_orbax.py`` holds the backend
    to the JAX package's). Every other flag runs: ``--mesh``
    (``tests/test_torch_parallel.py``) on every data tier, in every
    transfer dtype and with a store sharded over it
    (``tests/test_torch_mesh_tiers.py``), at any ``--steps-per-dispatch``
    (``tests/test_torch_mesh_k.py``), with ``--hierarchical``
    (``tests/test_torch_mesh_hier.py``); ``--steps-per-dispatch``,
    ``--data-placement stream`` and ``--transfer-dtype`` on one device:
    ``tests/test_torch_multi_step.py``, ``tests/test_torch_stream.py``;
    ``--ckpt-every-steps`` and ``--max-steps`` everywhere:
    ``tests/test_torch_ckpt_steps.py``; ``--hierarchical`` on one device:
    ``tests/test_torch_hier.py``; ``--model-type simple_fhvae``:
    ``tests/test_torch_simple_fhvae.py``; ``--epoch-plan device``:
    ``tests/test_torch_epoch_plan.py``; ``--legacy``:
    ``tests/test_torch_legacy.py``; ``--profile-dir``, ``--tensorboard``,
    ``--log-params`` and ``--visdom``:
    ``tests/test_torch_observability.py``."""
    if "--lstm-pallas" in flags:
        with pytest.raises(NotImplementedError):
            main(train_args(corpus, tmp_path, *flags))
        return
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert main(train_args(corpus, tmp_path, *flags, "--epochs", "1",
                           "--dist-backend", "gloo")) == 0
    d = exp_dir(tmp_path, 1)
    assert ckpt.find_best_checkpoint(d) == \
        (d / f"fhvae_{RUN}_e0.orbax").resolve()
    assert ckpt.read_checkpoint_meta(d / f"fhvae_{RUN}_e0.orbax")[
        "backend"] == "orbax"


@pytest.mark.parametrize("mm,h,d,form", [
    ("bfloat16", 128, 80, "tc"),    # the z2 and z1 encoders
    ("bfloat16", 128, 0, "tc"),     # the decoder: no input projection
    ("bfloat16", 64, 24, "fma"),    # another hidden width
    ("bfloat16", 128, 40, "fma"),   # an input width off the mma depth of 16
    ("bfloat16", 128, 144, "fma"),  # an input wider than the staged tile
    ("float32", 128, 80, "fma"),    # fp32 operands stay true fp32
    ("float32", 128, 0, "fma"),
    ("float32", 64, 24, "fma"),
])
def test_backward_form_follows_operand_type_and_widths(mm, h, d, form):
    """Which CUDA backward a call takes is a pure function of the operand
    type and the widths (``lstm_cuda.backward_form``)."""
    from pytorch_scalablefhvae_tpu_torch.ops import lstm_cuda

    assert lstm_cuda.backward_form(mm, h, d) == form
    with pytest.raises(ValueError):
        lstm_cuda.backward_form("float16", h, d)


@pytest.mark.parametrize("mm,h,d,form", [
    ("bfloat16", 128, 80, "tc"),    # the z2 and z1 encoders
    ("bfloat16", 128, 0, "tc"),     # the decoder: no input projection
    ("bfloat16", 128, 96, "tc"),    # any multiple of 16 up to 128
    ("float32", 128, 80, "fma"),    # fp32 operands stay true fp32
    ("bfloat16", 64, 80, "fma"),    # another hidden width
    ("bfloat16", 128, 24, "fma"),   # an input width off the mma depth of 16
])
def test_forward_form_follows_operand_type_and_widths(mm, h, d, form):
    """Which CUDA forward a call takes is a pure function of the operand
    type and the widths (``lstm_cuda.forward_form``), by the backward's
    rule."""
    from pytorch_scalablefhvae_tpu_torch.ops import lstm_cuda

    assert lstm_cuda.forward_form(mm, h, d) == form
    assert lstm_cuda.backward_form(mm, h, d) == form
    with pytest.raises(ValueError):
        lstm_cuda.forward_form("float16", h, d)


def load_split(root, split):
    """``{utt: features}`` and the two manifests' texts for one split."""
    d = root / RUN / split
    feats = {line.split()[0]: np.load(line.split()[1])
             for line in (d / "feats.scp").read_text().splitlines()}
    return feats, (d / "feats.scp").read_text(), (d / "len.scp").read_text()


@pytest.mark.parametrize("command", ["preprocess", "extract"])
def test_jax_extractor_cli_matches_prepare_jax(tmp_path, monkeypatch, command):
    """``preprocess --extractor jax --device cpu`` (and ``extract`` over the
    manifests it left) against the JAX package's ``preprocess_data`` with the
    same config: the same utterances in ``wav.scp`` order, equal frame counts,
    values within 3e-4 (float32 round-off of the two chains,
    ``tests/test_torch_fbank.py``)."""
    cfg = ExperimentConfig(
        features=FeatureConfig(extractor="jax", n_mels=24),
        data=DataConfig(dataset="synthetic", synthetic_speakers=3,
                        synthetic_utts=3))
    # relative roots, so both runs write the same paths into the manifests
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    preprocess_data(cfg, root="r")
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    flags = ["--dataset", "synthetic", "--extractor", "jax", "--mels", "24",
             "--device", "cpu"]
    assert main(["preprocess", *flags, "--data-root", "r",
                 "--synthetic-speakers", "3", "--synthetic-utts", "3"]) == 0
    if command == "extract":
        for f in (tmp_path / "port" / "r" / RUN).glob("*/*"):
            if f.suffix == ".npy" or f.name in ("feats.scp", "len.scp"):
                f.unlink()
        assert main(["extract", f"r/{RUN}", *flags]) == 0
    for split in ("train", "dev", "test"):
        got, got_scp, got_len = load_split(tmp_path / "port" / "r", split)
        want, want_scp, want_len = load_split(tmp_path / "jax" / "r", split)
        assert got_scp == want_scp and got_len == want_len and got
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], atol=3e-4, rtol=3e-4,
                                       err_msg=k)


def test_train_without_preprocessed_extracts_with_the_jax_extractor(tmp_path):
    """``train`` without ``--preprocessed``: the corpus is made and its
    features extracted inline, by the ``jax`` extractor on the run's device."""
    root = tmp_path / "data"
    args = [a for a in train_args(root, tmp_path / "exp", "--epochs", "1",
                                  "--extractor", "jax")
            if a != "--preprocessed"]
    args[args.index("--mvn-path") + 1] = str(tmp_path / "mvn.json")
    assert main(args) == 0
    assert (root / RUN / "train" / "feats.scp").exists()
    (m,) = metrics(exp_dir(tmp_path / "exp", 1))
    assert np.isfinite(m["train_loss"])
    cfg = json.loads((exp_dir(tmp_path / "exp", 1) / "config.json").read_text())
    assert cfg["features"]["extractor"] == "jax"
