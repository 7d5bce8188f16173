"""The port's ``train --legacy`` (step epochs at batch 1) on the CPU.

``--legacy`` trains from batch-size-1 loaders (train and dev), ends each
epoch after ``--steps-per-epoch`` batches of its shuffled order and prints
the JAX loop's progress line every ``--log-interval`` batches
(``train/loop.py`` ``LegacyEpochs``). The JAX side runs at
``lstm_pallas="never"`` with fp32 LSTM operands.

Limits and their reasons:
- the loaders, the placement and the refusals against the JAX package's:
  exactly (the same batches, tiers and exception types);
- ``--steps-per-dispatch 8`` against 1 under ``--legacy``: bit for bit
  (legacy epochs run one eager step a batch, K is ignored);
- a two-epoch legacy run (``--steps-per-epoch 12``) of both packages from
  the same JAX initial parameters, the JAX noise handed to the port's
  steps: every metric and parameter within rtol 1e-4 / atol 1e-5, the
  limits ``tests/test_torch_hier.py`` holds two-epoch runs to (fp32 sums
  in another order over 24 Adam steps).
"""

import json
import re
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
from pytorch_scalablefhvae_tpu.data.stream_store import (
    resolve_data_mode as jax_resolve_data_mode,
)
from pytorch_scalablefhvae_tpu.features.pipeline import preprocess_data
from pytorch_scalablefhvae_tpu.models.base import build_model as jax_build
from pytorch_scalablefhvae_tpu.train.driver import (
    build_loaders as jax_build_loaders,
)
from pytorch_scalablefhvae_tpu.train.driver import (
    train_from_config as jax_train_from_config,
)
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_scalablefhvae_tpu_torch.data.stream_store import resolve_tier
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train import loop, step
from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

RUN = "synthetic_np_fbank"
STEM = f"fhvae_{RUN}"
WIDTHS = ["--z1-hus", "16", "16", "--z2-hus", "16", "16", "--x-hus", "16",
          "16", "--z1-dim", "4", "--z2-dim", "4"]
RTOL, ATOL = 1e-4, 1e-5
STEPS = 12
PROGRESS = re.compile(r"^====> Train Epoch: (\d+) \[(\d+)/(\d+) \((\d+)%\)\]"
                      r"\tLoss: (-?\d+\.\d{6})$", re.M)


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


def configs(corpus, **train_kw):
    """The same legacy run for both packages."""
    kw = dict(
        data=dict(dataset="synthetic", mvn_path=str(corpus / "mvn.json"),
                  training_batch_size=32, dev_batch_size=64),
        model=dict(model_type="fhvae", z1_hus=(16, 16), z2_hus=(16, 16),
                   x_hus=(16, 16), z1_dim=4, z2_dim=4, use_pallas="never",
                   lstm_pallas="never", lstm_mm_dtype="float32",
                   scan_unroll=1),
        train=dict(legacy=True, steps_per_epoch=STEPS, log_interval=5,
                   **train_kw))
    return (ExperimentConfig(data=DataConfig(**kw["data"]),
                             model=ModelConfig(**kw["model"]),
                             train=TrainConfig(**kw["train"])),
            JaxExperimentConfig(data=JaxDataConfig(**kw["data"]),
                                model=JaxModelConfig(**kw["model"]),
                                train=JaxTrainConfig(**kw["train"])))


def train_args(corpus, exp_root, *extra):
    return ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(corpus), "--mvn-path", str(corpus / "mvn.json"),
            "--training-batch-size", "32", "--dev-batch-size", "64",
            "--exp-root", str(exp_root), "--device", "cpu", "--legacy",
            "--steps-per-epoch", str(STEPS), "--log-interval", "5", *WIDTHS,
            *extra]


def legacy_dir(exp_root, epochs: int) -> Path:
    return Path(exp_root) / RUN / f"fhvae_e{epochs}_s{STEPS}_p10_a10.0_legacy"


def metrics(d):
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


def arrays(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_loaders_are_batch_one_as_jax(corpus):
    """Train and dev loaders of batch size 1, whatever the batch flags say,
    in the JAX loaders' order: the same first batches of two epochs."""
    cfg, jcfg = configs(corpus)
    got = build_loaders(cfg, corpus, True)
    want = jax_build_loaders(jcfg, data_root=corpus)
    for g, w in zip(got, want):
        assert g.batch_size == w.batch_size == 1
        assert len(g) == len(w) == len(g.dataset)
    for epoch in (0, 1):
        got[0].set_epoch(epoch)
        want[0].set_epoch(epoch)
        for a, b, _ in zip(got[0], want[0], range(4)):
            np.testing.assert_array_equal(a.feats, b.feats)
            np.testing.assert_array_equal(a.seq_idx, b.seq_idx)


@pytest.mark.parametrize("placement", ["auto", "host", "device", "stream"])
def test_placement_takes_the_host_loader(corpus, placement, capsys):
    """``auto`` (within the budget or over it) and ``host`` resolve to the
    host loader; ``device`` and ``stream`` raise the JAX package's
    ``ValueError``."""
    store = build_loaders(configs(corpus)[0], corpus, True)[0].dataset.store
    for max_bytes in (64, 1 << 30):
        try:
            want = jax_resolve_data_mode(placement, store,
                                         max_bytes=max_bytes, legacy=True)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                resolve_tier(placement, store, max_bytes, legacy=True)
            continue
        assert resolve_tier(placement, store, max_bytes, legacy=True) \
            == want == "host"
    if placement == "auto":
        assert "training from the host loader (--legacy)" in \
            capsys.readouterr().out


def test_device_placement_raises_at_the_cli(corpus, tmp_path):
    with pytest.raises(ValueError, match="legacy"):
        main(train_args(corpus, tmp_path, "--data-placement", "device"))


@pytest.fixture(scope="module")
def legacy_k1(corpus, tmp_path_factory):
    """Two legacy epochs through the CLI, and their stdout."""
    import contextlib
    import io

    root = tmp_path_factory.mktemp("k1")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(train_args(corpus, root, "--epochs", "2")) == 0
    return legacy_dir(root, 2), out.getvalue()


def test_step_epochs_and_progress_lines(legacy_k1):
    """Each epoch takes ``--steps-per-epoch`` steps of batch 1; the
    progress line comes every ``--log-interval`` batches in the JAX
    loop's format; the run trains from the host loader into its
    ``_legacy`` directory."""
    d, out = legacy_k1
    recs = metrics(d)
    assert [r["train_steps"] for r in recs] == [STEPS, STEPS]
    assert [r["step"] for r in recs] == [STEPS, 2 * STEPS]
    assert all(r["train_segments_per_sec"] > 0 for r in recs)
    lines = PROGRESS.findall(out)
    n = int(lines[0][2])
    assert [(int(e), int(s)) for e, s, *_ in lines] == \
        [(e, i) for e in (0, 1) for i in (4, 9)]
    for e, seen, total, pct, loss in lines:
        assert int(total) == n
        assert int(pct) == round(100.0 * int(seen) / n)
        assert np.isfinite(float(loss))
    assert "Training data device-resident" not in out
    assert "Dev split device-resident" not in out
    assert "steps per dispatch" not in out
    assert (d / f"{STEM}_e1.npz").is_file()


def test_k_is_ignored(corpus, tmp_path, legacy_k1):
    """``--steps-per-dispatch 8`` is accepted and ignored: the run equals
    K = 1 bit for bit."""
    assert main(train_args(corpus, tmp_path, "--epochs", "2",
                           "--steps-per-dispatch", "8")) == 0
    a = arrays(legacy_dir(tmp_path, 2) / f"{STEM}_e1.npz")
    b = arrays(legacy_k1[0] / f"{STEM}_e1.npz")
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got, want = metrics(legacy_dir(tmp_path, 2)), metrics(legacy_k1[0])
    for g, w in zip(got, want, strict=True):
        for k in ("train_loss", "val_loss", "val_lower_bound", "step"):
            assert g[k] == w[k], k


@pytest.mark.parametrize("flag", [["--ckpt-every-steps", "3"],
                                  ["--max-steps", "5"]])
def test_cadence_flags_raise(corpus, tmp_path, flag):
    with pytest.raises(ValueError, match="legacy"):
        main(train_args(corpus, tmp_path, "--epochs", "1", *flag))


def test_hierarchical_legacy_takes_the_host_loader(corpus, tmp_path, capsys):
    """``--hierarchical --legacy``: rounds from the host loader at batch 1,
    no round staging even where the store is over the budget (JAX
    ``train/loop.py:308``)."""
    assert main(train_args(
        corpus, tmp_path, "--epochs", "2", "--hierarchical",
        "--num-hierarchical-sequences", "6", "--device-store-max-bytes",
        "1000")) == 0
    out = capsys.readouterr().out
    assert "stage their subset" not in out
    assert len(re.findall(r"Round at epoch \d+ \(6 sequences", out)) == 2
    recs = metrics(legacy_dir(tmp_path, 2))
    assert [r["train_steps"] for r in recs] == [STEPS, STEPS]
    assert np.isfinite([r["val_lower_bound"] for r in recs]).all()


def test_legacy_on_a_data_axis_raises_as_jax(corpus, tmp_path):
    """``--legacy --mesh 2,1``: batch 1 does not split over a data axis of
    2. The JAX loop raises ``ValueError`` at its first step's
    ``device_put`` (here on a ``(2, 4)`` mesh of the 8 CPU devices the
    tests give JAX); the port raises the same type before the ranks
    start."""
    _, jcfg = configs(corpus, epochs=1, mesh_shape=(2, 4))
    with pytest.raises(ValueError, match="divisible by 2"):
        jax_train_from_config(jcfg, corpus, tmp_path / "jax",
                              is_preprocessed=True, verbose=False)
    for mesh in ("2,1", "2,4"):
        with pytest.raises(ValueError, match=r"data axis \(2\) must divide"):
            main(train_args(corpus, tmp_path / "port", "--epochs", "1",
                            "--mesh", mesh, "--dist-backend", "gloo"))


def jax_noise(rng, step_no, model, rows):
    """The noise ``FHVAE.apply`` draws inside JAX's step number ``step_no``."""
    k_enc, _ = jax.random.split(jax.random.fold_in(rng, step_no))
    k2, k1 = jax.random.split(k_enc)
    return {"z2": torch.tensor(np.asarray(jax.random.normal(
                k2, (rows, model.z2_dim), jnp.float32))),
            "z1": torch.tensor(np.asarray(jax.random.normal(
                k1, (rows, model.z1_dim), jnp.float32)))}


def test_two_legacy_epochs_match_jax(corpus, tmp_path, monkeypatch):
    """Two legacy epochs of both packages' ``run_training`` from the JAX
    initial parameters, the port's steps fed the JAX noise: every metric
    of both epochs and the final parameters."""
    cfg, jcfg = configs(corpus, epochs=2)
    res = jax_train_from_config(jcfg, corpus, tmp_path / "jax",
                                is_preprocessed=True, verbose=False)
    train_loader, dev_loader = build_loaders(cfg, corpus, True)
    ds = train_loader.dataset
    jm = jax_build("fhvae", ds.seg_len * ds.store.dim, jcfg.model,
                   ds.num_seqs, feat_dim=ds.store.dim)
    k_init, k_state = jax.random.split(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jm.init(k_init))
    real_build = loop.build_model

    def build_from_jax(*args, **kw):
        model = real_build(*args, **kw)
        model.load_state_dict(ckpt.params_from_jax(params))
        return model

    monkeypatch.setattr(loop, "build_model", build_from_jax)
    monkeypatch.setattr(step, "step_noise", lambda st, rows, device, mesh:
                        jax_noise(k_state, st.step, st.model, rows))
    got = loop.run_training(cfg, train_loader, dev_loader, tmp_path / "port",
                            device="cpu", verbose=False)
    assert got.state.step == int(res.state.step) == 2 * STEPS
    want_recs = metrics(jcfg.exp_dir(tmp_path / "jax"))
    for g, w in zip(metrics(tmp_path / "port"), want_recs, strict=True):
        for k in ("train_loss", "val_loss", "val_lower_bound", "val_log_qy",
                  "val_log_px_z", "val_neg_kld_z1", "val_neg_kld_z2",
                  "val_log_pmu2"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    names = ckpt.jax_leaf_names(dict(got.state.model.named_parameters()))
    want = dict(zip(names, jax.tree_util.tree_leaves(res.state.params)))
    for n, p in got.state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
