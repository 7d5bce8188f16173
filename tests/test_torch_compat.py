"""The port's ``compat.py`` against the JAX package's, on the CPU.

A reference checkpoint is built as ``tests/test_compat_import.py`` builds
it: a torch module with the reference's module and parameter names
(simple_fhvae.py:8-37, 127-244) saved in the reference's schema
(utils.py:116-152). Checks:

- both packages' ``load_reference_checkpoint`` give the same weights, bit
  for bit (a copy and a transpose), and a zero table at ``mu2_init_std`` 0;
- the imported z2 encoder reproduces the torch modules' ``z2_mu`` (1e-5
  relative, 1e-6 absolute: the same products in another order);
- an unknown key, a shape that does not fit and an ``fhvae`` checkpoint
  raise the JAX package's errors;
- ``import-checkpoint`` through the port's CLI, then ``train
  --continue-from ... --finetune``, trains on the card's default path (here
  the plain versions) from the imported weights;
- the shims hold the JAX package's ``tests/test_compat.py`` cases, and
  their values equal the JAX shims' on the same inputs.
"""

import json

import jax
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu import compat as jax_compat
from pytorch_scalablefhvae_tpu.config import DataConfig, ExperimentConfig
from pytorch_scalablefhvae_tpu.features.pipeline import preprocess_data
from pytorch_scalablefhvae_tpu.utils.manifest import write_scp
from pytorch_scalablefhvae_tpu_torch import compat
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt

D, H, Z = 20 * 80, 16, 4  # the synthetic corpus's segment, the CLI widths
NUM_SEQS = 12
RUN = "synthetic_np_fbank"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CLI runs here train on the CPU while other test processes run:
    every process keeps to one torch thread, so that none waits for a
    core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _VarLinear(torch.nn.Module):  # reference VariableLinearLayer naming
    def __init__(self, d_in, d_out):
        super().__init__()
        self.linear = torch.nn.Linear(d_in, d_out)

    def forward(self, x):
        return torch.relu(self.linear(x))


class _PreEnc(torch.nn.Module):  # LatentSeg/SeqPreEncoder + PreDecoder
    def __init__(self, d_in, hus):
        super().__init__()
        self.fc1 = _VarLinear(d_in, hus[0])
        self.fc2 = _VarLinear(hus[0], hus[1])

    def forward(self, x):
        return self.fc2(self.fc1(x))


class _Gauss(torch.nn.Module):  # GaussianLayer naming
    def __init__(self, d_in, dim):
        super().__init__()
        self.mulayer = torch.nn.Linear(d_in, dim)
        self.logvar_layer = torch.nn.Linear(d_in, dim)


class _RefModel(torch.nn.Module):
    """The reference SimpleFHVAE's module layout (simple_fhvae.py:31-36)."""

    def __init__(self):
        super().__init__()
        self.z1_pre_encoder = _PreEnc(D + Z, (H, H))
        self.z2_pre_encoder = _PreEnc(D, (H, H))
        self.z1_gauss_layer = _Gauss(H, Z)
        self.z2_gauss_layer = _Gauss(H, Z)
        self.pre_decoder = _PreEnc(2 * Z, (H, H))
        self.dec_gauss_layer = _Gauss(H, D)


@pytest.fixture(scope="module")
def saved_tar(tmp_path_factory):
    torch.manual_seed(7)
    model = _RefModel()
    ckpt_dict = {
        "best_val_lb": -123.0,
        "best_epoch": 4,
        "epoch": 6,
        "model_type": "simple_fhvae",
        "model_params": ([H, H], [H, H], Z, Z, [H, H]),
        "optimizer": {},
        "state_dict": model.state_dict(),
        "summary_vals": {},
        "values": {"train_loss_results": [3.0, 2.5], "val": {"0": 1.0}},
    }
    path = tmp_path_factory.mktemp("ref") / "simple_fhvae_ref_e6.tar"
    torch.save(ckpt_dict, path)
    return path, model


def test_weights_equal_jax_and_land_transposed(saved_tar):
    path, tmodel = saved_tar
    model, meta = compat.load_reference_checkpoint(path, NUM_SEQS)
    jm, params, jmeta = jax_compat.load_reference_checkpoint(path, NUM_SEQS)
    assert model.model_type == "simple_fhvae" and model.input_size == D
    assert model.model_params() == jm.model_params()
    assert {k: meta[k] for k in ("epoch", "best_epoch", "best_val_lb")} \
        == {k: jmeta[k] for k in ("epoch", "best_epoch", "best_val_lb")} \
        == {"epoch": 6, "best_epoch": 4, "best_val_lb": -123.0}
    want = ckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), want[n].numpy(),
                                      err_msg=n)
    sd = tmodel.state_dict()
    assert torch.equal(got["z2_pre.layers.0.w"],
                       sd["z2_pre_encoder.fc1.linear.weight"].T)
    assert torch.equal(got["dec_gauss.logvar.b"],
                       sd["dec_gauss_layer.logvar_layer.bias"])
    assert got["mu2_table"].shape == (NUM_SEQS, Z)
    assert (got["mu2_table"] == 0).all()
    seeded, _ = compat.load_reference_checkpoint(path, NUM_SEQS,
                                                 mu2_init_std=0.5, seed=3)
    again, _ = compat.load_reference_checkpoint(path, NUM_SEQS,
                                                mu2_init_std=0.5, seed=3)
    assert torch.equal(seeded.mu2_table, again.mu2_table)
    assert 0.2 < float(seeded.mu2_table.detach().std()) < 0.8


def test_encoder_matches_the_torch_modules(saved_tar):
    path, tmodel = saved_tar
    model, _ = compat.load_reference_checkpoint(path, NUM_SEQS)
    x = np.random.default_rng(0).standard_normal((4, 20, 80)) \
        .astype(np.float32)
    with torch.no_grad():
        h = tmodel.z2_pre_encoder(torch.from_numpy(x.reshape(4, -1)))
        want = tmodel.z2_gauss_layer.mulayer(h).numpy()
        got = model.encode_z2(torch.from_numpy(x)).numpy()
        enc = model.encode(torch.from_numpy(x))["z2_mu"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(enc, got)


def _bad_tar(saved_tar, tmp_path, **change):
    path, _ = saved_tar
    bad = dict(torch.load(path, weights_only=True))
    sd = dict(bad["state_dict"])
    sd.update(change.pop("state_dict", {}))
    bad.update(change, state_dict=sd)
    out = tmp_path / "bad.tar"
    torch.save(bad, out)
    return out


@pytest.mark.parametrize("case,match", [
    ("unknown", "Unrecognized"),
    ("layer past the model", "Unrecognized"),
    ("shape", "does not fit"),
    ("fhvae", "stub"),
])
def test_refusals_as_jax(saved_tar, tmp_path, case, match):
    change = {
        "unknown": {"state_dict": {"mystery.weight": torch.zeros(2, 2)}},
        "layer past the model": {"state_dict": {
            "pre_decoder.fc3.linear.bias": torch.zeros(H)}},
        "shape": {"state_dict": {
            "z1_gauss_layer.mulayer.weight": torch.zeros(Z + 1, H)}},
        "fhvae": {"model_type": "fhvae"},
    }[case]
    bad = _bad_tar(saved_tar, tmp_path, **change)
    with pytest.raises(ValueError, match=match):
        compat.load_reference_checkpoint(bad, NUM_SEQS)
    if case != "layer past the model":  # JAX fails there by an IndexError
        with pytest.raises(ValueError, match=match):
            jax_compat.load_reference_checkpoint(bad, NUM_SEQS)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    preprocess_data(ExperimentConfig(data=DataConfig(
        dataset="synthetic", synthetic_speakers=6, synthetic_utts=4)),
        root=root)
    return root


def test_cli_import_then_finetune(saved_tar, corpus, tmp_path, capsys):
    path, _ = saved_tar
    assert main(["import-checkpoint", str(path), str(tmp_path / "imp"),
                 "--num-seqs", str(NUM_SEQS)]) == 0
    npz = tmp_path / "imp" / "simple_fhvae_imported_e6.npz"
    assert f"Wrote {npz}" in capsys.readouterr().out
    meta = ckpt.read_checkpoint_meta(npz)
    assert meta["format"] == ckpt.PORT_FORMAT and meta["step"] == 0
    assert meta["values"] == {"train_loss_results": {"0": 3.0, "1": 2.5},
                              "val": {"0": 1.0}}
    with np.load(npz) as z:
        assert int(z["adam_count"]) == 0
        assert not z["adam_mu.z2_pre.layers.0.w"].any()
        imported = z["z2_pre.layers.0.w"]
    assert main(["train", "--dataset", "synthetic", "--preprocessed",
                 "--data-root", str(corpus), "--mvn-path",
                 str(corpus / "mvn.json"), "--training-batch-size", "16",
                 "--dev-batch-size", "64", "--exp-root", str(tmp_path / "ft"),
                 "--device", "cpu", "--epochs", "1", "--model-type",
                 "simple_fhvae", "--z1-hus", str(H), str(H), "--z2-hus",
                 str(H), str(H), "--x-hus", str(H), str(H), "--z1-dim",
                 str(Z), "--z2-dim", str(Z), "--continue-from", str(npz),
                 "--finetune"]) == 0
    exp = tmp_path / "ft" / RUN / "simple_fhvae_e1_p10_a10.0"
    rec, = [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines()]
    assert rec["epoch"] == 0 and np.isfinite(rec["train_loss"])
    with np.load(exp / f"simple_fhvae_{RUN}_e0.npz") as z:
        moved = z["z2_pre.layers.0.w"] - imported
        assert int(z["step"]) == rec["train_steps"] > 0
    # the finetune started from the imported weights: Adam moves each
    # element by about the learning rate a step
    assert 0 < np.abs(moved).max() <= 1e-3 * (rec["train_steps"] + 1)


def test_cli_import_of_a_missing_file_raises_as_jax(tmp_path):
    from pytorch_scalablefhvae_tpu.cli.main import main as jax_main

    args = ["import-checkpoint", str(tmp_path / "none.tar"),
            str(tmp_path / "out"), "--num-seqs", "3"]
    with pytest.raises(FileNotFoundError):
        jax_main(args)
    with pytest.raises(FileNotFoundError):
        main(args)
    with pytest.raises(SystemExit):
        main(args[:-2])  # --num-seqs is required


# ------------------------------------------------------------------ shims


def build_split(tmp_path, rng, lens=(40, 30), dim=8):
    feats, lend = {}, {}
    for i, n in enumerate(lens):
        k = f"spk{i}_utt{i}"
        p = tmp_path / f"{k}.npy"
        np.save(p, rng.standard_normal((n, dim)).astype(np.float32))
        feats[k] = str(p)
        lend[k] = n
    write_scp(tmp_path / "feats.scp", feats)
    write_scp(tmp_path / "len.scp", lend)
    return tmp_path / "feats.scp", tmp_path / "len.scp"


def test_dataset_shims(tmp_path, rng):
    feat_scp, len_scp = build_split(tmp_path, rng)
    ds = compat.NumpyDataset(feat_scp, len_scp, 20, None, 20, 8, False)
    want = jax_compat.NumpyDataset(feat_scp, len_scp, 20, None, 20, 8, False)
    idx, feat, nsegs = ds[0]
    assert feat.shape == (20, 8) and nsegs >= 1
    assert ds.seqlist == want.seqlist == ["spk0_utt0", "spk1_utt1"]
    assert compat.KaldiDataset is compat.NumpyDataset
    assert len(ds) == len(want)
    for i in range(len(ds)):
        a, b = ds[i], want[i]
        assert a[0] == b[0] and a[2] == b[2]
        np.testing.assert_array_equal(a[1], b[1])
    x = rng.standard_normal((5, 8)).astype(np.float32)
    np.testing.assert_array_equal(ds.undo_mvn(ds.apply_mvn(x)),
                                  want.undo_mvn(want.apply_mvn(x)))


@pytest.mark.parametrize("fn,rows", [("stft", 201), ("rstft", 201),
                                     ("to_melspec", 80)])
def test_audio_utils_shim(rng, fn, rows):
    """The reference's ``(bins, frames)`` orientation (utils.py:178-180),
    equal to the JAX shim's values."""
    y = rng.standard_normal(8000).astype(np.float32)
    got = getattr(compat.AudioUtils, fn)(y, 16000)
    assert got.shape[0] == rows
    np.testing.assert_array_equal(got, getattr(jax_compat.AudioUtils, fn)(
        y, 16000))
    if fn == "stft":
        assert np.iscomplexobj(got)
    np.testing.assert_array_equal(compat.AudioUtils.energy_vad(y, 16000),
                                  jax_compat.AudioUtils.energy_vad(y, 16000))


def test_loss_function_sign_and_value():
    lb = np.array([-10.0, -20.0])
    log_qy = np.array([-1.0, -3.0])
    loss = float(compat.loss_function(torch.tensor(lb), torch.tensor(log_qy),
                                      alpha=2.0))
    assert np.isclose(loss, -np.mean(lb + 2.0 * log_qy)) and loss > 0
    assert loss == pytest.approx(float(jax_compat.loss_function(
        lb, log_qy, alpha=2.0)))


def test_early_stopping_shims():
    assert compat.check_best(-1.0, -2.0) and not compat.check_best(-2.0, -1.0)
    for args in ((5, 2, 3, 10), (4, 2, 3, 10), (9, 9, 3, 10)):
        assert compat.check_terminate(*args) \
            == jax_compat.check_terminate(*args)


def test_estimate_mu2_dict_equals_jax(tmp_path, rng):
    from pytorch_scalablefhvae_tpu.data.loader import (
        SegmentLoader as JaxSegmentLoader,
    )
    from pytorch_scalablefhvae_tpu.models import SimpleFHVAE as JaxSimple
    from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
    from pytorch_scalablefhvae_tpu_torch.models.simple_fhvae import (
        SimpleFHVAE,
    )

    feat_scp, len_scp = build_split(tmp_path, rng)
    dims = dict(z1_hus=(16, 16), z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4,
                z2_dim=4)
    jds = jax_compat.NumpyDataset(feat_scp, len_scp, 20, None, 20, 8, False)
    jm = JaxSimple(input_size=20 * 8, num_seqs=jds.num_seqs, **dims)
    params = jm.init(jax.random.PRNGKey(0))
    want = jax_compat.estimate_mu2_dict(
        jm, params, JaxSegmentLoader(jds, batch_size=4, shuffle=False,
                                     seed=0))
    ds = compat.NumpyDataset(feat_scp, len_scp, 20, None, 20, 8, False)
    tm = SimpleFHVAE(20 * 8, num_seqs=ds.num_seqs, feat_dim=8, **dims)
    tm.load_state_dict(ckpt.params_from_jax(jax.tree_util.tree_map(
        np.asarray, params)))
    got = compat.estimate_mu2_dict(tm, SegmentLoader(ds, batch_size=4,
                                                     shuffle=False, seed=0))
    assert set(got) == set(want) == {0, 1}  # keyed by sequence index
    for i in got:
        assert got[i].shape == (4,)
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, atol=1e-6)


def test_reference_values_convert_as_jax():
    from pytorch_scalablefhvae_tpu_torch.train.metrics import MetricHistory

    raw = {
        "train_loss_results": [1.5, 1.2, 1.0],
        "val_loss_results": {0: 2.0, "1": 1.8, "2": "bad"},
        "lower_bound_results": object(),   # unconvertible: dropped
    }
    vals = compat._convert_reference_values(raw)
    assert vals == jax_compat._convert_reference_values(raw)
    hist = MetricHistory(vals)
    assert hist.values["train_loss_results"] == {0: 1.5, 1: 1.2, 2: 1.0}
    assert hist.values["val_loss_results"] == {0: 2.0, 1: 1.8}
    assert compat._convert_reference_values(None) == {}
    assert compat._convert_reference_values([1, 2]) == {}
