"""The port's ``eval`` and ``probe`` against the JAX package's, on the CPU.

A tiny fhvae experiment is trained for one epoch by the JAX package
(``lstm_mm_dtype="float32"``, the plain paths, hus 16, z 4) on the synthetic
corpus of ``tests/test_torch_train_loop.py``. Both packages'
``evaluate_experiment`` then score its dev split into two output
directories, whose four artifacts are held together: ``metrics.json`` keys
equal and values within ``rtol 1e-5``; latents and reconstructions within
``rtol 1e-5, atol 1e-6`` (the port's forward sums in another fp32 order);
indices, inputs and ``sequences.json`` equal; dtypes equal throughout.

``linear_probe_accuracy`` is held to the JAX probe on the same features:
split sizes, ``n_classes`` and ``chance`` equal, accuracies within one
example of the split they are taken on (``1 / len(split)``): the fit's 300
AdamW steps sum in another order, which may move one example across a
decision boundary.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_scalablefhvae_tpu.eval import probes as jax_probes
from pytorch_scalablefhvae_tpu.eval.evaluate import (
    evaluate_experiment as jax_evaluate,
)
from pytorch_scalablefhvae_tpu.features.pipeline import preprocess_data
from pytorch_scalablefhvae_tpu.train.driver import (
    train_from_config as jax_train_from_config,
)
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.eval import probes
from pytorch_scalablefhvae_tpu_torch.eval.evaluate import evaluate_experiment

RUN = "synthetic_np_fbank"
ARTIFACTS = ("latents.npz", "reconstructions.npz", "metrics.json",
             "sequences.json")


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """``(corpus root, experiment dir)``: one JAX-trained epoch."""
    root = tmp_path_factory.mktemp("corpus")
    preprocess_data(ExperimentConfig(data=DataConfig(
        dataset="synthetic", synthetic_speakers=6, synthetic_utts=4)),
        root=root)
    cfg = ExperimentConfig(
        data=DataConfig(dataset="synthetic", mvn_path=str(root / "mvn.json"),
                        training_batch_size=32, dev_batch_size=64),
        model=ModelConfig(model_type="fhvae", z1_hus=(16, 16),
                          z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4, z2_dim=4,
                          use_pallas="never", lstm_pallas="never",
                          lstm_mm_dtype="float32"),
        train=TrainConfig(epochs=1))
    exp_root = tmp_path_factory.mktemp("exp")
    jax_train_from_config(cfg, root, exp_root, is_preprocessed=True,
                          verbose=False)
    return root, exp_root / RUN / "fhvae_e1_p10_a10.0"


@pytest.fixture(scope="module")
def both_evals(experiment, tmp_path_factory):
    """Each package's eval of the dev split, in its own directory."""
    root, exp = experiment
    out = tmp_path_factory.mktemp("evals")
    jax_res = jax_evaluate(exp, "dev", data_root=root,
                           output_dir=out / "jax", verbose=False)
    port_res = evaluate_experiment(exp, "dev", data_root=root,
                                   output_dir=out / "port", verbose=False,
                                   device="cpu")
    return out / "jax", out / "port", jax_res, port_res


def assert_npz_close(got_path, want_path, close, equal):
    with np.load(got_path) as got, np.load(want_path) as want:
        assert set(got.files) == set(want.files) == set(close) | set(equal)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            if k in equal:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)


def assert_metrics_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            assert_metrics_close(got[k], v)
        elif isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
        else:
            assert got[k] == v, k


def test_evaluate_experiment_matches_jax(both_evals):
    jax_dir, port_dir, _, port_res = both_evals
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(ARTIFACTS)
    assert_npz_close(port_dir / "latents.npz", jax_dir / "latents.npz",
                     close=("z1_mu", "z2_mu", "lower_bound", "mu2_map",
                            "z1_seq_mean"), equal=("seq_idx",))
    assert_npz_close(port_dir / "reconstructions.npz",
                     jax_dir / "reconstructions.npz",
                     close=("recon_mu", "swap_recon_mu"),
                     equal=("input", "seq_idx", "swap_z2_from"))
    got = json.loads((port_dir / "metrics.json").read_text())
    want = json.loads((jax_dir / "metrics.json").read_text())
    assert_metrics_close(got, want)
    assert got["probes"]["num_speakers"] == 6
    assert (port_dir / "sequences.json").read_text() == \
        (jax_dir / "sequences.json").read_text()
    assert set(port_res["seconds"]) == {"load", "map_pass", "scored_pass",
                                        "latents", "probe", "write"}


def test_lower_bound_is_scored_against_the_split_table(both_evals):
    """The per-segment bound of ``latents.npz`` averages to the split
    metric: both are scored against the split's MAP table (D6)."""
    _, port_dir, _, port_res = both_evals
    with np.load(port_dir / "latents.npz") as z:
        lb = z["lower_bound"].astype(np.float64).mean()
    np.testing.assert_allclose(lb, port_res["metrics"]["lower_bound"],
                               rtol=1e-5)


def probe_cases():
    rng = np.random.default_rng(1234)
    n_per, d = 80, 8
    separable = np.concatenate([
        rng.standard_normal((n_per, d)) * 0.1 + mu
        for mu in (np.zeros(d), np.ones(d) * 3, -np.ones(d) * 3)
    ]).astype(np.float32)
    random = rng.standard_normal((300, 8)).astype(np.float32)
    utt = np.repeat(np.arange(24), 15)
    grouped = (rng.standard_normal((len(utt), 6)) + 0.7
               * rng.standard_normal((24, 6))[utt]).astype(np.float32)
    return {
        "separable": (separable, np.repeat([0, 1, 2], n_per), None),
        "random": (random, rng.integers(0, 3, 300), None),
        "grouped": (grouped, utt % 8, utt),
    }


@pytest.mark.parametrize("case", ["separable", "random", "grouped"])
def test_linear_probe_matches_jax(case):
    feats, labels, groups = probe_cases()[case]
    got = probes.linear_probe_accuracy(feats, labels, groups=groups)
    want = jax_probes.linear_probe_accuracy(feats, labels, groups=groups)
    tr, te = probes.probe_split(len(feats), 0.8, 0, groups, 2)
    assert len(tr) + len(te) <= len(feats) and len(te) > 0
    for k in ("n_classes", "n_examples", "chance"):
        assert got[k] == want[k], k
    for k, split in (("train_acc", tr), ("test_acc", te)):
        assert abs(got[k] - want[k]) <= 1.0 / len(split) + 1e-7, (k, got, want)


def test_probe_split_matches_jax_split():
    """The split the JAX probe draws, rebuilt from its rules (temporal
    with groups, with the too-short rule; seeded random without)."""
    feats, labels, groups = probe_cases()["grouped"]
    groups = groups.copy()
    groups[:15] = np.repeat([100, 101, 102], 5)  # 5-segment utterances
    tr, te = probes.probe_split(len(feats), 0.8, 0, groups, 2)
    for g in np.unique(groups):
        idx = np.flatnonzero(groups == g)
        te_start = len(idx) - max(int(len(idx) * (1.0 - 0.8)), 1)
        if te_start - 2 <= 0:
            assert set(idx) <= set(tr)
        else:
            assert set(idx[:te_start - 2]) <= set(tr)
            assert set(idx[te_start:]) <= set(te)
    tr, te = probes.probe_split(10, 0.8, 3, None, 2)
    order = np.random.default_rng(3).permutation(10)
    np.testing.assert_array_equal(tr, order[:8])
    np.testing.assert_array_equal(te, order[8:])


@pytest.mark.parametrize("payload", [
    {"a": float("nan"), "b": [1.0, float("inf")], "c": "x"},
    {"probes": {"z1": {"test_acc": float("nan"), "n": 3}}, "lb": -2.5},
    [float("-inf"), (0.5, float("nan"))],
])
def test_json_safe_equals_jax_copy(payload):
    assert probes.json_safe(payload) == jax_probes.json_safe(payload)


@pytest.mark.parametrize("key", ["faks0_sa1", "1272-128104-0000", "spk3_u2",
                                 "plain", "a-b_c"])
def test_default_speaker_of_equals_jax_copy(key):
    assert probes.default_speaker_of(key) == \
        jax_probes.default_speaker_of(key)


def test_seqlist_and_step_match_jax(experiment, tmp_path):
    """``--seqlist`` (a subset of the dev split, in file order) and ``--step
    0`` (the epoch checkpoint, not the best copy) against the JAX eval."""
    root, exp = experiment
    keys = [line.split()[0] for line in
            (root / RUN / "dev" / "feats.scp").read_text().splitlines()]
    seqlist = tmp_path / "seqs.txt"
    seqlist.write_text("\n".join(keys[::2]) + "\n\n")
    kw = dict(seqlist=seqlist, step=0, data_root=root, verbose=False)
    want = jax_evaluate(exp, "dev", output_dir=tmp_path / "jax", **kw)
    got = evaluate_experiment(exp, "dev", output_dir=tmp_path / "port",
                              device="cpu", **kw)
    names = json.loads((tmp_path / "port" / "sequences.json").read_text())
    assert names == keys[::2]
    assert names == json.loads((tmp_path / "jax" / "sequences.json")
                               .read_text())
    assert got["metrics"].keys() == want["metrics"].keys()
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)
    assert_npz_close(tmp_path / "port" / "latents.npz",
                     tmp_path / "jax" / "latents.npz",
                     close=("z1_mu", "z2_mu", "lower_bound", "mu2_map",
                            "z1_seq_mean"), equal=("seq_idx",))


def test_missing_mvn_raises(experiment, tmp_path):
    root, exp = experiment
    copy = tmp_path / "exp"
    shutil.copytree(exp, copy)
    cfg = json.loads((copy / "config.json").read_text())
    cfg["data"]["mvn_path"] = str(tmp_path / "gone.json")
    (copy / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(FileNotFoundError, match="stats file is missing"):
        evaluate_experiment(copy, "dev", data_root=root, verbose=False,
                            device="cpu")
    with pytest.raises(FileNotFoundError, match="stats file is missing"):
        jax_evaluate(copy, "dev", data_root=root, verbose=False)
    assert not (tmp_path / "gone.json").exists()


def fresh_copy(exp, tmp_path):
    copy = tmp_path / "exp"
    shutil.copytree(exp, copy, ignore=shutil.ignore_patterns("eval"))
    return copy


def test_cli_eval_then_probe(experiment, tmp_path, capsys):
    root, exp = experiment
    copy = fresh_copy(exp, tmp_path)
    assert main(["eval", str(copy), "--data-root", str(root), "--device",
                 "cpu", "--visdom", "--num-reconstructions", "3"]) == 0
    out = capsys.readouterr().out
    assert "==== dev metrics ====" in out and "Speaker probe" in out
    lat_dir = copy / "eval" / "dev"
    assert sorted(p.name for p in lat_dir.iterdir()) == sorted(ARTIFACTS)
    with np.load(lat_dir / "reconstructions.npz") as z:
        assert len(z["input"]) == 3
    assert main(["probe", str(copy), "--data-root", str(root), "--device",
                 "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    metrics = json.loads((lat_dir / "metrics.json").read_text())
    assert res == metrics["probes"]


def test_cli_probe_alone_runs_eval_first(experiment, tmp_path, capsys):
    root, exp = experiment
    copy = fresh_copy(exp, tmp_path)
    assert main(["probe", str(copy), "--data-root", str(root), "--device",
                 "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("FeatureStore: ")  # the eval's store, as in JAX
    res = json.loads(out[out.index("\n{") + 1:])
    assert (copy / "eval" / "dev" / "latents.npz").is_file()
    assert res["num_speakers"] == 6
    assert set(res) == {"z1_speaker_probe", "z2_speaker_probe",
                        "num_speakers"}


def test_jax_probe_reads_the_port_artifacts(both_evals, experiment, tmp_path,
                                            capsys):
    """The JAX CLI's ``probe`` on the port's eval directory, and the port's
    on the JAX one: each reads the other's files and reports what its own
    package's probe reports on them."""
    from pytorch_scalablefhvae_tpu.cli.main import main as jax_main

    jax_dir, port_dir, _, _ = both_evals
    root, exp = experiment
    for src, cli in ((port_dir, jax_main), (jax_dir, main)):
        copy = fresh_copy(exp, tmp_path / src.name)
        shutil.copytree(src, copy / "eval" / "dev")
        flags = ["--device", "cpu"] if cli is main else []
        assert cli(["probe", str(copy), "--data-root", str(root),
                    *flags]) == 0
        res = json.loads(capsys.readouterr().out)
        stored = json.loads((src / "metrics.json").read_text())["probes"]
        assert_metrics_close(res, stored)


def test_cli_eval_tensorboard(experiment, tmp_path, capsys):
    """``--tensorboard`` writes ``eval/<split>/<k>`` scalars, or says the
    writer is unavailable and still exits 0."""
    root, exp = experiment
    copy = fresh_copy(exp, tmp_path)
    tb = tmp_path / "tb"
    assert main(["eval", str(copy), "--data-root", str(root), "--device",
                 "cpu", "--tensorboard", "--tb-log-dir", str(tb)]) == 0
    out = capsys.readouterr().out
    assert "TensorBoard unavailable (" in out or \
        any(p.name.startswith("events.") for p in tb.iterdir())


def test_cli_eval_cuda_raises_without_a_gpu(experiment, monkeypatch):
    root, exp = experiment
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main(["eval", str(exp), "--data-root", str(root)])
    with pytest.raises(RuntimeError, match="is_available"):
        main(["probe", str(exp), "--data-root", str(root), "--device",
              "cuda"])
