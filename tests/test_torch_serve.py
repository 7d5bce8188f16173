"""The port's encode/serve slice against the JAX package's, end to end.

A tiny fhvae experiment is built with the JAX package (config, MVN stats,
a JAX checkpoint), as tests/test_encode.py builds its experiment. Its config
sets ``lstm_mm_dtype="float32"``: on the CPU the JAX scan path ignores the
bf16 operand mode, which the port honours. The JAX ``EncodeSession`` and the
port's encode then run the same WAVs — five utterances against a table of
three rows, so the request also numbers more utterances than the table has.
"""

import io
import json

import numpy as np
import pytest

from pytorch_scalablefhvae_tpu.config import (
    DataConfig,
    ExperimentConfig,
    FeatureConfig,
    ModelConfig,
)
from pytorch_scalablefhvae_tpu.eval.encode import EncodeSession as JaxSession
from pytorch_scalablefhvae_tpu.models.base import build_model as jax_build
from pytorch_scalablefhvae_tpu.train import checkpoint as jax_ckpt
from pytorch_scalablefhvae_tpu.train.step import (
    create_train_state,
    make_optimizer,
)
from pytorch_scalablefhvae_tpu.utils.audio_io import write_wav
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.eval.encode import (
    EncodeSession,
    encode_audio,
)
from pytorch_scalablefhvae_tpu_torch.eval.serve import serve

SR, N_MELS, SEG_LEN, NSEQ = 16000, 8, 20, 3


@pytest.fixture(scope="module")
def exp_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("exp")
    cfg = ExperimentConfig(
        features=FeatureConfig(n_mels=N_MELS),
        data=DataConfig(dataset="synthetic", seg_len=SEG_LEN,
                        mvn_path=str(root / "mvn.json")),
        model=ModelConfig(model_type="fhvae", z1_hus=(16, 16),
                          z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4, z2_dim=4,
                          lstm_mm_dtype="float32"),
    )
    cfg.save(root / "config.json")
    (root / "mvn.json").write_text(json.dumps(
        {"mean": [[0.5] * N_MELS], "std": [[2.0] * N_MELS]}))
    model = jax_build("fhvae", SEG_LEN * N_MELS, cfg.model, NSEQ,
                      feat_dim=N_MELS)
    state = create_train_state(model, make_optimizer(1e-3, 0.95, 0.999),
                               seed=0)
    jax_ckpt.save_checkpoint(
        root, state, model_type="fhvae", model_params=model.model_params(),
        run_info="enc", epoch=0, best_epoch=0, best_val_lb=-1.0, values={},
        extra_meta={"num_seqs": NSEQ, "feat_dim": N_MELS, "seg_len": SEG_LEN})
    return root


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("wav")
    rng = np.random.default_rng(7)
    for i in range(NSEQ + 2):
        t = np.arange(int(SR * (0.4 + 0.1 * i))) / SR
        y = 0.4 * np.sin(2 * np.pi * (200 + 60 * i) * t) \
            + 0.05 * rng.standard_normal(len(t))
        write_wav(root / f"utt{i}.wav", y.astype(np.float32), SR)
    return root


def test_encode_matches_jax_session(exp_dir, wav_dir):
    want = JaxSession(exp_dir, batch_size=16).encode(
        [str(wav_dir)], verbose=False)
    got = EncodeSession(exp_dir, batch_size=16, device="cpu").encode(
        [str(wav_dir)], verbose=False)
    assert got["sequences"] == want["sequences"]
    assert len(got["sequences"]) > NSEQ  # more utterances than table rows
    np.testing.assert_array_equal(got["seq_idx"], want["seq_idx"])
    for k in ("mu2_map", "z1_seq_mean", "z1_mu", "z2_mu"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0,
                                   err_msg=k)


def test_serve_protocol(exp_dir, wav_dir, tmp_path):
    lines = [
        {"id": "p", "cmd": "ping"},
        {"id": "r1", "inputs": [str(wav_dir)],
         "output_dir": str(tmp_path / "r1")},
        {"id": "bad", "inputs": "not-a-list"},
        "{not json",
        {"id": "s", "cmd": "shutdown"},
        {"id": "after", "cmd": "ping"},  # never read: the server has stopped
    ]
    stdin = io.StringIO("\n".join(
        x if isinstance(x, str) else json.dumps(x) for x in lines) + "\n")
    stdout = io.StringIO()
    assert serve(exp_dir, batch_size=16, device="cpu", stdin=stdin,
                 stdout=stdout) == 0
    out = [json.loads(line) for line in stdout.getvalue().splitlines()]
    assert [o.get("id") for o in out] == [None, "p", "r1", "bad", None, "s"]
    assert out[0]["ready"] and out[1]["model_type"] == "fhvae"
    assert out[1]["device"] == "cpu" and out[1]["batch_size"] == 16
    r1 = out[2]
    assert r1["ok"] and r1["utterances"] == NSEQ + 2
    assert np.asarray(r1["mu2_map"]).shape == (NSEQ + 2, 4)
    assert np.isfinite(np.asarray(r1["z1_seq_mean"])).all()
    assert set(r1["seconds"]) == {"features", "latents", "summaries"}
    assert set(r1["features_seconds"]) == {"audio", "features", "segments"}
    with np.load(tmp_path / "r1" / "latents.npz") as z:
        assert len(z["z1_mu"]) == r1["segments"]
    assert out[3]["ok"] is False and "inputs" in out[3]["error"]
    assert out[4]["ok"] is False and "JSONDecodeError" in out[4]["error"]
    assert out[5]["bye"]


def test_cli_encode_and_not_ported(exp_dir, wav_dir, tmp_path, capsys):
    rc = main(["encode", str(exp_dir), str(wav_dir), "--output-dir",
               str(tmp_path / "cli"), "--device", "cpu", "--batch-size", "16"])
    assert rc == 0
    one_shot = encode_audio(exp_dir, [str(wav_dir)], batch_size=16,
                            device="cpu", verbose=False)
    with np.load(tmp_path / "cli" / "latents.npz") as z:
        np.testing.assert_array_equal(z["mu2_map"], one_shot["mu2_map"])
    assert main(["eval", str(exp_dir)]) == 2
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("fbank_pallas", ["auto", "always"])
def test_jax_extractor_matches_jax_session(exp_dir, wav_dir, fbank_pallas):
    """A run whose config says ``extractor: "jax"``: the JAX session runs its
    batched chain (``always``: the Pallas kernel in interpret mode), the port
    ``features/dsp_torch.py`` on the CPU, at the same weights.

    Limit 2e-4 where the numpy extractor's test has 1e-4: there both sides
    read identical features; here the two chains' log-mels differ by float32
    round-off (up to 3e-4, ``tests/test_torch_fbank.py``), halved by this
    run's MVN (std 2.0) before the model sees them."""
    cfg = ExperimentConfig.load(exp_dir / "config.json")
    cfg = cfg.replace(features=FeatureConfig(
        n_mels=N_MELS, extractor="jax", fbank_pallas=fbank_pallas))
    jax_session = JaxSession(exp_dir, batch_size=16)
    jax_session.config = cfg
    want = jax_session.encode([str(wav_dir)], verbose=False)
    session = EncodeSession(exp_dir, batch_size=16, device="cpu")
    session.config = type(session.config).from_json(cfg.to_json())
    got = session.encode([str(wav_dir)], verbose=False)
    assert got["sequences"] == want["sequences"]
    np.testing.assert_array_equal(got["seq_idx"], want["seq_idx"])
    for k in ("mu2_map", "z1_seq_mean", "z1_mu", "z2_mu"):
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, rtol=0,
                                   err_msg=k)
    # and the host extractor's answer is the same request within the
    # features' own distance
    host = EncodeSession(exp_dir, batch_size=16, device="cpu").encode(
        [str(wav_dir)], verbose=False)
    np.testing.assert_array_equal(got["seq_idx"], host["seq_idx"])
    np.testing.assert_allclose(got["z1_mu"], host["z1_mu"], atol=2e-3, rtol=0)
    assert set(got["features_seconds"]) == {"audio", "features", "segments"}
    assert all(v >= 0 for v in got["features_seconds"].values())
