"""The port's host layer against the JAX package's, exactly.

The port keeps its own copy of every host module it needs (config, CLI
flags, manifests, Kaldi archives, audio I/O, the native C++ library, the
host feature extractors, the packed store, segments, the loader, the
device-store planning, the corpus prep). Each copy must behave as its
original: the same seeded numpy inputs go through both and the results are
held equal to the bit (files: to the byte). One case per function, so a
copy that drifts fails a test that names it.
"""

import argparse
import dataclasses
import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

import pytorch_scalablefhvae_tpu.cli.args as jax_args
import pytorch_scalablefhvae_tpu.config as jax_config
import pytorch_scalablefhvae_tpu.corpus.librispeech as jax_libri
import pytorch_scalablefhvae_tpu.corpus.synthetic as jax_synth
import pytorch_scalablefhvae_tpu.corpus.timit as jax_timit
import pytorch_scalablefhvae_tpu.data.device_store as jax_device_store
import pytorch_scalablefhvae_tpu.data.feature_store as jax_store
import pytorch_scalablefhvae_tpu.data.loader as jax_loader
import pytorch_scalablefhvae_tpu.data.quantize as jax_quantize
import pytorch_scalablefhvae_tpu.data.segments as jax_segments
import pytorch_scalablefhvae_tpu.data.stream_store as jax_stream_store
import pytorch_scalablefhvae_tpu.features.dsp_numpy as jax_dsp_numpy
import pytorch_scalablefhvae_tpu.features.extract as jax_extract
import pytorch_scalablefhvae_tpu.features.kaldi_fbank as jax_kaldi_fbank
import pytorch_scalablefhvae_tpu.features.mel as jax_mel
import pytorch_scalablefhvae_tpu.features.pipeline as jax_pipeline
import pytorch_scalablefhvae_tpu.native.binding as jax_native
import pytorch_scalablefhvae_tpu.utils.audio_io as jax_audio
import pytorch_scalablefhvae_tpu.utils.kaldi_ark as jax_ark
import pytorch_scalablefhvae_tpu.train.metrics as jax_metrics
import pytorch_scalablefhvae_tpu.train.plots as jax_plots
import pytorch_scalablefhvae_tpu.utils.manifest as jax_manifest
import pytorch_scalablefhvae_tpu_torch.cli.args as port_args
import pytorch_scalablefhvae_tpu_torch.config as port_config
import pytorch_scalablefhvae_tpu_torch.corpus.librispeech as port_libri
import pytorch_scalablefhvae_tpu_torch.corpus.synthetic as port_synth
import pytorch_scalablefhvae_tpu_torch.corpus.timit as port_timit
import pytorch_scalablefhvae_tpu_torch.data.device_store as port_device_store
import pytorch_scalablefhvae_tpu_torch.data.feature_store as port_store
import pytorch_scalablefhvae_tpu_torch.data.loader as port_loader
import pytorch_scalablefhvae_tpu_torch.data.quantize as port_quantize
import pytorch_scalablefhvae_tpu_torch.data.segments as port_segments
import pytorch_scalablefhvae_tpu_torch.data.stream_store as port_stream_store
import pytorch_scalablefhvae_tpu_torch.features.dsp_numpy as port_dsp_numpy
import pytorch_scalablefhvae_tpu_torch.features.extract as port_extract
import pytorch_scalablefhvae_tpu_torch.features.kaldi_fbank as port_kaldi_fbank
import pytorch_scalablefhvae_tpu_torch.features.mel as port_mel
import pytorch_scalablefhvae_tpu_torch.features.pipeline as port_pipeline
import pytorch_scalablefhvae_tpu_torch.native.binding as port_native
import pytorch_scalablefhvae_tpu_torch.utils.audio_io as port_audio
import pytorch_scalablefhvae_tpu_torch.utils.kaldi_ark as port_ark
import pytorch_scalablefhvae_tpu_torch.train.metrics as port_metrics
import pytorch_scalablefhvae_tpu_torch.train.plots as port_plots
import pytorch_scalablefhvae_tpu_torch.utils.manifest as port_manifest

REPO = Path(__file__).resolve().parents[1]


def signal(seed: int, n: int = 6000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * (180 + 40 * seed) * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def feature_dict(seed: int = 3, dim: int = 6) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {f"utt{i}": rng.standard_normal((n, dim)).astype(np.float32)
            for i, n in enumerate([31, 57, 20, 44, 25])}


def same_tree(a: Path, b: Path) -> None:
    """Both directories hold the same files with the same bytes."""
    names_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    names_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert names_a == names_b and names_a
    for name in names_a:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


# ---- config and flags -----------------------------------------------------

def parse(mod, main_flags: list[str], train: bool = True):
    p = argparse.ArgumentParser()
    mod.add_common_flags(p)
    if train:
        mod.add_train_flags(p)
    return p.parse_args(main_flags)


# the flag sets of tests/test_cli.py, plus the feature flags of preprocess
FLAG_SETS = {
    "defaults": ["--dataset", "timit", "--preprocessed"],
    "naming": ["--dataset", "timit", "--preprocessed", "--model-type",
               "simple_fhvae", "--epochs", "50", "--patience", "5",
               "--alpha-dis", "8"],
    "kaldi": ["--dataset", "timit", "--preprocessed", "--data-format",
              "kaldi", "--feat-type", "spec"],
    "mesh": ["--dataset", "synthetic", "--preprocessed", "--mesh", "4,2"],
    "legacy": ["--dataset", "timit", "--preprocessed", "--legacy",
               "--steps-per-epoch", "100", "--log-interval", "10"],
    "roundtrip": ["--dataset", "librispeech", "--preprocessed", "--z1-dim",
                  "24", "--hierarchical", "--compute-dtype", "bfloat16"],
    "features": ["--dataset", "synthetic", "--extractor", "jax",
                 "--fbank-pallas", "never", "--sample-rate", "8000",
                 "--win-size", "0.02", "--hop-size", "0.005", "--mels", "40",
                 "--dither-seed", "7", "--num-workers", "2",
                 "--synthetic-speakers", "64", "--synthetic-utts", "5",
                 "--train-list", "train-other-500", "--dev-list", "dev-clean"],
    "data": ["--dataset", "timit", "--raw-data-dir", "/x", "--min-len", "30",
             "--mvn-path", "/m.json", "--seg-len", "10", "--seg-shift", "4",
             "--rand-seg", "true", "--training-batch-size", "64",
             "--dev-batch-size", "128", "--pack-cache-dir", "/pc",
             "--transfer-dtype", "bfloat16", "--data-placement", "device",
             "--device-store-max-bytes", "1024", "--stream-chunk-bytes",
             "4096", "--shard-device-store", "--epoch-plan", "device"],
    "model": ["--z1-hus", "64", "64", "--z2-hus", "64", "64", "--z2-dim", "8",
              "--x-hus", "64", "64", "--pz2-std", "0.3", "--mu2-init-std",
              "0.5", "--use-pallas", "never", "--lstm-pallas", "never",
              "--lstm-mm-dtype", "float32", "--scan-unroll", "4",
              "--learning-rate", "0.01", "--beta-one", "0.9", "--beta-two",
              "0.99"],
    "train": ["--seed", "9", "--num-hierarchical-sequences", "99",
              "--hierarchical-round-epochs", "3", "--map-init-chunk-skip",
              "2", "--ckpt-every-steps", "50", "--max-steps", "120",
              "--profile-dir", "/prof", "--profile-epoch", "0",
              "--tensorboard", "--visdom", "--tb-log-dir", "/tb",
              "--log-params", "--steps-per-dispatch", "4", "--ckpt-backend",
              "orbax", "--donate-state", "false"],
}


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_config_from_args(name):
    flags = FLAG_SETS[name]
    want = jax_args.config_from_args(parse(jax_args, flags))
    got = port_args.config_from_args(parse(port_args, flags))
    assert got.to_dict() == want.to_dict()
    assert got.to_json() == want.to_json()
    assert got.base_string() == want.base_string()
    assert got.exp_string() == want.exp_string()
    assert got.run_id() == want.run_id()
    assert got.exp_dir("./e") == want.exp_dir("./e")
    # one config.json means the same run to both packages
    assert port_config.ExperimentConfig.from_json(want.to_json()) == got
    assert jax_config.ExperimentConfig.from_json(got.to_json()) == want


def test_config_from_args_without_train_flags():
    flags = FLAG_SETS["features"]
    want = jax_args.config_from_args(parse(jax_args, flags, train=False))
    got = port_args.config_from_args(parse(port_args, flags, train=False))
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("n,m", [(4620, 8), (4620, 1), (13, 4), (16, 4),
                                 (281241, 4), (5, 8), (7, 0)])
def test_padded_num_seqs(n, m):
    from pytorch_scalablefhvae_tpu.parallel.mesh import padded_num_seqs
    from pytorch_scalablefhvae_tpu_torch.parallel import mesh as port_mesh

    assert port_mesh.padded_num_seqs(n, m) == padded_num_seqs(n, m)


def test_config_dataclasses_have_the_same_fields():
    for name in ("FeatureConfig", "DataConfig", "ModelConfig", "OptimConfig",
                 "TrainConfig", "ExperimentConfig"):
        want = [(f.name, f.type) for f in
                dataclasses.fields(getattr(jax_config, name))]
        got = [(f.name, f.type) for f in
               dataclasses.fields(getattr(port_config, name))]
        assert got == want, name
    assert port_config.ExperimentConfig().to_dict() == \
        jax_config.ExperimentConfig().to_dict()
    assert port_config.FeatureConfig(sample_rate=8000).n_fft == \
        jax_config.FeatureConfig(sample_rate=8000).n_fft


def test_config_save_load_and_overrides(tmp_path):
    overrides = {"epochs": "200", "train.patience": "20", "z1_hus": "64,64",
                 "mesh_shape": "2", "mvn_path": "none", "rand_seg": "true",
                 "alpha_dis": "2.5"}
    want = jax_config.ExperimentConfig().apply_overrides(overrides)
    got = port_config.ExperimentConfig().apply_overrides(overrides)
    assert got.to_dict() == want.to_dict()
    got.save(tmp_path / "port" / "config.json")
    want.save(tmp_path / "jax" / "config.json")
    assert filecmp.cmp(tmp_path / "port" / "config.json",
                       tmp_path / "jax" / "config.json", shallow=False)
    assert port_config.ExperimentConfig.load(
        tmp_path / "jax" / "config.json") == got
    for bad in ({"nope": 1}, {"seed.x": 1}, {"features.nope": 1}):
        with pytest.raises(ValueError):
            port_config.ExperimentConfig().apply_overrides(bad)


# ---- manifests, archives, audio -------------------------------------------

def test_manifest_write_then_read(tmp_path):
    entries = {"b": "x/y.npy", "a": 17, "c": "ark:3"}
    port_manifest.write_scp(tmp_path / "p.scp", entries)
    jax_manifest.write_scp(tmp_path / "j.scp", entries)
    assert filecmp.cmp(tmp_path / "p.scp", tmp_path / "j.scp", shallow=False)
    assert port_manifest.read_scp(tmp_path / "j.scp") == \
        jax_manifest.read_scp(tmp_path / "p.scp")
    lens = {"a": 5, "b": 9}
    port_manifest.write_scp(tmp_path / "len.scp", lens)
    got = port_manifest.read_scp(tmp_path / "len.scp", dtype=int,
                                 keep_keys={"b"})
    assert got == jax_manifest.read_scp(tmp_path / "len.scp", dtype=int,
                                        keep_keys={"b"}) == {"b": 9}


def test_kaldi_ark_write_then_read(tmp_path):
    feats = feature_dict()
    with port_ark.ArkWriter(tmp_path / "p.ark", tmp_path / "p.scp") as w:
        for k, v in feats.items():
            w.write(k, v)
    with jax_ark.ArkWriter(tmp_path / "j.ark", tmp_path / "j.scp") as w:
        for k, v in feats.items():
            w.write(k, v)
    assert filecmp.cmp(tmp_path / "p.ark", tmp_path / "j.ark", shallow=False)
    assert (tmp_path / "p.scp").read_text().replace("p.ark", "j.ark") == \
        (tmp_path / "j.scp").read_text()
    got = port_ark.read_ark(tmp_path / "j.ark")
    want = jax_ark.read_ark(tmp_path / "p.ark")
    assert list(got) == list(want) == list(feats)
    for k in feats:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], feats[k])
    for g, w in zip(port_ark.iter_ark_offsets(tmp_path / "p.ark"),
                    jax_ark.iter_ark_offsets(tmp_path / "p.ark"), strict=True):
        assert (g[0], g[2]) == (w[0], w[2])  # key and byte offset
        np.testing.assert_array_equal(g[1], w[1])
    rx = port_manifest.read_scp(tmp_path / "p.scp")["utt3"]
    np.testing.assert_array_equal(port_ark.load_mat(rx), feats["utt3"])
    port_ark.write_ark(tmp_path / "w.ark", feats)
    assert filecmp.cmp(tmp_path / "w.ark", tmp_path / "j.ark", shallow=False)


def test_audio_wav_write_then_read(tmp_path):
    y = signal(1)
    port_audio.write_wav(tmp_path / "p.wav", y, 16000)
    jax_audio.write_wav(tmp_path / "j.wav", y, 16000)
    assert filecmp.cmp(tmp_path / "p.wav", tmp_path / "j.wav", shallow=False)
    got, sr = port_audio.read_audio(tmp_path / "j.wav")
    want, sr_want = jax_audio.read_audio(tmp_path / "j.wav")
    assert sr == sr_want == 16000
    np.testing.assert_array_equal(got, want)
    got8, sr8 = port_audio.read_audio(tmp_path / "j.wav", 8000)
    want8, _ = jax_audio.read_audio(tmp_path / "j.wav", 8000)
    assert sr8 == 8000
    np.testing.assert_array_equal(got8, want8)
    np.testing.assert_array_equal(port_audio.resample(y, 16000, 11025),
                                  jax_audio.resample(y, 16000, 11025))
    assert not port_audio.is_sphere(tmp_path / "j.wav")


# ---- host features --------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(sr=16000, n_fft=400, n_mels=80),
    dict(sr=16000, n_fft=400, n_mels=40, htk=True, norm=None),
    dict(sr=8000, n_fft=200, n_mels=23, fmin=20.0, fmax=3800.0),
], ids=["slaney80", "htk40", "narrow23"])
def test_mel_filterbank(kw):
    np.testing.assert_array_equal(port_mel.mel_filterbank(**kw),
                                  jax_mel.mel_filterbank(**kw))


def test_kaldi_mel_bins():
    for kw in (dict(sr=16000, n_fft=512, n_mels=80),
               dict(sr=8000, n_fft=256, n_mels=23, low_freq=64.0,
                    high_freq=-200.0)):
        np.testing.assert_array_equal(port_mel.kaldi_mel_bins(**kw),
                                      jax_mel.kaldi_mel_bins(**kw))


@pytest.mark.parametrize("fn", ["periodic_window", "preemphasize",
                                "frame_signal", "stft_mag", "log_spectrogram",
                                "log_melspec", "energy_vad"])
def test_dsp_numpy(fn):
    y = signal(2)
    args = {
        "periodic_window": ("hamming", 400),
        "preemphasize": (y,),
        "frame_signal": (y, 400, 160),
        "stft_mag": (y, 400, 160, 400),
        "log_spectrogram": (y, 16000),
        "log_melspec": (y, 16000),
        "energy_vad": (y, 16000),
    }[fn]
    got = getattr(port_dsp_numpy, fn)(*args)
    want = getattr(jax_dsp_numpy, fn)(*args)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("ftype,kw", [
    ("fbank", {}),
    ("spec", {}),
    ("fbank", dict(n_mels=40, window="hann", preemphasis=0.0,
                   mel_norm=None, log_floor_mel=-5.0)),
], ids=["fbank", "spec", "fbank-options"])
def test_generate_feat(ftype, kw):
    y = signal(3)
    got = port_extract.generate_feat(ftype, y, 16000, **kw)
    want = jax_extract.generate_feat(ftype, y, 16000, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(dither=0.0),
    dict(dither=0.0, n_mels=40, window_type="povey", remove_dc_offset=False,
         use_power=False),
    dict(dither=1.0, seed=11),
], ids=["defaults", "povey40", "dithered"])
def test_kaldi_fbank(kw):
    y = signal(4)
    np.testing.assert_array_equal(port_kaldi_fbank.kaldi_fbank(y, 16000, **kw),
                                  jax_kaldi_fbank.kaldi_fbank(y, 16000, **kw))


def test_fbank_conf_parsing():
    conf = REPO / "misc" / "fbank.conf"
    want = jax_kaldi_fbank.fbank_kwargs_from_conf(
        jax_kaldi_fbank.parse_fbank_conf(str(conf)))
    got = port_kaldi_fbank.fbank_kwargs_from_conf(
        port_kaldi_fbank.parse_fbank_conf(str(conf)))
    assert got == want and got


def test_native_library_builds_from_the_ports_own_sources(tmp_path):
    """The port's ``native/`` compiles its own copy of the C++ sources next
    to them and gives the original's numbers; the archive reader too."""
    assert port_native._DIR != jax_native._DIR
    assert port_native._DIR.name == "native"
    for src in port_native._SOURCES:
        assert src.exists()
        assert src.parent == port_native._DIR
    y = signal(5)
    for kw in (dict(dither=0.0), dict(dither=1.0, seed=3, n_mels=40)):
        np.testing.assert_array_equal(port_native.native_fbank(y, 16000, **kw),
                                      jax_native.native_fbank(y, 16000, **kw))
    port_ark.write_ark(tmp_path / "f.ark", feature_dict())
    got = port_native.native_read_ark_packed(tmp_path / "f.ark",
                                             with_file_offsets=True)
    want = jax_native.native_read_ark_packed(tmp_path / "f.ark",
                                             with_file_offsets=True)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


# ---- the packed store, segments, the loader -------------------------------

def test_quantize():
    x = np.random.default_rng(6).standard_normal((300, 7)).astype(np.float32)
    got = port_quantize.quantize_columns(x, block_rows=64)
    want = jax_quantize.quantize_columns(x, block_rows=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port_quantize.dequantize(*got),
                                  jax_quantize.dequantize(*want))


@pytest.mark.parametrize("rand_seg", [False, True])
def test_make_segments(rand_seg):
    lens = np.array([31, 57, 20, 44, 7])
    got = port_segments.make_segments(
        lens, 20, 8, rand_seg, np.random.default_rng(1))
    want = jax_segments.make_segments(
        lens, 20, 8, rand_seg, np.random.default_rng(1))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        port_segments.chunk_skip_indices(got[0], spb=2, skip=2),
        jax_segments.chunk_skip_indices(want[0], spb=2, skip=2))


def stores(mvn: bool = True):
    feats = feature_dict()
    mvn_params = {"mean": [[0.1] * 6], "std": [[1.5] * 6]} if mvn else None
    kw = dict(mvn_params=mvn_params, apply_mvn=mvn)
    return (jax_store.FeatureStore.from_arrays(feats, **kw),
            port_store.FeatureStore.from_arrays(feats, **kw))


def test_feature_store_from_arrays():
    want, got = stores()
    assert got.seq_keys == want.seq_keys and got.dim == want.dim
    assert got.num_seqs == want.num_seqs
    for name in ("data", "lens", "seq_starts"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.sequence(2), want.sequence(2))
    x = np.ones((3, 6), np.float32)
    np.testing.assert_array_equal(got.undo_mvn(got.apply_mvn(x)),
                                  want.undo_mvn(want.apply_mvn(x)))
    for materialize in (False, True):
        a = got.subset(["utt3", "utt0"], materialize=materialize)
        b = want.subset(["utt3", "utt0"], materialize=materialize)
        np.testing.assert_array_equal(a.sequence(0), b.sequence(0))
        np.testing.assert_array_equal(a.seq_starts, b.seq_starts)


@pytest.mark.parametrize("data_format", ["numpy", "kaldi"])
def test_feature_store_from_manifests(tmp_path, data_format):
    feats = feature_dict()
    if data_format == "numpy":
        for k, v in feats.items():
            np.save(tmp_path / f"{k}.npy", v)
        port_manifest.write_scp(
            tmp_path / "feats.scp",
            {k: str(tmp_path / f"{k}.npy") for k in feats})
    else:
        with port_ark.ArkWriter(tmp_path / "feats.ark",
                                tmp_path / "feats.scp") as w:
            for k, v in feats.items():
                w.write(k, v)
    port_manifest.write_scp(tmp_path / "len.scp",
                            {k: len(v) for k, v in feats.items()})
    kw = dict(min_len=25, verbose=False)
    got = port_store.FeatureStore(
        tmp_path / "feats.scp", tmp_path / "len.scp",
        mvn_path=tmp_path / "mvn_port.json", **kw)
    want = jax_store.FeatureStore(
        tmp_path / "feats.scp", tmp_path / "len.scp",
        mvn_path=tmp_path / "mvn_jax.json", **kw)
    assert got.seq_keys == want.seq_keys and len(got.seq_keys) == 4
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.seq_starts, want.seq_starts)
    assert (tmp_path / "mvn_port.json").read_text() == \
        (tmp_path / "mvn_jax.json").read_text()


@pytest.mark.parametrize("shuffle,prefetch,rand_seg", [
    (False, 0, False), (True, 2, False), (True, 0, True)])
def test_segment_loader_batches(shuffle, prefetch, rand_seg):
    want_store, got_store = stores()
    kw = dict(seg_len=20, seg_shift=8, rand_seg=rand_seg, seed=5)
    want_ds = jax_segments.SegmentDataset(want_store, **kw)
    got_ds = port_segments.SegmentDataset(got_store, **kw)
    assert len(got_ds) == len(want_ds) and got_ds.num_seqs == want_ds.num_seqs
    np.testing.assert_array_equal(got_ds[3][1], want_ds[3][1])
    lkw = dict(shuffle=shuffle, seed=5, prefetch=prefetch)
    want_loader = jax_loader.SegmentLoader(want_ds, 8, **lkw)
    got_loader = port_loader.SegmentLoader(got_ds, 8, **lkw)
    assert len(got_loader) == len(want_loader)
    for epoch in (0, 1):
        want_loader.set_epoch(epoch)
        got_loader.set_epoch(epoch)
        n = 0
        for g, w in zip(got_loader, want_loader):
            for name in ("feats", "seq_idx", "nsegs", "weight"):
                a, b = getattr(g, name), getattr(w, name)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=name)
            assert g.num_real == w.num_real
            n += 1
        assert n == len(want_loader)
    tail = list(got_loader.batches_from(2))
    assert len(tail) == len(got_loader) - 2
    sub = port_loader.SegmentLoader(got_ds, 4, shuffle=False,
                                    indices=np.array([5, 1, 3]))
    ref = jax_loader.SegmentLoader(want_ds, 4, shuffle=False,
                                   indices=np.array([5, 1, 3]))
    np.testing.assert_array_equal(next(iter(sub)).feats,
                                  next(iter(ref)).feats)


def test_bfloat16_batches_equal_ml_dtypes():
    """``transfer_dtype="bfloat16"`` batches: the port rounds through torch
    and ships ``torch.bfloat16`` tensors; their bits are the JAX loader's
    ``ml_dtypes.bfloat16`` arrays' (round to nearest even), ties and
    subnormals included."""
    want_store, got_store = stores()
    kw = dict(seg_len=20, seg_shift=8, seed=5)
    want_ds = jax_segments.SegmentDataset(want_store, **kw)
    got_ds = port_segments.SegmentDataset(got_store, **kw)
    # exact ties between two bf16 values and subnormals in the store
    for ds in (want_ds, got_ds):
        ds.store.data[0, :4] = np.array([1 + 2**-8, 1 + 3 * 2**-8, 2**-130,
                                         -(1 + 2**-8)], np.float32)
    lkw = dict(shuffle=False, seed=5, prefetch=0, transfer_dtype="bfloat16")
    want = list(jax_loader.SegmentLoader(want_ds, 8, **lkw))
    got = list(port_loader.SegmentLoader(got_ds, 8, **lkw))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.feats.dtype == torch.bfloat16
        assert g.feats.shape == w.feats.shape
        np.testing.assert_array_equal(g.feats.view(torch.int16).numpy(),
                                      w.feats.view(np.int16))
        np.testing.assert_array_equal(g.seq_idx, w.seq_idx)


def stream_sources(dtype: str, batch: int = 4):
    """Both packages' streamed sources over the same store, in chunks of
    up to 60 rows."""
    chunk_bytes = 60 * 6 * port_device_store.staging_itemsize(dtype)
    want_store, got_store = stores()
    kw = dict(seg_len=10, seg_shift=4, seed=5)
    want_ds = jax_segments.SegmentDataset(want_store, **kw)
    got_ds = port_segments.SegmentDataset(got_store, **kw)
    return (jax_stream_store.StreamingDeviceSource(
                want_ds, chunk_bytes, batch, store_dtype=dtype),
            port_stream_store.StreamingDeviceSource(
                got_ds, chunk_bytes, batch, torch.device("cpu"), dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_stream_partition_schedule_and_plans(dtype):
    """The streamed tier's host half: chunks, the fixed slot and plan
    lengths, link bytes, and every chunk plan of two epochs' schedules."""
    want, got = stream_sources(dtype)
    assert got.chunks == [port_stream_store.ChunkSpec(**vars(c))
                          for c in want.chunks] and len(got.chunks) > 2
    assert (got.chunk_rows, got.plan_rows) == (want.chunk_rows,
                                               want.plan_rows)
    assert got.host_bytes_per_epoch() == want.host_bytes_per_epoch()
    lens, nsegs = got.dataset.store.lens, got.dataset.nsegs
    for item in (1, 2, 4):
        args = (lens, nsegs, 6, item, 1500)
        assert port_stream_store.partition_chunks(*args) == [
            port_stream_store.ChunkSpec(**vars(c))
            for c in jax_stream_store.partition_chunks(*args)]
    for seed in (0, 1_000_003):
        sched_g, sched_w = got.epoch_schedule(seed), want.epoch_schedule(seed)
        assert len(sched_g) == len(sched_w)
        for (cg, og), (cw, ow) in zip(sched_g, sched_w):
            assert vars(cg) == vars(cw)
            np.testing.assert_array_equal(og, ow)
            pg, *arrays_g = got._plan_for(cg, og)
            pw, *arrays_w = want._plan_for(cw, ow)
            assert (pg.n_real, pg.n_rows, pg.n_batches) == \
                (pw.n_real, pw.n_rows, pw.n_batches)
            for a, b in zip(arrays_g, arrays_w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_stream_partition_refuses_a_sequence_over_the_chunk():
    lens, nsegs = np.array([5, 40, 7]), np.array([1, 9, 1])
    for mod in (port_stream_store, jax_stream_store):
        with pytest.raises(ValueError, match="--stream-chunk-bytes"):
            mod.partition_chunks(lens, nsegs, 6, 4, 39 * 24)


@pytest.mark.parametrize("cap", [None, 0], ids=["cached", "over the cap"])
def test_stream_int8_chunks_quantize_as_jax(cap):
    """The int8 tier's per-chunk quantization, from the cache and past its
    byte cap (re-quantized per stage), equals the JAX package's staged
    chunk buffers."""
    want, got = stream_sources("int8")
    if cap is not None:
        got._qcache_left = cap
    for spec in got.chunks:
        for _ in range(2):
            q, scale, offset = got._quantized_chunk(spec)
            wq, wscale, woffset = want._stage_chunk(spec)
            np.testing.assert_array_equal(q, np.asarray(wq))
            np.testing.assert_array_equal(scale, np.asarray(wscale))
            np.testing.assert_array_equal(offset, np.asarray(woffset))
    assert bool(got._qcache) == (cap is None)


def test_loader_copy_holds_no_device_helpers():
    """The copy drops the functions that import jax."""
    assert not hasattr(port_loader, "device_prefetch")
    assert not hasattr(port_loader, "stack_prefetch")


# ---- device-store planning ------------------------------------------------

@pytest.mark.parametrize("pad_rows", [None, 64])
def test_build_epoch_plan(pad_rows):
    want_store, got_store = stores(mvn=False)
    want_ds = jax_segments.SegmentDataset(want_store, seg_len=20, seg_shift=8)
    got_ds = port_segments.SegmentDataset(got_store, seg_len=20, seg_shift=8)
    order = np.random.default_rng(2).permutation(len(want_ds))
    want = jax_device_store.build_epoch_plan(want_ds, order, 8, pad_rows)
    got = port_device_store.build_epoch_plan(got_ds, order, 8, pad_rows)
    for name in ("seq_idx", "abs_starts"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got.n_real, got.batch_size, got.n_rows, got.n_batches) == \
        (want.n_real, want.batch_size, want.n_rows, want.n_batches)
    assert got.batch_real_counts() == want.batch_real_counts()
    meta, meta_want = (m.EpochPlan.meta(13, 8)
                       for m in (port_device_store, jax_device_store))
    assert dataclasses.asdict(meta) == dataclasses.asdict(meta_want)
    with pytest.raises(ValueError, match="pad_rows"):
        port_device_store.build_epoch_plan(got_ds, order, 8, pad_rows=8)
    assert port_device_store.STORE_TAIL_SLACK == \
        jax_device_store.STORE_TAIL_SLACK


def outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("placement", ["host", "device", "stream", "auto",
                                       "elsewhere"])
def test_resolve_data_mode_and_placement(placement):
    _, store = stores(mvn=False)
    nbytes = store.data.nbytes
    for max_bytes in (nbytes, nbytes - 1):
        for legacy in (False, True):
            for hierarchical in (False, True):
                for dtype in ("float32", "int8"):
                    kw = dict(max_bytes=max_bytes, legacy=legacy,
                              store_dtype=dtype)
                    assert outcome(port_stream_store.resolve_data_mode,
                                   placement, store, hierarchical=hierarchical,
                                   **kw) == \
                        outcome(jax_stream_store.resolve_data_mode, placement,
                                store, hierarchical=hierarchical, **kw)
                    if placement != "stream":
                        assert outcome(
                            port_device_store.resolve_data_placement,
                            placement, store, **kw) == outcome(
                            jax_device_store.resolve_data_placement,
                            placement, store, **kw)
    for dtype in ("float32", "bfloat16", "int8"):
        assert port_device_store.staging_itemsize(dtype) == \
            jax_device_store.staging_itemsize(dtype)


# ---- corpus prep and the extraction drivers --------------------------------

def in_dir(monkeypatch, path: Path) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(path)
    return path


def test_synthetic_corpus(tmp_path, monkeypatch):
    # relative output dirs, so the manifests of both runs hold the same paths
    in_dir(monkeypatch, tmp_path / "port")
    got = port_synth.make_synthetic_corpus("corpus", num_speakers=3,
                                           utts_per_speaker=3, seed=4)
    in_dir(monkeypatch, tmp_path / "jax")
    want = jax_synth.make_synthetic_corpus("corpus", num_speakers=3,
                                           utts_per_speaker=3, seed=4)
    assert {k: str(v) for k, v in got.items()} == \
        {k: str(v) for k, v in want.items()}
    same_tree(tmp_path / "port", tmp_path / "jax")


def test_timit_prep(tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    dev_spk = (REPO / "misc" / "timit_dev_spk.list").read_text().split()[0]
    for spk, seed in (("fabc0", 1), (dev_spk, 2)):
        port_audio.write_wav(raw / "dr1" / spk / "sa1.wav", signal(seed, 800),
                             16000)
    for side, mod in (("port", port_timit), ("jax", jax_timit)):
        in_dir(monkeypatch, tmp_path / side)
        mod.process_timit(raw, "out")
    same_tree(tmp_path / "port", tmp_path / "jax")
    assert "fabc0_sa1" in (tmp_path / "port/out/train/wav.scp").read_text()
    assert dev_spk in (tmp_path / "port/out/dev/wav.scp").read_text()
    # the speaker lists travel with the package
    for name in ("timit_dev_spk.list", "timit_test_spk.list"):
        assert filecmp.cmp(Path(port_timit.__file__).parent / "data" / name,
                           Path(jax_timit.__file__).parent / "data" / name,
                           shallow=False)


def test_librispeech_prep(tmp_path, monkeypatch):
    raw = tmp_path / "LibriSpeech"
    for subset, seed in (("train-clean-100", 1), ("dev-clean", 2),
                         ("test-clean", 3)):
        port_audio.write_wav(raw / subset / "84" / "1" / f"84-1-000{seed}.wav",
                             signal(seed, 800), 16000)
    lists = (["train-clean-100"], ["dev-clean"], ["test-clean"])
    for side, mod in (("port", port_libri), ("jax", jax_libri)):
        in_dir(monkeypatch, tmp_path / side)
        mod.process_librispeech(raw, "out", "numpy", *lists)
    same_tree(tmp_path / "port", tmp_path / "jax")
    assert port_libri.find_audios(raw) == jax_libri.find_audios(raw)


@pytest.fixture
def wav_split(tmp_path, monkeypatch):
    """``train/wav.scp`` over four WAVs, in each of two working dirs."""
    wavs = {}
    for i in range(4):
        p = port_audio.write_wav(tmp_path / "wav" / f"u{i}.wav",
                                 signal(i, 5000 + 700 * i), 16000)
        wavs[f"u{i}"] = str(p)
    for side in ("port", "jax"):
        (tmp_path / side / "ds" / "train").mkdir(parents=True)
        port_manifest.write_scp(tmp_path / side / "ds" / "train" / "wav.scp",
                                wavs)
    return tmp_path


@pytest.mark.parametrize("num_workers", [0, 2])
def test_prepare_numpy(wav_split, monkeypatch, num_workers):
    for side, mod in (("port", port_extract), ("jax", jax_extract)):
        monkeypatch.chdir(wav_split / side)
        count, _ = mod.prepare_numpy("x", "train", "ds", verbose=False,
                                     num_workers=num_workers, n_mels=40)
        assert count == 4
    same_tree(wav_split / "port", wav_split / "jax")


@pytest.mark.parametrize("use_native", [False, True])
def test_prepare_kaldi(wav_split, monkeypatch, use_native):
    conf = REPO / "misc" / "fbank.conf"
    for side, mod in (("port", port_extract), ("jax", jax_extract)):
        monkeypatch.chdir(wav_split / side)
        count, _ = mod.prepare_kaldi("ds", "train", conf, verbose=False,
                                     use_native=use_native, dither_seed=3)
        assert count == 4
    same_tree(wav_split / "port", wav_split / "jax")


def test_pipeline_paths_and_preprocess(tmp_path, monkeypatch):
    cfg_kw = dict(dataset="synthetic", synthetic_speakers=2, synthetic_utts=3)
    want_cfg = jax_config.ExperimentConfig(
        data=jax_config.DataConfig(**cfg_kw))
    got_cfg = port_config.ExperimentConfig(
        data=port_config.DataConfig(**cfg_kw))
    assert port_pipeline.SPLITS == jax_pipeline.SPLITS
    assert port_pipeline.dataset_directory(got_cfg, "r") == \
        jax_pipeline.dataset_directory(want_cfg, "r")
    assert port_pipeline.split_manifests(got_cfg, "r") == \
        jax_pipeline.split_manifests(want_cfg, "r")
    in_dir(monkeypatch, tmp_path / "port")
    got = port_pipeline.preprocess_data(got_cfg, root="r")
    in_dir(monkeypatch, tmp_path / "jax")
    want = jax_pipeline.preprocess_data(want_cfg, root="r")
    assert got == want
    same_tree(tmp_path / "port", tmp_path / "jax")


# ---- training curves ------------------------------------------------------

def test_write_curves_svg(tmp_path, monkeypatch):
    """``curves.svg`` of the same history (one series empty), byte for byte:
    matplotlib's date and id salt pinned, as two runs' files differ in
    them alone."""
    import matplotlib

    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    monkeypatch.setitem(matplotlib.rcParams, "svg.hashsalt", "sfhvae")
    values = {"train_loss_results": {"0": 2.5e3, "1": 2.1e3, "2": 1.9e3},
              "val_loss_results": {"0": 2.4e3, "1": 2.2e3},
              "lower_bound_results": {"0": -2.3e3, "1": -2.0e3}}
    assert port_plots.SERIES == jax_plots.SERIES
    for name, plots, metrics in (("port", port_plots, port_metrics),
                                 ("jax", jax_plots, jax_metrics)):
        assert plots.write_curves_svg(metrics.MetricHistory(values),
                                      tmp_path / f"{name}.svg", "run_id")
    assert (tmp_path / "port.svg").read_bytes() == \
        (tmp_path / "jax.svg").read_bytes()
    assert not list(tmp_path.glob("*.tmp"))
