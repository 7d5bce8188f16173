"""The port's on-device feature extractor against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through both. Three layers:

- ``ops/fbank_cuda.py``: the plain version ``logmel_frames_reference`` (what
  the wrapper runs for a CPU tensor, and what the CUDA kernel is held to on
  the card) against the Pallas kernel in interpret mode and against the jnp
  mirror. Limit 2e-4 absolute and relative on the log-mel: the JAX package's
  own limit between its kernel and its mirror (tests/test_fbank_pallas.py),
  set by the order of a 400-term float32 sum;
- ``features/dsp_torch.py``: ``batched_features`` against the reference's with
  its kernel on (interpret mode) and off, limit 3e-4 (the reference's own for
  the whole chain), frame counts equal exactly;
- ``featurize_signals`` against the reference's and against the port's host
  extractor ``generate_feat``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.features import dsp_jax
from pytorch_scalablefhvae_tpu.ops import fbank_pallas
from pytorch_scalablefhvae_tpu_torch.features import dsp_torch
from pytorch_scalablefhvae_tpu_torch.features.extract import generate_feat
from pytorch_scalablefhvae_tpu_torch.ops import fbank_cuda

KERNEL_TOL = dict(atol=2e-4, rtol=2e-4)
CHAIN_TOL = dict(atol=3e-4, rtol=3e-4)
CPU = torch.device("cpu")


def consts(n_fft=400, n_mels=80, sr=16000):
    """(w, C, S, fb_t) as numpy, from the port's cached constants."""
    w, C, S, _, fb_t = dsp_torch._spectral_consts(
        sr, n_fft, n_fft, "hamming", n_mels, "slaney", True, CPU)
    return tuple(t.numpy() for t in (w, C, S, fb_t))


def port_logmel(fn, frames, cs, **kw):
    return fn(*(torch.from_numpy(np.ascontiguousarray(a))
                for a in (frames, *cs)), **kw).numpy()


@pytest.mark.parametrize("n", [1, 37, 256, 300])
def test_plain_version_matches_pallas_kernel_and_jnp_mirror(n):
    cs = consts()
    frames = np.random.default_rng(n).standard_normal((n, 400)).astype(
        np.float32)
    got = port_logmel(fbank_cuda.logmel_frames_reference, frames, cs)
    assert got.shape == (n, 80) and got.dtype == np.float32
    j = [jnp.asarray(a) for a in (frames, *cs)]
    kernel = np.asarray(fbank_pallas.fused_logmel_frames(*j, interpret=True))
    mirror = np.asarray(fbank_pallas.logmel_frames_reference(*j))
    np.testing.assert_allclose(got, kernel, **KERNEL_TOL)
    np.testing.assert_allclose(got, mirror, **KERNEL_TOL)
    # on a CPU tensor the wrapper is the plain version, and counts no launch
    before = fbank_cuda.fused_logmel_frames.launches
    np.testing.assert_array_equal(
        port_logmel(fbank_cuda.fused_logmel_frames, frames, cs), got)
    assert fbank_cuda.fused_logmel_frames.launches == before


@pytest.mark.parametrize("log_floor", [-20.0, -30.0, -50.0])
def test_silent_frames_reach_the_log_floor(log_floor):
    """All-zero frames: every magnitude is sqrt(1e-30) = 1e-15 and a mel band
    sums to about 1e-17 (log = -39): the floor where it lies above that, the
    small sum itself where it lies below, as in the Pallas kernel."""
    cs = consts()
    frames = np.zeros((8, 400), np.float32)
    got = port_logmel(fbank_cuda.fused_logmel_frames, frames, cs,
                      log_floor=log_floor)
    kernel = np.asarray(fbank_pallas.fused_logmel_frames(
        *(jnp.asarray(a) for a in (frames, *cs)), log_floor=log_floor,
        interpret=True))
    assert np.isfinite(got).all()
    if log_floor > -35.0:
        np.testing.assert_array_equal(got, np.full((8, 80), log_floor,
                                                   np.float32))
    else:
        assert (got > log_floor).all() and (got < -35.0).all()
    np.testing.assert_allclose(got, kernel, **KERNEL_TOL)


def test_empty_bank_clamps_at_the_tiny_floor():
    """A mel band with no weight gives mel = 0: log(max(0, 1e-38)) is finite
    (-87.5) without a floor above it, not -inf."""
    w, C, S, fb_t = consts(n_fft=64, n_mels=8)
    fb_t = np.zeros_like(fb_t)
    frames = np.random.default_rng(0).standard_normal((4, 64)).astype(
        np.float32)
    got = port_logmel(fbank_cuda.logmel_frames_reference, frames,
                      (w, C, S, fb_t), log_floor=-1000.0)
    np.testing.assert_allclose(got, np.log(np.float32(1e-38)), rtol=1e-6)


@pytest.mark.parametrize("n_fft,win,n_mels", [(400, 400, 80), (128, 100, 40),
                                              (65, 65, 20)])
def test_spectral_constants_equal_the_references_to_the_bit(n_fft, win,
                                                            n_mels):
    want = dsp_jax._spectral_consts(16000, n_fft, win, "hamming", n_mels,
                                    "slaney", True)
    got = dsp_torch._spectral_consts(16000, n_fft, win, "hamming", n_mels,
                                     "slaney", True, CPU)
    for name, g, w in zip(("window", "cos", "sin", "mel bank"), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[3]).T)
    assert got[4].is_contiguous()
    # the spec path's placeholder bank, and the cache: one upload per
    # configuration and device
    spec = dsp_torch._spectral_consts(16000, n_fft, win, "hamming", n_mels,
                                      "slaney", False, CPU)
    assert tuple(spec[3].shape) == (0, n_fft // 2 + 1)
    again = dsp_torch._spectral_consts(16000, n_fft, win, "hamming", n_mels,
                                       "slaney", True, torch.device("cpu"))
    assert all(a is b for a, b in zip(got, again))


def ragged_batch(T=2400, lengths=(2400, 1931, 1000, 37, 20)):
    rng = np.random.default_rng(11)
    y = (0.1 * rng.standard_normal((len(lengths), T))).astype(np.float32)
    return y, np.asarray(lengths, np.int32)


# small widths: the reference's kernel runs in interpret mode here
CASES = {
    "fbank": dict(sr=8000, n_fft=128, win_t=0.016, n_mels=20),
    # rows 3 and 4 have L <= n_fft // 2: zero-padded, not reflected
    "short-rows": dict(sr=8000, n_fft=128, win_t=0.016, n_mels=12,
                       preemphasis=0.0),
    # odd n_fft: the frame count is 1 + (L - 1) // hop
    "odd-n_fft": dict(sr=8000, n_fft=101, win_t=101 / 8000 + 1e-9, n_mels=16),
    "win<n_fft": dict(sr=8000, n_fft=128, win_t=0.0125, n_mels=16,
                      window="hann", norm_mel=None, log_floor=-8.0),
    "spec": dict(sr=8000, n_fft=64, win_t=0.008, feat_type="spec",
                 log_floor=-50.0),
    "no-log": dict(sr=8000, n_fft=64, win_t=0.008, n_mels=10, log=False),
    "fft": dict(sr=8000, n_fft=64, win_t=0.008, n_mels=10, use_fft=True),
}


@pytest.mark.parametrize("use_pallas", ["always", "never"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_features_match_the_reference(case, use_pallas):
    kw = CASES[case]
    y, lengths = ragged_batch()
    want, nf_want = dsp_jax.batched_features(
        jnp.asarray(y), jnp.asarray(lengths), use_pallas=use_pallas, **kw)
    got, nf = dsp_torch.batched_features(y, lengths, device="cpu",
                                         fbank_pallas=use_pallas, **kw)
    assert nf.dtype == torch.int32
    np.testing.assert_array_equal(nf.numpy(), np.asarray(nf_want))
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **CHAIN_TOL)
    for b in range(len(lengths)):  # frames past a row's count stay zero
        assert np.all(got[b, int(nf[b]):] == 0.0)
        assert np.all(got[b, :int(nf[b])] != 0.0) or kw.get("log") is False


def test_batched_features_ignore_what_lies_past_each_length():
    y, lengths = ragged_batch()
    kw = CASES["fbank"]
    clean, _ = dsp_torch.batched_features(y, lengths, device="cpu", **kw)
    dirty = y.copy()
    for b, n in enumerate(lengths):
        dirty[b, n:] = 7.0
    got, _ = dsp_torch.batched_features(dirty, lengths, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), clean.numpy())


def test_batched_features_refuse_bad_settings(monkeypatch):
    y, lengths = ragged_batch()
    kw = CASES["fbank"]
    with pytest.raises(ValueError, match="feat_type"):
        dsp_torch.batched_features(y, lengths, device="cpu",
                                   **{**kw, "feat_type": "mfcc"})
    with pytest.raises(ValueError, match="fbank_pallas"):
        dsp_torch.batched_features(y, lengths, device="cpu",
                                   fbank_pallas="sometimes", **kw)
    # no GPU here: the default device raises, it does not fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dsp_torch.batched_features(y, lengths, **kw)
    with pytest.raises(RuntimeError, match="is_available"):
        dsp_torch.featurize_signals({"a": y[0]}, 8000)


def signals(sr=16000):
    rng = np.random.default_rng(5)
    out = {}
    # 70 utterances: three length-sorted batches of 32, two bucket sizes
    for i, n in enumerate([30, 200, 4000, 16384, 16385, 20000]
                          + list(range(5000, 5000 + 64 * 37, 37))):
        t = np.arange(n) / sr
        out[f"u{i:02d}"] = (0.3 * np.sin(2 * np.pi * (150 + 9 * i) * t)
                            + 0.03 * rng.standard_normal(n)).astype(np.float32)
    return out


@pytest.mark.parametrize("ftype", ["fbank", "spec"])
def test_featurize_signals_match_reference_and_host_extractor(ftype):
    sig = signals()
    kw = dict(ftype=ftype, n_mels=24)
    got = dsp_torch.featurize_signals(sig, 16000, device="cpu", **kw)
    want = dsp_jax.featurize_signals(sig, 16000, use_pallas="never", **kw)
    assert set(got) == set(want) == set(sig)
    for k in sig:
        host = generate_feat(ftype, sig[k], 16000, n_mels=24)
        assert got[k].shape == want[k].shape == host.shape, k
        assert got[k].dtype == np.float32
        # float32 round-off of a 400-term sum is absolute in the magnitude:
        # a mel band sums it away, a single near-empty spectral bin shows it
        # amplified on the log scale. So the log-spectrogram is held where
        # the bin carries energy, and everywhere as a magnitude
        on = want[k] > -5.0 if ftype == "spec" else np.ones_like(want[k], bool)
        assert on.mean() > 0.5
        np.testing.assert_allclose(got[k][on], want[k][on], err_msg=k,
                                   **CHAIN_TOL)
        np.testing.assert_allclose(np.exp(got[k]), np.exp(want[k]), atol=1e-5,
                                   rtol=3e-4, err_msg=k)
        # the host extractor is an FFT in float64; the reference's own
        # numpy-vs-jax test compares where the reference carries energy
        on = host > (-5.0 if ftype == "spec" else -15.0)
        np.testing.assert_allclose(got[k][on], host[on], atol=2e-3, rtol=2e-3,
                                   err_msg=k)


def test_featurize_signals_sink_hands_off_each_result():
    sig = signals()
    kept = dsp_torch.featurize_signals(sig, 16000, device="cpu", n_mels=24)
    seen = {}

    def sink(key, feat):
        assert key not in seen
        seen[key] = feat

    assert dsp_torch.featurize_signals(sig, 16000, device="cpu", n_mels=24,
                                       sink=sink) == {}
    # handed off in length order, batch by batch
    assert list(seen) == sorted(sig, key=lambda k: len(sig[k]))
    for k in sig:
        np.testing.assert_array_equal(seen[k], kept[k])
        assert seen[k].base is None  # a copy, not a view of the batch


def test_requiring_a_gradient_raises():
    cs = [torch.from_numpy(a) for a in consts(n_fft=64, n_mels=8)]
    frames = torch.randn(4, 64, requires_grad=True)
    with pytest.raises(NotImplementedError, match="inference-only"):
        fbank_cuda.fused_logmel_frames(frames, *cs)
    with torch.no_grad():
        out = fbank_cuda.fused_logmel_frames(frames, *cs)
    assert not out.requires_grad
    # the plain chain differentiates, as the jnp chain does
    fbank_cuda.logmel_frames_reference(frames, *cs).sum().backward()
    assert torch.isfinite(frames.grad).all()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    w, C, S, fb_t = (torch.from_numpy(a) for a in consts(n_fft=64, n_mels=8))
    frames = torch.zeros(4, 64)
    for bad in (dict(frames=torch.zeros(4, 60)), dict(frames=torch.zeros(64)),
                dict(window=torch.zeros(63)), dict(cos=C[:, :-1]),
                dict(fb_t=fb_t[:-1]), dict(frames=frames.double()),
                dict(sin=S.double())):
        args = dict(frames=frames, window=w, cos=C, sin=S, fb_t=fb_t)
        args.update(bad)
        with pytest.raises(ValueError):
            fbank_cuda.fused_logmel_frames(*args.values())


def test_cuda_tensor_never_falls_back_to_the_plain_version(monkeypatch):
    """A tensor that does not lie on the CPU goes to the kernel's build, which
    has no compiler here: the wrapper raises and never computes the plain
    version in its place."""
    cs = [torch.from_numpy(a).to("meta") for a in consts(n_fft=64, n_mels=8)]
    frames = torch.zeros(4, 64, device="meta")

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(fbank_cuda, "logmel_frames_reference", no_plain)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fbank_cuda.fused_logmel_frames(frames, *cs)
