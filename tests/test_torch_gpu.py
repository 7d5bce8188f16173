"""The port's CUDA kernels against their plain versions, on a GPU.

Each test needs a CUDA device (a CUDA kernel has no CPU mode) and skips
without one. This file imports no jax, so it also runs where jax is not
installed; there, skip the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

chip_smoke.py checks the same kernels at the serving and training shapes.
"""

import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu_torch.ops import (
    discriminative,
    fbank_cuda,
    lstm_cuda,
    window_gather,
)

pytestmark = pytest.mark.gpu

T, B, D, H = 7, 37, 24, 64  # B not a multiple of the kernel's row tile


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pytorch_scalablefhvae_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


def stack(g, d_in, dev):
    cells = []
    for d in (d_in, H):
        w = (torch.rand((d + H, 4 * H), generator=g) * 2 - 1) * 0.15
        b = torch.randn(4 * H, generator=g) * 0.1
        cells.append((w.to(dev), b.to(dev)))
    return cells


# bf16: the kernel sits within 3.2e-5 of the plain bf16 version, and the
# plain fp32 version misses it by 5.2e-4 or more at these shapes (NVIDIA H100
# 80GB HBM3, 700 W); the test checks that gap, so the limit fails a kernel
# that skipped the rounding
@pytest.mark.parametrize("mm,tol", [("float32", 1e-5), ("bfloat16", 2e-4)])
def test_lstm_entries_match_plain(cuda, mm, tol):
    g = torch.Generator().manual_seed(0)
    cells = stack(g, D + 4, cuda)
    x = torch.randn((T, B, D), generator=g).to(cuda)
    xgc = torch.randn((B, 4 * H), generator=g).to(cuda)
    xg3 = torch.randn((T, B, 4 * H), generator=g).to(cuda)
    calls = [
        ("lstm2_tm_proj", (cells, x, None, mm)),
        ("lstm2_tm_proj", (cells, x, xgc, mm)),
        ("lstm2_tm", (cells, xgc, T, mm)),
        ("lstm2_tm", (cells, xg3, None, mm)),
    ]
    for name, args in calls:
        before = getattr(lstm_cuda, name).launches
        got = getattr(lstm_cuda, name)(*args)
        want = getattr(lstm_cuda, name + "_reference")(*args)
        torch.cuda.synchronize()
        assert getattr(lstm_cuda, name).launches == before + 1
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= tol, name
        if mm == "bfloat16":
            f32 = getattr(lstm_cuda, name + "_reference")(*args[:-1],
                                                          "float32")
            gap = max(float((a - b).abs().max()) for a, b in zip(f32, want))
            assert gap > tol, (name, gap)


def test_discriminative_matches_plain(cuda):
    g = torch.Generator().manual_seed(1)
    n, num_real = 3001, 2990
    mu2 = torch.randn((n, 16), generator=g)
    seq = torch.randint(0, num_real, (B,), generator=g)
    z2 = mu2[seq] + 0.5 * torch.randn((B, 16), generator=g)
    seq[3] = n + 5
    args = (z2.to(cuda), mu2.to(cuda), seq.to(cuda), float(np.log(0.25)),
            num_real)
    got = discriminative.discriminative_log_qy(*args)
    want = discriminative.discriminative_log_qy_reference(*args)
    assert float((got - want).abs().max()) <= 1e-4


def rel_norm(got, want) -> float:
    return max(float((a - b).norm() / b.norm().clamp_min(1e-30))
               for a, b in zip(got, want) if b is not None)


# Backward, relative Frobenius norm per output: fp32 sum-order noise in fp32;
# in bf16 a gate adjoint on a rounding boundary may round the other way under
# another sum order (tests/test_torch_lstm_bwd.py), so 1e-3, which the plain
# fp32-vs-bf16 backward gap must exceed (checked here)
@pytest.mark.parametrize("mm,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_lstm_backward_entries_match_plain(cuda, mm, tol):
    g = torch.Generator().manual_seed(2)
    cells = stack(g, D + 4, cuda)
    (w1, b1), (w2, b2) = cells
    w = (w1[:D], w1[-H:], w2[:H], w2[H:], b2)
    x = torch.randn((T, B, D), generator=g).to(cuda)
    xgc = torch.randn((B, 4 * H), generator=g).to(cuda)
    g_tops = torch.randn((T, B, H), generator=g).to(cuda)
    g_h2 = torch.randn((B, H), generator=g).to(cuda)
    cases = []
    for xg in (b1.reshape(1, -1), xgc):
        tops, _, res = lstm_cuda._proj_forward_plain(x, xg, *w, mm,
                                                       with_resid=True)
        cases.append(("lstm2_tm_proj_bwd",
                      lambda fn, m, xg=xg, tops=tops, res=res: fn(
                          x, xg, res, tops, *w, g_tops, g_h2, m)))
    for xg1 in (xgc, torch.randn((T, B, 4 * H), generator=g).to(cuda)):
        tops, _, res = lstm_cuda._tm_forward_plain(xg1, T, *w[1:], mm,
                                                   with_resid=True)
        cases.append(("lstm2_tm_bwd",
                      lambda fn, m, xg1=xg1, tops=tops, res=res: fn(
                          xg1, T, res, tops, *w[1:], g_tops, None, m)))
    for name, call in cases:
        before = getattr(lstm_cuda, name).launches
        got = call(getattr(lstm_cuda, name), mm)
        again = call(getattr(lstm_cuda, name), mm)
        want = call(getattr(lstm_cuda, name + "_reference"), mm)
        torch.cuda.synchronize()
        assert getattr(lstm_cuda, name).launches == before + 2
        assert all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None), name  # no atomics: the same bits
        assert rel_norm(got, want) <= tol, name
        if mm == "bfloat16":
            f32 = call(getattr(lstm_cuda, name + "_reference"), "float32")
            assert rel_norm(f32, want) > tol, name


def test_discriminative_backward_matches_plain(cuda):
    g = torch.Generator().manual_seed(3)
    n, num_real = 3001, 2990
    mu2 = torch.randn((n, 16), generator=g)
    seq = torch.randint(0, num_real, (B,), generator=g)
    z2 = mu2[seq] + 0.5 * torch.randn((B, 16), generator=g)
    seq[3] = n + 5
    gq = torch.randn((B,), generator=g)
    z2, mu2, seq, gq = (t.to(cuda) for t in (z2, mu2, seq, gq))
    logvar = float(np.log(0.25))
    _, lse = discriminative._forward_plain(z2, mu2, seq, logvar, num_real)
    args = (z2, mu2, seq, lse, gq, logvar, num_real)
    before = discriminative.discriminative_log_qy_bwd.launches
    got = discriminative.discriminative_log_qy_bwd(*args)
    again = discriminative.discriminative_log_qy_bwd(*args)
    want = discriminative.discriminative_log_qy_bwd_reference(*args)
    assert discriminative.discriminative_log_qy_bwd.launches == before + 2
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        assert float((a - c).abs().max()) <= 1e-4 * float(c.abs().max())
    assert (got[1][num_real:] == 0).all()


def test_model_gradients_through_kernels_match_plain(cuda):
    """One backward of the whole model's loss on the card: through the
    kernels' Functions and through the plain versions (fp32 operands)."""
    from pytorch_scalablefhvae_tpu_torch.models.base import loss_from_outputs
    from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE

    model = FHVAE(T * 8, z1_hus=(H, H), z2_hus=(H, H), x_hus=(H, H),
                  z1_dim=4, z2_dim=4, num_seqs=50, feat_dim=8,
                  lstm_mm_dtype="float32",
                  generator=torch.Generator().manual_seed(4)).to(cuda)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((B, T, 8), generator=g).to(cuda)
    seq = torch.randint(0, 50, (B,), generator=g).to(cuda)
    nsegs = torch.full((B,), 3.0, device=cuda)
    noise = {"z2": torch.randn((B, 4), generator=g).to(cuda),
             "z1": torch.randn((B, 4), generator=g).to(cuda)}

    def grads():
        out = model.apply(x, seq, nsegs, sample=True, noise=noise)
        loss, _ = loss_from_outputs(out, torch.ones(B, device=cuda), 10.0)
        return torch.autograd.grad(loss, list(model.parameters()))

    got = grads()
    saved = (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
             discriminative.discriminative_log_qy)
    lstm_cuda.lstm2_tm_proj = lstm_cuda.lstm2_tm_proj_reference
    lstm_cuda.lstm2_tm = lstm_cuda.lstm2_tm_reference
    discriminative.discriminative_log_qy = \
        discriminative.discriminative_log_qy_reference
    try:
        want = grads()
    finally:
        (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
         discriminative.discriminative_log_qy) = saved
    assert rel_norm(got, want) <= 1e-4


# a copy: the kernel must equal its plain version bit for bit. D 80 takes
# the 16-byte path; D 6, and a store that is not 16-byte aligned, the
# 4-byte one
@pytest.mark.parametrize("d,offset", [(80, 0), (6, 0), (8, 1)],
                         ids=["16-byte copies", "D*4 % 16 != 0", "unaligned"])
def test_window_gather_matches_plain(cuda, d, offset):
    g = torch.Generator().manual_seed(6)
    n, spb, seg_len, stride = 700, 16, 20, 8
    flat = torch.randn((n * d + offset,), generator=g).to(cuda)
    store = flat[offset:].view(n, d)
    region = (spb - 1) * stride + seg_len
    # the last chunks run past the store's end: those rows read zero
    starts = torch.tensor([0, 3, 250, n - region, n - region + 7, n - 1],
                          device=cuda)
    fn = window_gather.windowed_chunk_gather
    before = fn.launches
    got = fn(store, starts, spb, seg_len, stride)
    again = fn(store, starts, spb, seg_len, stride)
    want = window_gather.windowed_chunk_gather_reference(store, starts, spb,
                                                         seg_len, stride)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(got, want) and torch.equal(got, again)
    assert not got[-spb:, 1:].any()


def test_chunked_map_pass_through_the_kernel(cuda):
    """The dev MAP pass on the card: through the gather kernel and through
    the plain gather, equal; two passes give the same bits."""
    from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
    from pytorch_scalablefhvae_tpu_torch.train import device_step

    g = torch.Generator().manual_seed(7)
    lens = torch.randint(20, 90, (37,), generator=g)
    nsegs = (lens - 20) // 8 + 1
    starts = torch.cumsum(lens, 0) - lens
    rows = int(lens.sum())
    store = torch.zeros((rows + 256, 8))
    store[:rows] = torch.randn((rows, 8), generator=g)
    model = FHVAE(20 * 8, z1_hus=(H, H), z2_hus=(H, H), x_hus=(H, H),
                  z1_dim=4, z2_dim=4, num_seqs=37, feat_dim=8,
                  generator=torch.Generator().manual_seed(8)).to(cuda)
    padded = int(((nsegs + 15) // 16 * 16).sum())
    kw = dict(seg_len=20, seg_shift=8, batch_size=64,
              n_batches=-(-padded // 64), num_rows=37, pz2_var=0.25)
    args = (model, store.to(cuda), starts.to(cuda), nsegs.to(cuda))
    before = window_gather.windowed_chunk_gather.launches
    got = device_step.device_map_pass_chunked(*args, **kw)
    again = device_step.device_map_pass_chunked(*args, **kw)
    assert window_gather.windowed_chunk_gather.launches \
        == before + 2 * kw["n_batches"]
    saved = device_step.windowed_chunk_gather
    device_step.windowed_chunk_gather = \
        window_gather.windowed_chunk_gather_reference
    try:
        want = device_step.device_map_pass_chunked(*args, **kw)
    finally:
        device_step.windowed_chunk_gather = saved
    assert torch.equal(got, again) and torch.equal(got, want)


def logmel_inputs(dev, n, n_fft=400, n_mels=80, seed=9):
    from pytorch_scalablefhvae_tpu_torch.features import dsp_torch

    w, C, S, _, fb_t = dsp_torch._spectral_consts(
        16000, n_fft, n_fft, "hamming", n_mels, "slaney", True, dev)
    g = torch.Generator().manual_seed(seed)
    frames = (0.1 * torch.randn((n, n_fft), generator=g)).to(dev)
    return frames, w, C, S, fb_t


# 2e-4 on the log-mel: the limit the JAX package holds its TPU kernel to
# against its jnp mirror; the order of a 400-term float32 sum differs
@pytest.mark.parametrize("n,n_fft,n_mels", [
    (6560, 400, 80), (1641, 400, 80), (1, 400, 80), (300, 400, 40),
    (77, 512, 80), (50, 101, 16)],
    ids=["serving", "ragged", "one frame", "40 mels", "n_fft 512",
         "odd n_fft"])
def test_fused_logmel_matches_plain(cuda, n, n_fft, n_mels):
    args = logmel_inputs(cuda, n, n_fft, n_mels)
    fn = fbank_cuda.fused_logmel_frames
    before = fn.launches
    got = fn(*args)
    again = fn(*args)
    want = fbank_cuda.logmel_frames_reference(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert got.shape == (n, n_mels) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) <= 2e-4
    # the limit can fail: a rectangular window misses it
    wrong = fn(args[0], torch.ones_like(args[1]), *args[2:])
    assert float((wrong - want).abs().max()) > 2e-4


@pytest.mark.parametrize("log_floor", [-20.0, -50.0])
def test_fused_logmel_silent_frames(cuda, log_floor):
    """All-zero frames among live ones: the floor where it lies above the
    tiny sum (about -39), the sum itself below, never -inf or NaN."""
    args = logmel_inputs(cuda, 70)
    args[0][5:40] = 0.0
    got = fbank_cuda.fused_logmel_frames(*args, log_floor=log_floor)
    want = fbank_cuda.logmel_frames_reference(*args, log_floor=log_floor)
    assert torch.isfinite(got).all()
    if log_floor == -20.0:
        assert bool((got[5:40] == log_floor).all())
    assert float((got - want).abs().max()) <= 2e-4


def test_fused_logmel_refusals_and_empty(cuda):
    frames, w, C, S, fb_t = logmel_inputs(cuda, 8)
    fn = fbank_cuda.fused_logmel_frames
    before = fn.launches
    assert fn(frames[:0], w, C, S, fb_t).shape == (0, 80)
    assert fn.launches == before  # nothing to launch
    with pytest.raises(ValueError, match="contiguous"):
        fn(frames.t().contiguous().t(), w, C, S, fb_t)
    with pytest.raises(ValueError, match="float32"):
        fn(frames.half(), w, C, S, fb_t)
    with pytest.raises(ValueError, match="is on"):
        fn(frames, w.cpu(), C, S, fb_t)
    with pytest.raises(NotImplementedError, match="inference-only"):
        fn(frames.clone().requires_grad_(), w, C, S, fb_t)
    big = logmel_inputs(cuda, 4, n_fft=2048)
    with pytest.raises(ValueError, match="shared memory"):
        fn(*big)


def test_batched_features_on_the_card_match_the_cpu(cuda):
    """The whole chain on the card (kernel) against the CPU (plain version),
    ragged lengths and a short row; ``never`` is refused on the card."""
    from pytorch_scalablefhvae_tpu_torch.features import dsp_torch

    g = torch.Generator().manual_seed(10)
    y = (0.1 * torch.randn((5, 20000), generator=g)).numpy()
    lengths = np.array([20000, 16385, 9000, 150, 1], np.int32)
    before = fbank_cuda.fused_logmel_frames.launches
    got, nf = dsp_torch.batched_features(y, lengths, sr=16000, device=cuda)
    want, nf_want = dsp_torch.batched_features(y, lengths, sr=16000,
                                               device="cpu")
    assert fbank_cuda.fused_logmel_frames.launches == before + 1
    assert torch.equal(nf.cpu(), nf_want)
    assert float((got.cpu() - want).abs().max()) <= 3e-4
    with pytest.raises(NotImplementedError, match="never"):
        dsp_torch.batched_features(y, lengths, sr=16000, device=cuda,
                                   fbank_pallas="never")
