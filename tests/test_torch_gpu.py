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
    _build,
    discriminative,
    fbank_cuda,
    lstm_cuda,
    window_gather,
)

pytestmark = pytest.mark.gpu

T, B, D, H = 7, 37, 24, 64  # B not a multiple of the kernel's row tile
DR_NOISE_DB = 40.0  # chip_smoke.py's: the parent's fp32 kernel read within
                    # half the limit there (PERF.md, row 9)


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
# that skipped the rounding. H 64: the FMA form in both operand modes
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
        before_tc = getattr(lstm_cuda, name).launches_tc
        got = getattr(lstm_cuda, name)(*args)
        want = getattr(lstm_cuda, name + "_reference")(*args)
        torch.cuda.synchronize()
        assert getattr(lstm_cuda, name).launches == before + 1
        assert getattr(lstm_cuda, name).launches_tc == before_tc
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


def forward_case(cuda, b, n, d, num_real, seed=11):
    """Inputs of the discriminative forward: ``z2`` near its rows of a unit
    scale table (logits of magnitude ~1e2 at d 32), one index outside the
    table (batch row 3, or 0 when b <= 3)."""
    g = torch.Generator().manual_seed(seed)
    mu2 = torch.randn((n, d), generator=g)
    seq = torch.randint(0, num_real, (b,), generator=g)
    z2 = mu2[seq] + 0.5 * torch.randn((b, d), generator=g)
    seq[min(3, b - 1)] = n + 5
    return z2.to(cuda), mu2.to(cuda), seq.to(cuda), float(np.log(0.25))


# log_qy and lse against the plain log-softmax: fp32 sum order over N rows
# at |logits| ~ 1e2
@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("n", [1, 129, 3001, 4620])
@pytest.mark.parametrize("b", [1, 63, 1000])
def test_discriminative_forward_matches_plain(cuda, b, n, d):
    num_real = n - n // 300        # padded rows from n 300 on
    z2, mu2, seq, logvar = forward_case(cuda, b, n, d, num_real)
    entry = discriminative.discriminative_log_qy
    before = entry.launches
    got = discriminative._forward_kernel(z2, mu2, seq, logvar, num_real, True)
    assert entry.launches == before + 1
    again = discriminative._forward_kernel(z2, mu2, seq, logvar, num_real,
                                           True)
    assert entry.launches == before + 2
    # the index read as int32 gives the same bits as int64
    narrow = discriminative._forward_kernel(z2, mu2, seq.int(), logvar,
                                            num_real, True)
    want = discriminative._forward_plain(z2, mu2, seq, logvar, num_real)
    torch.cuda.synchronize()
    for a, a2, a3, w in zip(got, again, narrow, want):
        assert torch.equal(a, a2) and torch.equal(a, a3)
        assert float((a - w).abs().max()) <= 1e-4
    assert torch.isfinite(got[0]).all()


# 4,620 rows: chunks of one table tile; 70,311 (a LibriSpeech-960 table over
# 4 shards): chunks of 9 tiles
@pytest.mark.parametrize("n", [4620, 70311])
@pytest.mark.parametrize("rows", [2048, 1024])
def test_discriminative_forward_rows_do_not_depend_on_the_split(cuda, rows,
                                                                n):
    """log_qy and lse of ``rows`` batch rows equal, bit for bit, the same
    rows computed as two halves: the table's chunks follow N alone."""
    z2, mu2, seq, logvar = forward_case(cuda, rows, n, 16, n - 7)
    whole = discriminative._forward_kernel(z2, mu2, seq, logvar, n - 7, True)
    half = rows // 2
    parts = [discriminative._forward_kernel(
        z2[lo:lo + half].contiguous(), mu2, seq[lo:lo + half], logvar, n - 7,
        True) for lo in (0, half)]
    for i in (0, 1):
        assert torch.equal(torch.cat([p[i] for p in parts]), whole[i])


def test_discriminative_shard_of_padding_reports_the_floor(cuda):
    """A shard made only of padding (rows 300-599 of a table with 300 real
    rows, the last of its tiles partial) reports m = -1e30 exactly, so that
    the merge without it gives the same bits."""
    z2, mu2, seq, logvar = forward_case(cuda, 63, 600, 16, 300)
    parts = [discriminative.shard_partials(z2, mu2[lo:lo + 300], seq, logvar,
                                           300, lo) for lo in (0, 300)]
    assert bool((parts[1][0] == -1e30).all())
    assert not parts[1][2].any()
    merged = discriminative.combine_shard_partials(parts)
    alone = discriminative.combine_shard_partials(parts[:1])
    for a, b in zip(merged, alone):
        assert torch.equal(a, b)


def rel_norm(got, want) -> float:
    return max(float((a - b).norm() / b.norm().clamp_min(1e-30))
               for a, b in zip(got, want) if b is not None)


# Backward, relative Frobenius norm per output: fp32 sum-order noise in fp32;
# in bf16 a gate adjoint on a rounding boundary may round the other way under
# another sum order (tests/test_torch_lstm_bwd.py), so 1e-3, which the plain
# fp32-vs-bf16 backward gap must exceed (checked here)
@pytest.mark.parametrize("n,m", [(203, 4), (37, 8), (5, 8)])
def test_sharded_discriminative_matches_plain(cuda, n, m):
    """Kernel #7 shard by shard: the partials kernel with each shard's row
    offset, merged as the entry merges them, and the per-shard backward,
    against the plain single-table forward and backward on the unpadded
    table; padded rows get exactly zero gradient; launches are counted."""
    from pytorch_scalablefhvae_tpu_torch.parallel.mesh import padded_num_seqs

    g = torch.Generator().manual_seed(7)
    pz2 = float(np.log(0.25))
    n_pad = padded_num_seqs(n, m)
    per = n_pad // m
    table = torch.zeros((n_pad, 16))
    table[:n] = torch.randn((n, 16), generator=g)
    seq = torch.randint(0, n, (B,), generator=g)
    z2 = (table[seq] + 0.5 * torch.randn((B, 16), generator=g)).to(cuda)
    seq[2] = n_pad + 1  # outside the table: picks nothing on any shard
    gq = torch.randn((B,), generator=g).to(cuda)
    table, seq = table.to(cuda), seq.to(cuda)
    shards = [table[j * per:(j + 1) * per].contiguous() for j in range(m)]
    fwd, bwd = (discriminative.discriminative_log_qy_sharded,
                discriminative.discriminative_log_qy_sharded_bwd)
    before = fwd.launches, bwd.launches
    parts = [discriminative.shard_partials(z2, shards[j], seq, pz2, n,
                                           j * per) for j in range(m)]
    got, lse = discriminative.combine_shard_partials(parts)
    back = [bwd(z2, shards[j], seq, lse, gq, pz2, n, j * per)
            for j in range(m)]
    assert (fwd.launches, bwd.launches) == (before[0] + m, before[1] + m)
    want, want_lse = discriminative._forward_plain(z2, table[:n], seq, pz2, n)
    want_dz2, want_dmu2 = discriminative.discriminative_log_qy_bwd_reference(
        z2, table[:n], seq, want_lse, gq, pz2, n)
    dmu2 = torch.cat([b[1] for b in back])
    assert float((got - want).abs().max()) <= 1e-4
    torch.testing.assert_close(sum(b[0] for b in back), want_dz2, rtol=1e-3,
                               atol=1e-4)
    torch.testing.assert_close(dmu2[:n], want_dmu2, rtol=1e-3, atol=1e-4)
    assert bool((dmu2[n:] == 0).all())
    for j in range(m):
        if j * per >= n:  # a shard of padding only
            assert bool((parts[j][0] == -1e30).all())


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
        before_tc = getattr(lstm_cuda, name).launches_tc
        got = call(getattr(lstm_cuda, name), mm)
        again = call(getattr(lstm_cuda, name), mm)
        want = call(getattr(lstm_cuda, name + "_reference"), mm)
        torch.cuda.synchronize()
        assert getattr(lstm_cuda, name).launches == before + 2
        # H 64: the FMA form in both operand modes
        assert getattr(lstm_cuda, name).launches_tc == before_tc
        assert all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None), name  # no atomics: the same bits
        assert rel_norm(got, want) <= tol, name
        if mm == "bfloat16":
            f32 = call(getattr(lstm_cuda, name + "_reference"), "float32")
            assert rel_norm(f32, want) > tol, name


def forward_width_cases(dev, rows, t=20, d=80, h=128, wscale=1.0):
    """The four forward forms at the fhvae stacks' widths (H 128, D 80) on
    ``rows`` batch rows: ``(entry name, kernel args (x, xadd, T, w1x, w1h,
    w2x, w2h, b2), plain(mm) -> (tops, h2, resid))``. Weights at ``wscale``
    times the model's init scale; given gates of standard deviation 0.5 (at
    1.0 the cells reach |c1| ~ 11 and every kernel, the FMA form too, errs by
    7.8e-4 there: the absolute limit below is one for these inputs)."""
    g = torch.Generator().manual_seed(12)
    cells = []
    for d_in in (d, h):
        limit = wscale * (6.0 / (d_in + h + 4 * h)) ** 0.5
        wgt = (torch.rand((d_in + h, 4 * h), generator=g) * 2 - 1) * limit
        cells.append((wgt.to(dev), (torch.randn(4 * h, generator=g) * 0.1)
                      .to(dev)))
    (w1, b1), (w2, b2) = cells
    w = (w1[:d], w1[-h:], w2[:h], w2[h:], b2)
    x = torch.randn((t, rows, d), generator=g).to(dev)
    xgc = (0.5 * torch.randn((rows, 4 * h), generator=g)).to(dev)
    xg3 = (0.5 * torch.randn((t, rows, 4 * h), generator=g)).to(dev)
    cases = []
    for xg in (b1.reshape(1, -1), xgc):
        cases.append(("lstm2_tm_proj", (x, xg, t, *w),
                      lambda mm, xg=xg: lstm_cuda._proj_forward_plain(
                          x, xg, *w, mm, with_resid=True)))
    for xg1 in (xgc, xg3):
        cases.append(("lstm2_tm", (None, xg1, t, None, *w[1:]),
                      lambda mm, xg1=xg1: lstm_cuda._tm_forward_plain(
                          xg1, t, *w[1:], mm, with_resid=True)))
    return cases


def max_abs(got, want) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


# H 128, T 20, as chip_smoke.py holds the entries: fp32 operands differ from
# the plain version by fp32 sum order; in bf16 that order can flip one bf16
# rounding of h (2^-9 relative), and the plain fp32-vs-bf16 gap must exceed
# the limit (checked here)
@pytest.mark.parametrize("rows", [1000, 64, 2048])
@pytest.mark.parametrize("mm,tol", [("float32", 1e-4), ("bfloat16", 6e-4)])
def test_lstm_forward_at_the_model_width(cuda, mm, tol, rows):
    """bf16 operands take the tensor-core form (``launches_tc`` rises), fp32
    operands the FMA form (it does not); with and without residuals and
    tops, on batches that fill their clusters (64: 16-row clusters, 2048:
    32-row clusters) and one that does not (1000); two launches the same
    bits."""
    for name, args, plain in forward_width_cases(cuda, rows):
        entry = getattr(lstm_cuda, name)
        want = plain(mm)
        before = entry.launches, entry.launches_tc
        full = lstm_cuda._forward_kernel(entry, *args, mm, True, True)
        again = lstm_cuda._forward_kernel(entry, *args, mm, True, True)
        tops_only = lstm_cuda._forward_kernel(entry, *args, mm, True, False)
        h2_only = lstm_cuda._forward_kernel(entry, *args, mm, False, False)
        torch.cuda.synchronize()
        assert entry.launches == before[0] + 4
        assert entry.launches_tc == before[1] + (4 if mm == "bfloat16" else 0)
        assert all(torch.equal(a, b) for a, b in zip(full, again)), name
        assert max_abs(full, want) <= tol, name
        assert tops_only[2] is None and h2_only[0] is None \
            and h2_only[2] is None
        assert torch.equal(tops_only[0], full[0])
        assert torch.equal(tops_only[1], full[1])
        assert torch.equal(h2_only[1], full[1])
        if mm == "bfloat16":
            assert max_abs(plain("float32"), want) > tol, name


def forward_parts(out, h=128):
    tops, h2, resid = out
    h1, c1, c2 = resid.split(h, dim=-1)
    return {"tops": tops, "h2": h2, "h1": h1, "c1": c1, "c2": c2}


# The absolute error of a bf16-operand forward grows with the weights and the
# cells (a bf16 flip of h moves a gate by ulp(h) |w|, and c carries it on):
# 1.5e-4 to 3.9e-4 at the model's init scale, up to 2.4e-3 at twice and
# 5.2e-3 at three times it, in both forms alike. Its share of what the bf16
# rounding itself does to the same output (plain fp32 against plain bf16
# operands) does not: 0.03 to 0.40 (tensor-core form) and 0.03 to 0.44 (FMA
# form) over all three scales (NVIDIA H100 80GB HBM3, 700 W). A kernel that
# skipped a rounding would read about 1.
@pytest.mark.parametrize("form", ["tc", "fma"])
@pytest.mark.parametrize("wscale", [1.0, 2.0, 3.0])
def test_lstm_forward_error_is_a_share_of_the_rounding_gap(cuda, wscale,
                                                           form):
    """Each of tops, h2, h1, c1, c2 on its own, both forms through their
    launchers, at three weight scales: a limit that does not depend on the
    scale of the inputs."""
    run = lstm_cuda._forward_tc if form == "tc" else lstm_cuda._forward_fma
    for name, args, plain in forward_width_cases(cuda, 1000, wscale=wscale):
        entry = getattr(lstm_cuda, name)
        before = entry.launches, entry.launches_tc
        got = forward_parts(run(entry, *args, "bfloat16", True, True))
        torch.cuda.synchronize()
        assert entry.launches == before[0] + 1
        assert entry.launches_tc == before[1] + (form == "tc")
        want = forward_parts(plain("bfloat16"))
        want32 = forward_parts(plain("float32"))
        for key in want:
            err = float((got[key] - want[key]).abs().max())
            gap = float((want32[key] - want[key]).abs().max())
            assert err <= 0.6 * gap, (name, key, err, gap)


def test_tensor_core_forward_pass_by_pass(cuda):
    """The tensor-core form against the plain forward in the same pass
    structure: the layer-1 gates after pass A (fp32 sum order only), tops, h2
    and the residuals after the chain."""
    for name, args, _ in forward_width_cases(cuda, 1000):
        streams = {}
        got = lstm_cuda._forward_kernel(getattr(lstm_cuda, name), *args,
                                        "bfloat16", True, True, streams)
        want, want_streams = lstm_cuda.lstm2_fwd_passes_reference(
            *args, "bfloat16")
        torch.cuda.synchronize()
        if args[0] is None:
            assert streams["xp"] is None
        else:
            assert rel_norm([streams["xp"]], [want_streams["xp"]]) <= 1e-5
        assert max_abs(got, want) <= 6e-4, name
    with pytest.raises(ValueError, match="tensor-core"):
        name, args, _ = forward_width_cases(cuda, 64)[0]
        lstm_cuda._forward_kernel(getattr(lstm_cuda, name), *args, "float32",
                                  True, True, {})


def test_tensor_core_forward_rows_do_not_depend_on_the_batch(cuda):
    """2048 rows (32-row clusters) against 2 x 1024 (16-row clusters), and
    1024 against 2 x 512: every row the same bits."""
    for rows in (2048, 1024):
        half = rows // 2
        for name, args, _ in forward_width_cases(cuda, rows):
            entry = getattr(lstm_cuda, name)

            def cut(a, lo):
                if a is None or a.shape[-2] != rows:
                    return a
                return a[..., lo:lo + half, :].contiguous()

            whole = lstm_cuda._forward_kernel(entry, *args, "bfloat16", True,
                                              True)
            parts = [lstm_cuda._forward_kernel(
                entry, cut(args[0], lo), cut(args[1], lo), *args[2:],
                "bfloat16", True, True) for lo in (0, half)]
            torch.cuda.synchronize()
            for w_, a, b in zip(whole, *parts):
                assert torch.equal(w_, torch.cat([a, b], dim=-2)), name


def model_width_cases(dev, rows, mm, t=7, d=80, h=128):
    """The four backward forms at the fhvae stacks' widths (H 128, D 80) on
    ``rows`` batch rows: ``(entry name, call(fn, mm, **kw), passes args)``."""
    g = torch.Generator().manual_seed(11)
    cells = []
    for d_in in (d, h):
        wgt = (torch.rand((d_in + h, 4 * h), generator=g) * 2 - 1) * 0.15
        cells.append((wgt.to(dev), (torch.randn(4 * h, generator=g) * 0.1)
                      .to(dev)))
    (w1, b1), (w2, b2) = cells
    w = (w1[:d], w1[-h:], w2[:h], w2[h:], b2)
    x = torch.randn((t, rows, d), generator=g).to(dev)
    xgc = torch.randn((rows, 4 * h), generator=g).to(dev)
    xg3 = torch.randn((t, rows, 4 * h), generator=g).to(dev)
    g_tops = torch.randn((t, rows, h), generator=g).to(dev)
    g_h2 = torch.randn((rows, h), generator=g).to(dev)
    cases = []
    # the encoders get only the cotangent of h2, the decoder only that of tops
    for xg, gt, gh in ((b1.reshape(1, -1), None, g_h2), (xgc, g_tops, g_h2)):
        tops, _, res = lstm_cuda._proj_forward_plain(x, xg, *w, mm,
                                                       with_resid=True)
        cases.append((
            "lstm2_tm_proj_bwd",
            lambda fn, m, xg=xg, tops=tops, res=res, gt=gt, gh=gh, **kw: fn(
                x, xg, res, tops, *w, gt, gh, m, **kw),
            (x, xg, t, res, tops, *w, gt, gh)))
    for xg1, gt, gh in ((xgc, g_tops, None), (xg3, g_tops, g_h2)):
        tops, _, res = lstm_cuda._tm_forward_plain(xg1, t, *w[1:], mm,
                                                   with_resid=True)
        cases.append((
            "lstm2_tm_bwd",
            lambda fn, m, xg1=xg1, tops=tops, res=res, gt=gt, gh=gh, **kw: fn(
                xg1, t, res, tops, *w[1:], gt, gh, m, **kw),
            (None, xg1, t, res, tops, None, *w[1:], gt, gh)))
    return cases


@pytest.mark.parametrize("rows", [1000, 64])
@pytest.mark.parametrize("mm,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_lstm_backward_at_the_model_width(cuda, mm, tol, rows):
    """H 128, D 80: bf16 operands take the tensor-core form (``launches_tc``
    rises), fp32 operands the FMA form (it does not); both against the plain
    backward, on a batch that fills its last 16-row cluster (64) and one that
    does not (1000), two launches the same bits."""
    for name, call, _ in model_width_cases(cuda, rows, mm):
        entry = getattr(lstm_cuda, name)
        before = entry.launches, entry.launches_tc
        got, again = call(entry, mm), call(entry, mm)
        want = call(getattr(lstm_cuda, name + "_reference"), mm)
        torch.cuda.synchronize()
        assert entry.launches == before[0] + 2
        assert entry.launches_tc == before[1] + (2 if mm == "bfloat16" else 0)
        assert all(torch.equal(a, b) for a, b in zip(got, again)
                   if a is not None), name
        assert [a is None for a in got] == [b is None for b in want]
        assert rel_norm(got, want) <= tol, name
        if mm == "bfloat16":
            f32 = call(getattr(lstm_cuda, name + "_reference"), "float32")
            assert rel_norm(f32, want) > tol, name


def test_tensor_core_backward_pass_by_pass(cuda):
    """The tensor-core form's streams against the plain backward in the same
    pass structure: the gates after pass A (fp32 sum order only), the bf16
    dgates after pass B against the plain dgates rounded to bf16."""
    for name, call, passes_args in model_width_cases(cuda, 1000, "bfloat16"):
        streams = {}
        call(getattr(lstm_cuda, name), "bfloat16", streams=streams)
        _, want = lstm_cuda.lstm2_bwd_passes_reference(*passes_args,
                                                       "bfloat16")
        torch.cuda.synchronize()
        for key in ("gates1", "gates2"):
            assert rel_norm([streams[key]], [want[key]]) <= 1e-5, (name, key)
        for key in ("dgates1", "dgates2"):
            assert streams[key].dtype == torch.bfloat16
            assert rel_norm([streams[key].float()],
                            [want[key].to(torch.bfloat16).float()]) <= 1e-3, \
                (name, key)
    with pytest.raises(ValueError, match="tensor-core"):
        name, call, _ = model_width_cases(cuda, 64, "float32")[0]
        call(getattr(lstm_cuda, name), "float32", streams={})


def backward_case(cuda, b, n, d, num_real, seed=3):
    """Inputs of the discriminative backward: ``z2`` near its rows of the
    table, one index outside the table (batch row 3, or 0 when b <= 3), the
    log-sum-exp of the plain forward. The table is drawn at a quarter of unit
    scale (less by sqrt(16 / d) above d 16), so the softmax spreads over
    several rows: where it saturates, as with one row or a few far-apart
    rows, a picked row's gradient g (1 - p) is only the rounding of its logit
    against lse, which no sum order can be held to (the plain fp32 backward
    itself then misses a float64 one by 1e-4 to 2e-4 of the largest
    gradient). chip_smoke.py holds the kernel at the main path's magnitudes."""
    g = torch.Generator().manual_seed(seed)
    mu2 = torch.randn((n, d), generator=g) * 0.25 * (16 / max(d, 16)) ** 0.5
    seq = torch.randint(0, num_real, (b,), generator=g)
    z2 = mu2[seq] + 0.5 * torch.randn((b, d), generator=g)
    seq[min(3, b - 1)] = n + 5
    gq = torch.randn((b,), generator=g)
    z2, mu2, seq, gq = (t.to(cuda) for t in (z2, mu2, seq, gq))
    logvar = float(np.log(0.25))
    _, lse = discriminative._forward_plain(z2, mu2, seq, logvar, num_real)
    return z2, mu2, seq, lse, gq, logvar, num_real


# fp32 sum order only: the kernel sums over N and B in another order than
# the plain products; the limit is relative to the largest gradient
@pytest.mark.parametrize("d", [1, 16, 32])
@pytest.mark.parametrize("n", [1, 129, 3001])
@pytest.mark.parametrize("b", [1, 63, 1024])
def test_discriminative_backward_matches_plain(cuda, b, n, d):
    num_real = n - n // 300        # padded rows from n 300 on
    args = backward_case(cuda, b, n, d, num_real)
    entry = discriminative.discriminative_log_qy_bwd
    before = entry.launches
    got = entry(*args)
    again = entry(*args)
    want = discriminative.discriminative_log_qy_bwd_reference(*args)
    torch.cuda.synchronize()
    assert entry.launches == before + 2
    for a, b_, c in zip(got, again, want):
        assert torch.equal(a, b_)
        assert float((a - c).abs().max()) <= 1e-4 * float(c.abs().max())
    assert (got[1][num_real:] == 0).all()


def test_discriminative_backward_rows_do_not_depend_on_the_split(cuda):
    """dz2 of 1024 batch rows equals, bit for bit, the same rows computed
    as 2 x 512: the table's chunks follow N alone."""
    z2, mu2, seq, lse, gq, logvar, num_real = backward_case(cuda, 1024, 3001,
                                                            16, 2990)
    whole = discriminative.discriminative_log_qy_bwd(
        z2, mu2, seq, lse, gq, logvar, num_real)[0]
    halves = [discriminative.discriminative_log_qy_bwd(
        z2[lo:lo + 512].contiguous(), mu2, seq[lo:lo + 512],
        lse[lo:lo + 512].contiguous(), gq[lo:lo + 512].contiguous(), logvar,
        num_real)[0] for lo in (0, 512)]
    assert torch.equal(torch.cat(halves), whole)


# (table rows, shards): the second's shards 5, 6, 7 hold only padding
@pytest.mark.parametrize("n,m", [(3001, 4), (5, 8)])
def test_discriminative_sharded_backward_matches_plain(cuda, n, m):
    from pytorch_scalablefhvae_tpu_torch.parallel.mesh import padded_num_seqs

    z2, mu2, seq, lse, gq, logvar, _ = backward_case(cuda, 63, n, 16, n)
    per = padded_num_seqs(n, m) // m
    padded = torch.zeros((per * m, 16), device=cuda)
    padded[:n] = mu2
    entry = discriminative.discriminative_log_qy_sharded_bwd
    dz2 = torch.zeros_like(z2)
    for j in range(m):
        shard = padded[j * per:(j + 1) * per].contiguous()
        args = (z2, shard, seq, lse, gq, logvar, n, j * per)
        got, again = entry(*args), entry(*args)
        want = discriminative.discriminative_log_qy_bwd_reference(*args)
        torch.cuda.synchronize()
        for a, b_, c in zip(got, again, want):
            assert torch.equal(a, b_)
            assert float((a - c).abs().max()) <= 1e-4 * float(c.abs().max())
        assert (got[1][max(0, n - j * per):] == 0).all()
        if j * per >= n:  # all padding: nothing to push anywhere
            assert not got[0].any() and not got[1].any()
        dz2 += got[0]
    want = discriminative.discriminative_log_qy_bwd_reference(
        z2, mu2, seq, lse, gq, logvar, n)[0]
    assert float(torch.linalg.norm(dz2 - want)) <= \
        1e-4 * float(torch.linalg.norm(want))


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


# a copy: the kernel must equal its plain version bit for bit (bfloat16
# rounded as torch rounds on the CPU). D 80 takes the 16-byte loads, D 6
# the 4-byte ones; the store in memory, or memory-mapped read-only as a
# pack cache is (held as a page-locked copy in memory)
@pytest.mark.parametrize("d,mapped", [(80, False), (6, False), (80, True)],
                         ids=["16-byte loads", "4-byte loads", "memmap"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_gather_matches_plain(cuda, d, mapped, dtype, tmp_path):
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        GATHER_PIECE_ROWS,
        RoundLayout,
        gather_runs,
    )
    from pytorch_scalablefhvae_tpu_torch.data.feature_store import (
        FeatureStore,
    )
    from pytorch_scalablefhvae_tpu_torch.ops import stage_gather

    rng = np.random.default_rng(8)
    store = FeatureStore.from_arrays({
        f"s{i}": (rng.standard_normal((n, d)) * 3).astype(np.float32)
        for i, n in enumerate(rng.integers(100, 1300, 61))})
    if mapped:
        path = tmp_path / "pack.bin"
        store.data.tofile(path)
        store.data = np.memmap(path, np.float32, "r",
                               shape=store.data.shape)
    host = stage_gather.host_store(store.data, cuda)
    assert host.ptr and stage_gather.host_store(store.data, cuda).ptr \
        == host.ptr
    assert (host.rows.data_ptr() == store.data.ctypes.data) != mapped
    layout = RoundLayout(store, list(rng.choice(store.seq_keys, 37,
                                                replace=False)))
    fn = stage_gather.stage_gather
    # the whole round, then a window of it; an odd number of runs each, the
    # rows no run names left as they were
    for lo, hi in ((0, layout.rows), (1001, layout.rows - 777)):
        runs = gather_runs(layout, lo, hi, GATHER_PIECE_ROWS)
        runs = torch.from_numpy(runs[:len(runs) - 1 + len(runs) % 2])
        got = torch.full((hi - lo + 5, d), 5.0, dtype=dtype, device=cuda)
        want = got.cpu()
        before = fn.launches
        fn(host, runs.to(cuda), got)
        stage_gather.stage_gather_reference(host, runs, want)
        torch.cuda.synchronize()
        assert fn.launches == before + 1 and len(runs) % 2 == 1
        assert torch.equal(got.cpu().view(torch.int16),
                           want.view(torch.int16))


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
# N at the edges of the kernel's 16-, 32- and 64-frame tiles and at the
# served batches (1,640, 6,560 and 13,120 frames)
EDGES = [1, 15, 16, 17, 63, 64, 65, 1640, 6560, 13120]


@pytest.mark.parametrize("n,n_fft,n_mels", [
    (6560, 400, 80), (1641, 400, 80), (1, 400, 80), (300, 400, 40),
    (77, 512, 80), (50, 101, 16)]
    + [(n, 400, 80) for n in EDGES if n not in (1, 6560)]
    + [(n, 512, 40) for n in (17, 1640)] + [(n, 101, 16) for n in (65, 6560)]
    + [(100, 512, 128), (50, 101, 64)]
    + [(100, 1024, 80), (33, 1075, 80), (17, 1088, 40)],
    ids=["serving", "ragged", "one frame", "40 mels", "n_fft 512",
         "odd n_fft"] + [f"N {n}" for n in EDGES if n not in (1, 6560)]
    + ["n_fft 512 N 17", "n_fft 512 N 1640", "odd n_fft N 65",
       "odd n_fft N 6560", "bank through the ring", "mel in two passes",
       "n_fft 1024", "n_fft 1075", "n_fft 1088"])
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


def voiced_frames(n, noise_db, n_fft=400, seed=4):
    """Frames of a harmonic tone (15 harmonics of 85-255 Hz, tilt
    0.5-0.85, peak 0.3) over white noise ``noise_db`` below its RMS,
    pre-emphasized by 0.97, as chip_smoke.py's dynamic-range case."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_fft + 1)[None, :] / 16000.0
    f0 = rng.uniform(85.0, 255.0, (n, 1))
    tilt = rng.uniform(0.5, 0.85, (n, 1))
    y = np.zeros((n, n_fft + 1))
    for h in range(1, 16):
        y += tilt ** h * np.sin(2 * np.pi * f0 * h * t
                                + rng.uniform(0, 2 * np.pi, (n, 1)))
    y *= 0.3 / np.abs(y).max(axis=1, keepdims=True)
    rms = np.sqrt((y * y).mean(axis=1, keepdims=True))
    y += rms * 10.0 ** (-noise_db / 20.0) * rng.standard_normal(y.shape)
    return torch.from_numpy((y[:, 1:] - 0.97 * y[:, :-1]).astype(np.float32))


def test_fused_logmel_dynamic_range(cuda):
    """Voiced frames: the quiet bins of a frame lie far below its loud
    ones. The kernel stays within 2e-4 of plain, and the plain chain with
    TF32 products misses that limit (so it catches a single TF32 product)."""
    _, w, C, S, fb_t = logmel_inputs(cuda, 1)
    frames = voiced_frames(6560, DR_NOISE_DB).to(cuda)
    got = fbank_cuda.fused_logmel_frames(frames, w, C, S, fb_t)
    want = fbank_cuda.logmel_frames_reference(frames, w, C, S, fb_t)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = fbank_cuda.logmel_frames_reference(frames, w, C, S, fb_t)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert float((got - want).abs().max()) <= 2e-4
    assert float((tf32 - want).abs().max()) > 2e-4


def test_fused_logmel_rows_do_not_depend_on_the_batch(cuda):
    """A frame gives the same bits in any batch, whatever tile height the
    batch's size picks: 13,120 frames against their first 6,560, those
    against 4 x 1,640, and 65 against 17 + 48."""
    args = logmel_inputs(cuda, 13120)
    frames, rest = args[0], args[1:]
    fn = fbank_cuda.fused_logmel_frames
    whole = fn(frames, *rest)
    served = fn(frames[:6560].contiguous(), *rest)
    assert torch.equal(whole[:6560], served)
    parts = [fn(frames[i:i + 1640].contiguous(), *rest)
             for i in range(0, 6560, 1640)]
    assert torch.equal(torch.cat(parts), served)
    small = fn(frames[:65].contiguous(), *rest)
    pieces = [fn(frames[:17].contiguous(), *rest),
              fn(frames[17:65].contiguous(), *rest)]
    assert torch.equal(torch.cat(pieces), small)
    assert torch.equal(small, whole[:65])


def test_fused_logmel_takes_views_off_16_byte_boundaries(cuda):
    """The kernel takes its inputs in by 16-byte bulk copies; views that
    start 4 bytes past a boundary give the same bits."""
    args = logmel_inputs(cuda, 100)

    def off(t):
        buf = torch.empty(t.numel() + 1, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    moved = [off(t) for t in args]
    assert all(t.data_ptr() % 16 for t in moved)
    fn = fbank_cuda.fused_logmel_frames
    assert torch.equal(fn(*moved), fn(*args))


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


def test_fused_logmel_takes_n_fft_up_to_its_shared_memory(cuda):
    """Past 512 bins a 16-frame block holds 8 frames a DFT thread, so the
    threads never refuse a shape: n_fft 1,088 (545 bins) runs, as checked
    against plain above, and 1,089 is refused by shared memory alone."""
    lib = _build.library()
    assert lib.sfhvae_fbank_logmel_threads(545, 16) > 0
    assert lib.sfhvae_fbank_logmel_smem(1088, 545, 80, 16) \
        <= lib.sfhvae_fbank_logmel_max_smem()
    with pytest.raises(ValueError, match="shared memory"):
        fbank_cuda.fused_logmel_frames(*logmel_inputs(cuda, 4, n_fft=1089))


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


# ------------------------------------------------ the K-step bundle's graph

BUNDLE_K, BUNDLE_B, BUNDLE_T, BUNDLE_D = 3, 64, 20, 80


def bundle_case(cuda, tier, seed=7):
    """Two train states at one seeded model of the CLI's widths (bf16, H
    128: the tensor-core forms), a host loader of ``BUNDLE_B``-row batches
    over a seeded store, the store staged on the card with epoch 0's plan,
    and the K-step bundle's inputs for ``tier``."""
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        DeviceDataSource,
    )
    from pytorch_scalablefhvae_tpu_torch.data.feature_store import (
        FeatureStore,
    )
    from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
    from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
    from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
    from pytorch_scalablefhvae_tpu_torch.train.device_step import PlanInputs
    from pytorch_scalablefhvae_tpu_torch.train.graphs import HostInputs
    from pytorch_scalablefhvae_tpu_torch.train.step import create_train_state

    rng = np.random.default_rng(seed)
    store = FeatureStore.from_arrays({
        f"s{i}": rng.standard_normal((n, BUNDLE_D)).astype(np.float32)
        for i, n in enumerate(rng.integers(60, 160, 80))})
    ds = SegmentDataset(store, seg_len=BUNDLE_T, seg_shift=8)
    loader = SegmentLoader(ds, BUNDLE_B, shuffle=True, seed=0, prefetch=0)
    source = DeviceDataSource(store, cuda)
    plan, arrays = source.stage_epoch(ds, loader._order(), BUNDLE_B)
    assert plan.n_batches >= 3 * BUNDLE_K
    model = FHVAE(BUNDLE_T * BUNDLE_D, num_seqs=ds.num_seqs,
                  feat_dim=BUNDLE_D,
                  generator=torch.Generator().manual_seed(seed))
    states = []
    for _ in range(2):
        m = FHVAE(BUNDLE_T * BUNDLE_D, num_seqs=ds.num_seqs,
                  feat_dim=BUNDLE_D)
        m.load_state_dict(model.state_dict())
        states.append(create_train_state(m.to(cuda), seed=3))
    if tier == "host":
        inputs = HostInputs(BUNDLE_K, BUNDLE_B, BUNDLE_T, BUNDLE_D, cuda)
    else:
        inputs = PlanInputs(source.data, BUNDLE_B, BUNDLE_T)
        inputs.load_plan(arrays, plan.n_real)
    return states, list(loader), (source, plan, arrays), inputs


def load_dispatch(tier, inputs, batches, d):
    """Dispatch ``d``'s inputs: batches ``d*K .. d*K + K - 1``."""
    if tier == "host":
        inputs.load(batches[d * BUNDLE_K:(d + 1) * BUNDLE_K])
    else:
        inputs.set_base(d * BUNDLE_K * BUNDLE_B)


@pytest.mark.parametrize("tier", ["host", "device"])
def test_bundle_graph_replay_equals_eager_steps(cuda, tier):
    """Three dispatches of K = 3 (eager, captured and replayed, replayed)
    against nine eager steps from the same state: the same losses and the
    same parameters and moments, bit for bit; every dispatch counts the
    launches of the eager one, all through the tensor-core forms."""
    from pytorch_scalablefhvae_tpu_torch.train.device_step import (
        device_train_step,
    )
    from pytorch_scalablefhvae_tpu_torch.train.graphs import (
        StepBundle,
        launch_counts,
    )
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        make_optimizer,
        train_step,
    )

    states, batches, (source, plan, arrays), inputs = bundle_case(cuda, tier)
    opt = make_optimizer(1e-3, 0.95, 0.999)
    eager = []
    for b in range(3 * BUNDLE_K):
        if tier == "host":
            m = train_step(states[0], opt, *(torch.from_numpy(a).to(cuda)
                                             for a in (batches[b].feats,
                                                       batches[b].seq_idx,
                                                       batches[b].nsegs,
                                                       batches[b].weight)),
                           10.0)
        else:
            m = device_train_step(states[0], opt, source.data, arrays,
                                  b * BUNDLE_B, plan.n_real, 10.0,
                                  batch_size=BUNDLE_B, seg_len=BUNDLE_T)
        eager.append(float(m["loss"]))
    bundle = StepBundle(states[1], opt, 10.0, BUNDLE_K, inputs, cuda)
    got, deltas = [], []
    for d in range(3):
        before = launch_counts()
        load_dispatch(tier, inputs, batches, d)
        got += bundle()["loss"].tolist()
        after = launch_counts()
        deltas.append({k: after[k] - n for k, n in before.items()
                       if after[k] != n})
    assert bundle.graph is not None
    assert got == eager
    assert deltas[0] == deltas[1] == deltas[2]
    names = {e.__name__: n for (e, c), n in deltas[0].items()
             if c == "launches"}
    tc = {e.__name__: n for (e, c), n in deltas[0].items()
          if c == "launches_tc"}
    assert names["lstm2_tm_proj"] == tc["lstm2_tm_proj"] == 2 * BUNDLE_K
    assert names["lstm2_tm"] == tc["lstm2_tm"] == BUNDLE_K
    assert names["lstm2_tm_proj_bwd"] == tc["lstm2_tm_proj_bwd"] == \
        2 * BUNDLE_K
    assert names["lstm2_tm_bwd"] == tc["lstm2_tm_bwd"] == BUNDLE_K
    assert names["discriminative_log_qy"] == BUNDLE_K
    assert names["discriminative_log_qy_bwd"] == BUNDLE_K
    a, b = states
    assert a.step == b.step == a.count == b.count == 3 * BUNDLE_K
    for n, p in a.params().items():
        assert torch.equal(p, b.params()[n]), n
        assert torch.equal(a.mu[n], b.mu[n]), n
        assert torch.equal(a.nu[n], b.nu[n]), n


def test_capture_leaves_host_state_and_counters(cuda):
    """A capture runs nothing: the parameters, ``count``, ``step`` and every
    launch counter stay as they were; the replay then counts K steps and
    the capture's launches."""
    from pytorch_scalablefhvae_tpu_torch.train.graphs import (
        StepBundle,
        launch_counts,
    )
    from pytorch_scalablefhvae_tpu_torch.train.step import make_optimizer

    states, batches, _, inputs = bundle_case(cuda, "host")
    st = states[0]
    bundle = StepBundle(st, make_optimizer(1e-3, 0.95, 0.999), 10.0,
                        BUNDLE_K, inputs, cuda)
    load_dispatch("host", inputs, batches, 0)
    bundle()  # the eager warm-up dispatch
    torch.cuda.synchronize()
    params = {n: p.detach().clone() for n, p in st.params().items()}
    counts, host = launch_counts(), (st.count, st.step)
    load_dispatch("host", inputs, batches, 1)
    bundle.capture()
    torch.cuda.synchronize()
    assert launch_counts() == counts and (st.count, st.step) == host
    for n, p in st.params().items():
        assert torch.equal(p, params[n]), n
    assert bundle.launch_deltas
    bundle()
    after = launch_counts()
    assert (st.count, st.step) == (host[0] + BUNDLE_K, host[1] + BUNDLE_K)
    assert {k: after[k] - n for k, n in counts.items() if after[k] != n} \
        == bundle.launch_deltas
    assert any(not torch.equal(p, params[n]) for n, p in st.params().items())


def test_generators_in_a_graph_draw_step_noise(cuda):
    """K generators registered with a graph and seeded before each replay
    from (seed, step + i) draw what ``step_noise`` draws for each step."""
    from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        draw_noise,
        noise_seed,
        step_noise,
    )

    st = create_train_state(FHVAE(BUNDLE_T * 8, feat_dim=8).to(cuda), seed=11)
    gens = [torch.Generator(device=cuda) for _ in range(BUNDLE_K)]
    for g in gens:
        g.manual_seed(0)
        draw_noise(st.model, g, BUNDLE_B, cuda)  # warm-up outside the graph
    graph = torch.cuda.CUDAGraph()
    for g in gens:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph):
        drawn = [draw_noise(st.model, g, BUNDLE_B, cuda) for g in gens]
    for first in (0, 7, 123_456):
        for i, g in enumerate(gens):
            g.manual_seed(noise_seed(st.seed, first + i))
        graph.replay()
        for i in range(BUNDLE_K):
            st.step = first + i
            want = step_noise(st, BUNDLE_B, cuda)
            for key in ("z2", "z1"):
                assert torch.equal(drawn[i][key], want[key]), (first, i, key)


def test_bias_corrections_on_the_card_divide_as_the_host_floats_did(cuda):
    """On CUDA ``_foreach_div`` by a host float multiplies by the fp32
    rounding of its reciprocal, which is the operand the bias corrections
    take on the card: applying them gives the same bits."""
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        make_optimizer,
        unbias,
    )

    opt = make_optimizer(1e-3, 0.95, 0.999)
    g = torch.Generator(device=cuda).manual_seed(2)
    xs = [torch.rand(n, generator=g, device=cuda) * 1e-3
          for n in (7, 512, 65536)]
    counts = [*range(300), 9_999, 123_455]
    ops = torch.from_numpy(np.concatenate(
        [opt.bias_corrections(c, device=cuda) for c in counts])).to(cuda)
    for row, c in enumerate(counts):
        for j, b in enumerate((0.95, 0.999)):
            host = float(np.float32(1.0) - np.float32(b) ** np.int32(c + 1))
            got = unbias(xs, ops[row, j])
            want = torch._foreach_div(xs, host)
            assert all(torch.equal(a, w) for a, w in zip(got, want)), (c, j)


# ------------------------------------------ kernel #8 on bf16 rows, streaming

# a copy in bfloat16 too: D 80 (160-byte rows) takes the 16-byte path, D 6
# (12-byte rows) and a store off a 16-byte boundary the 4-byte one
@pytest.mark.parametrize("d,offset", [(80, 0), (6, 0), (8, 2)],
                         ids=["16-byte copies", "4-byte copies", "unaligned"])
def test_window_gather_bf16_matches_plain(cuda, d, offset):
    g = torch.Generator().manual_seed(6)
    n, spb, seg_len, stride = 700, 16, 20, 8
    flat = torch.randn((n * d + offset,), generator=g).to(cuda,
                                                           torch.bfloat16)
    store = flat[offset:].view(n, d)
    region = (spb - 1) * stride + seg_len
    starts = torch.tensor([0, 3, 250, n - region, n - region + 7, n - 1],
                          device=cuda)
    fn = window_gather.windowed_chunk_gather
    before = fn.launches
    got = fn(store, starts, spb, seg_len, stride)
    want = window_gather.windowed_chunk_gather_reference(store, starts, spb,
                                                         seg_len, stride)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert not got[-spb:, 1:].any()


@pytest.mark.parametrize("d,offset", [(7, 0), (8, 1)],
                         ids=["odd D", "off a 4-byte boundary"])
def test_window_gather_bf16_refuses_what_4_bytes_cannot_copy(cuda, d, offset):
    """A bfloat16 row or store that no 4-byte copy fits raises, on the card,
    rather than take another path."""
    flat = torch.zeros((100 * d + offset,), device=cuda, dtype=torch.bfloat16)
    fn = window_gather.windowed_chunk_gather
    before = fn.launches
    with pytest.raises(ValueError, match="16 or 4 bytes"):
        fn(flat[offset:].view(100, d), torch.zeros(2, dtype=torch.int32,
                                                   device=cuda), 2, 4, 2)
    assert fn.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_streamed_epoch_k8_equals_k1(cuda, dtype):
    """Two streamed epochs of several chunks on the card, each chunk's
    batches eight to a CUDA graph replay and its remainder eager, against
    the same epochs one step at a time: the same losses, parameters and
    moments, bit for bit; each chunk switch's device wait measured."""
    from pytorch_scalablefhvae_tpu_torch.data.feature_store import (
        FeatureStore,
    )
    from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
    from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
    from pytorch_scalablefhvae_tpu_torch.data.stream_store import (
        StreamingDeviceSource,
    )
    from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
    from pytorch_scalablefhvae_tpu_torch.train import loop
    from pytorch_scalablefhvae_tpu_torch.train.device_step import PlanInputs
    from pytorch_scalablefhvae_tpu_torch.train.graphs import StepBundle
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
    )

    rng = np.random.default_rng(3)
    store = FeatureStore.from_arrays({
        f"s{i}": rng.standard_normal((n, 8)).astype(np.float32)
        for i, n in enumerate(rng.integers(60, 160, 120))})
    ds = SegmentDataset(store, seg_len=20, seg_shift=8)
    loader = SegmentLoader(ds, 16, shuffle=True, seed=0, prefetch=0)
    item = {"bfloat16": 2, "int8": 1}.get(dtype, 4)
    model = FHVAE(160, z1_hus=(H, H), z2_hus=(H, H), x_hus=(H, H), z1_dim=4,
                  z2_dim=4, num_seqs=ds.num_seqs, feat_dim=8,
                  generator=torch.Generator().manual_seed(1))
    opt = make_optimizer(1e-3, 0.95, 0.999)
    runs = []
    for k in (1, 8):
        m = FHVAE(160, z1_hus=(H, H), z2_hus=(H, H), x_hus=(H, H), z1_dim=4,
                  z2_dim=4, num_seqs=ds.num_seqs, feat_dim=8)
        m.load_state_dict(model.state_dict())
        state = create_train_state(m.to(cuda), seed=2)
        source = StreamingDeviceSource(ds, 2500 * 8 * item, 16, cuda, dtype)
        assert len(source.chunks) >= 3
        bundle = (None if k == 1 else StepBundle(
            state, opt, 10.0, k, PlanInputs(source.data, 16, 20), cuda))
        losses = []
        for epoch in range(2):
            stats = loop.run_stream_epoch(state, opt, source, loader, 10.0,
                                          cuda, epoch, bundle)
            losses.append(stats.train_loss)
            waits = source.switch_waits()
            assert len(waits) == len(source.chunks)
            assert all(ms is not None and ms >= 0 for _, ms in waits)
        if bundle is not None:
            assert bundle.graph is not None
        runs.append((state, losses))
    (a, la), (b, lb) = runs
    assert la == lb and a.step == b.step > 0
    for n, p in a.params().items():
        assert torch.equal(p, b.params()[n]), n
        assert torch.equal(a.mu[n], b.mu[n]), n
        assert torch.equal(a.nu[n], b.nu[n]), n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_staged_epochs_k8_equal_k1(cuda, dtype):
    """Three hierarchical rounds staged one after another into one buffer
    on the card, each MAP-initialised through kernel #8, each round's epoch
    eight steps to a CUDA graph replay, against the same rounds one step at
    a time: the same losses, parameters and moments, bit for bit. A store
    or a table bound anew under the captured graph would differ here."""
    from pytorch_scalablefhvae_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        TrainConfig,
    )
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        DeviceDataSource,
    )
    from pytorch_scalablefhvae_tpu_torch.data.feature_store import (
        FeatureStore,
    )
    from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
    from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
    from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
    from pytorch_scalablefhvae_tpu_torch.ops import window_gather
    from pytorch_scalablefhvae_tpu_torch.train import loop, rounds
    from pytorch_scalablefhvae_tpu_torch.train.device_step import PlanInputs
    from pytorch_scalablefhvae_tpu_torch.train.graphs import StepBundle
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
    )

    rng = np.random.default_rng(5)
    store = FeatureStore.from_arrays({
        f"s{i}": rng.standard_normal((n, 8)).astype(np.float32)
        for i, n in enumerate(rng.integers(60, 160, 120))})
    loader = SegmentLoader(SegmentDataset(store, seg_len=20, seg_shift=8), 16,
                           shuffle=True, seed=0, prefetch=0)
    cfg = ExperimentConfig(data=DataConfig(transfer_dtype=dtype),
                           train=TrainConfig(seed=2))
    k, ceiling = rounds.round_ceiling("stream", store, 20, 1 << 30, dtype,
                                      verbose=False)
    model = FHVAE(160, z1_hus=(H, H), z2_hus=(H, H), x_hus=(H, H), z1_dim=4,
                  z2_dim=4, num_seqs=k, feat_dim=8,
                  generator=torch.Generator().manual_seed(1))
    opt = make_optimizer(1e-3, 0.95, 0.999)
    runs = []
    for steps in (1, 8):
        m = FHVAE(160, z1_hus=(H, H), z2_hus=(H, H), x_hus=(H, H), z1_dim=4,
                  z2_dim=4, num_seqs=k, feat_dim=8)
        m.load_state_dict(model.state_dict())
        state = create_train_state(m.to(cuda), seed=2)
        source = DeviceDataSource(store.subset([], materialize=True), cuda,
                                  dtype, pad_to_rows=ceiling)
        r = rounds.Rounds(cfg, loader, "round", source, k, cuda)
        bundle = (None if steps == 1 else StepBundle(
            state, opt, 10.0, steps, PlanInputs(source.data, 16, 20), cuda))
        launches, losses = window_gather.windowed_chunk_gather.launches, []
        for epoch in range(3):
            sub = r.loader_for(epoch, state, resumed=False, verbose=False)
            stats = loop.run_device_epoch(state, opt, source, sub, 10.0, cuda,
                                          epoch, bundle=bundle,
                                          plan_rows=r.plan_rows)
            losses.append(stats.train_loss)
        assert window_gather.windowed_chunk_gather.launches - launches == \
            3 * r.map_batches
        if bundle is not None:
            assert bundle.graph is not None
        runs.append((state, losses))
    (a, la), (b, lb) = runs
    assert la == lb and a.step == b.step > 0
    for n, p in a.params().items():
        assert torch.equal(p, b.params()[n]), n
        assert torch.equal(a.mu[n], b.mu[n]), n
        assert torch.equal(a.nu[n], b.nu[n]), n


# ------------------------------------------------ --epoch-plan device


def test_device_epoch_plan_on_the_card(cuda):
    """The planner on the card: unshuffled, the CPU's plan; shuffled, a
    permutation of it with the padding at the tail, the same for the same
    seed (two generators) and another for another epoch."""
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        DeviceDataSource,
        DeviceEpochPlanner,
        make_device_epoch_plan,
    )
    from pytorch_scalablefhvae_tpu_torch.data.feature_store import (
        FeatureStore,
    )
    from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset

    rng = np.random.default_rng(3)
    store = FeatureStore.from_arrays({
        f"s{i}": rng.standard_normal((n, 8)).astype(np.float32)
        for i, n in enumerate(rng.integers(20, 400, 500))})
    ds = SegmentDataset(store, seg_len=20, seg_shift=8)
    n_real, n_rows = len(ds), len(ds) + 77
    source = DeviceDataSource(store, cuda)
    starts, nsegs = source.stage_meta(ds)
    got = make_device_epoch_plan(None, starts, nsegs, n_real, n_rows, 8,
                                 shuffle=False)
    want = make_device_epoch_plan(None, starts.cpu(), nsegs.cpu(), n_real,
                                  n_rows, 8, shuffle=False)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    base = sorted(zip(*(t[:n_real].tolist() for t in want)))
    plans = []
    for epoch in (0, 0, 1):
        planner = DeviceEpochPlanner(source, seed=5, seg_shift=8,
                                     n_rows=n_rows)
        planner.stage(ds)
        _, (seq, abs_starts, _) = planner.plan(epoch, n_real, 64)
        assert seq.is_cuda and seq.shape == (n_rows,)
        assert sorted(zip(seq[:n_real].tolist(),
                          abs_starts[:n_real].tolist())) == base
        assert not seq[n_real:].any() and not abs_starts[n_real:].any()
        plans.append((seq.cpu(), abs_starts.cpu()))
    assert all(torch.equal(a, b) for a, b in zip(plans[0], plans[1]))
    assert not torch.equal(plans[0][0], plans[2][0])


SIMPLE = dict(z1_hus=(128, 128), z2_hus=(128, 128), x_hus=(128, 128),
              z1_dim=16, z2_dim=16)


def test_simple_fhvae_step_through_the_kernels_matches_plain(cuda):
    """A ``simple_fhvae`` train step at the CLI's widths (input 20 x 80, H
    128, z 16, batch 256, a 4,620-row table): its gradients through
    kernels #5/#6 against the plain versions (1e-4 of their norm, the
    fhvae's limit above), and no LSTM kernel launched."""
    from pytorch_scalablefhvae_tpu_torch.models.base import loss_from_outputs
    from pytorch_scalablefhvae_tpu_torch.models.simple_fhvae import (
        SimpleFHVAE,
    )

    model = SimpleFHVAE(1600, num_seqs=4620, feat_dim=80,
                        generator=torch.Generator().manual_seed(4),
                        **SIMPLE).to(cuda)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((256, 20, 80), generator=g).to(cuda)
    seq = torch.randint(0, 4620, (256,), generator=g).to(cuda)
    nsegs = torch.full((256,), 30.0, device=cuda)
    noise = {"z2": torch.randn((256, 16), generator=g).to(cuda),
             "z1": torch.randn((256, 16), generator=g).to(cuda)}

    def grads():
        out = model.apply(x, seq, nsegs, sample=True, noise=noise)
        loss, _ = loss_from_outputs(out, torch.ones(256, device=cuda), 10.0)
        return torch.autograd.grad(loss, list(model.parameters()))

    lstm = (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
            lstm_cuda.lstm2_tm_proj_bwd, lstm_cuda.lstm2_tm_bwd)
    before = [e.launches for e in lstm]
    fwd = discriminative.discriminative_log_qy.launches
    bwd = discriminative.discriminative_log_qy_bwd.launches
    got = grads()
    assert discriminative.discriminative_log_qy.launches == fwd + 1
    assert discriminative.discriminative_log_qy_bwd.launches == bwd + 1
    assert [e.launches for e in lstm] == before
    saved = discriminative.discriminative_log_qy
    discriminative.discriminative_log_qy = \
        discriminative.discriminative_log_qy_reference
    try:
        want = grads()
    finally:
        discriminative.discriminative_log_qy = saved
    assert rel_norm(got, want) <= 1e-4


def test_simple_fhvae_device_plans_k8_equal_k1(cuda):
    """Two epochs of ``simple_fhvae`` on device-derived plans, eight steps
    to a CUDA graph replay (the MLPs' cuBLAS products captured beside the
    hand-written kernels), against the same epochs one step at a time: the
    same losses, parameters and moments, bit for bit. A replay that read
    the previous epoch's plan would differ in the second epoch."""
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        DeviceDataSource,
        DeviceEpochPlanner,
    )
    from pytorch_scalablefhvae_tpu_torch.data.feature_store import (
        FeatureStore,
    )
    from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
    from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
    from pytorch_scalablefhvae_tpu_torch.models.simple_fhvae import (
        SimpleFHVAE,
    )
    from pytorch_scalablefhvae_tpu_torch.train import loop
    from pytorch_scalablefhvae_tpu_torch.train.device_step import PlanInputs
    from pytorch_scalablefhvae_tpu_torch.train.graphs import StepBundle
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
    )

    rng = np.random.default_rng(6)
    store = FeatureStore.from_arrays({
        f"s{i}": rng.standard_normal((n, 80)).astype(np.float32)
        for i, n in enumerate(rng.integers(60, 200, 150))})
    ds = SegmentDataset(store, seg_len=20, seg_shift=8)
    loader = SegmentLoader(ds, 64, shuffle=True, seed=0, prefetch=0)
    model = SimpleFHVAE(1600, num_seqs=ds.num_seqs, feat_dim=80,
                        generator=torch.Generator().manual_seed(1), **SIMPLE)
    opt = make_optimizer(1e-3, 0.95, 0.999)
    runs = []
    for k in (1, 8):
        m = SimpleFHVAE(1600, num_seqs=ds.num_seqs, feat_dim=80, **SIMPLE)
        m.load_state_dict(model.state_dict())
        state = create_train_state(m.to(cuda), seed=2)
        source = DeviceDataSource(store, cuda)
        planner = DeviceEpochPlanner(source, 2, 8, len(ds) + (-len(ds)) % 64)
        planner.stage(ds)
        bundle = (None if k == 1 else StepBundle(
            state, opt, 10.0, k, PlanInputs(source.data, 64, 20), cuda))
        losses = [loop.run_device_epoch(state, opt, source, loader, 10.0,
                                        cuda, epoch, bundle=bundle,
                                        planner=planner).train_loss
                  for epoch in range(2)]
        if bundle is not None:
            assert bundle.graph is not None
        runs.append((state, losses))
    (a, la), (b, lb) = runs
    assert la == lb and a.step == b.step > 16
    for n, p in a.params().items():
        assert torch.equal(p, b.params()[n]), n
        assert torch.equal(a.mu[n], b.mu[n]), n
        assert torch.equal(a.nu[n], b.nu[n]), n


# ------------------------------------------------ --legacy, stacks, snapshot

FHVAE_CLI = dict(z1_hus=(128, 128), z2_hus=(128, 128), x_hus=(128, 128),
                 z1_dim=16, z2_dim=16, num_seqs=4620, feat_dim=80)


def plain_model_versions():
    """Swap the kernel entries the model calls for their plain versions;
    returns the callable that swaps them back."""
    saved = (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
             discriminative.discriminative_log_qy)
    lstm_cuda.lstm2_tm_proj = lstm_cuda.lstm2_tm_proj_reference
    lstm_cuda.lstm2_tm = lstm_cuda.lstm2_tm_reference
    discriminative.discriminative_log_qy = \
        discriminative.discriminative_log_qy_reference

    def restore():
        (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
         discriminative.discriminative_log_qy) = saved
    return restore


def model_entries():
    return (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
            lstm_cuda.lstm2_tm_proj_bwd, lstm_cuda.lstm2_tm_bwd,
            discriminative.discriminative_log_qy,
            discriminative.discriminative_log_qy_bwd)


# --legacy trains at batch 1: below every kernel's row tile (the tensor-core
# forward's 64-row input products and 16-row clusters, the FMA forms' 8-row
# blocks). Three steps against the plain versions with the limits of
# chip_smoke.py's train phase (TOL_TRAIN_LOSS, TOL_TRAIN_UPDATE)
@pytest.mark.parametrize("rows", [1, 5])
def test_small_batch_train_steps_through_the_kernels_match_plain(cuda, rows):
    import copy

    from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
        train_step,
    )

    model = FHVAE(1600, generator=torch.Generator().manual_seed(4),
                  **FHVAE_CLI).to(cuda)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    g = torch.Generator().manual_seed(5)
    batches = [(torch.randn((rows, 20, 80), generator=g).to(cuda),
                torch.randint(0, 4620, (rows,), generator=g).to(cuda),
                torch.full((rows,), 30.0, device=cuda),
                torch.ones(rows, device=cuda)) for _ in range(3)]
    runs = {}
    for path in ("kernels", "plain"):
        state = create_train_state(copy.deepcopy(model))
        opt = make_optimizer(1e-3, 0.95, 0.999)
        before = [e.launches for e in model_entries()]
        restore = plain_model_versions() if path == "plain" else None
        try:
            losses = [float(train_step(state, opt, *b, 10.0)["loss"])
                      for b in batches]
        finally:
            if restore:
                restore()
        launched = [e.launches - n for e, n in zip(model_entries(), before)]
        assert all(n > 0 for n in launched) == (path == "kernels"), launched
        runs[path] = losses, {n: p.detach() for n, p in
                              state.model.named_parameters()}
    (lk, pk), (lp, pp) = runs["kernels"], runs["plain"]
    assert max(abs(a - b) / abs(b) for a, b in zip(lk, lp)) <= 1e-3
    for n in start:
        upd = (pp[n] - start[n]).norm().clamp_min(1e-30)
        assert float((pk[n] - pp[n]).norm() / upd) <= 0.1, n


def test_grad_snapshot_through_the_kernels_matches_plain(cuda):
    """The ``--log-params`` snapshot (``make_grad_step``) on the card, fp32
    LSTM operands: through #1-#6 against the plain versions, 1e-4 of each
    gradient's norm (the model-gradient limit above); it updates nothing."""
    from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_grad_step,
        snapshot_noise,
    )

    model = FHVAE(1600, lstm_mm_dtype="float32",
                  generator=torch.Generator().manual_seed(4),
                  **FHVAE_CLI).to(cuda)
    state = create_train_state(model, seed=3)
    g = torch.Generator().manual_seed(6)
    b = (torch.randn((64, 20, 80), generator=g).to(cuda),
         torch.randint(0, 4620, (64,), generator=g).to(cuda),
         torch.full((64,), 30.0, device=cuda), torch.ones(64, device=cuda))
    noise = snapshot_noise(state, 2, 64, cuda)
    grad_step = make_grad_step(10.0)
    before = [e.launches for e in model_entries()]
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    got = grad_step(state, *b, noise)
    assert all(e.launches > n for e, n in zip(model_entries(), before))
    restore = plain_model_versions()
    try:
        want = grad_step(state, *b, noise)
    finally:
        restore()
    assert list(got) == list(want) == state.names
    assert rel_norm(list(got.values()), list(want.values())) <= 1e-4
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n]), n


@pytest.mark.parametrize("width", [128, 256])
def test_kernel_stacks_never_reach_the_plain_route(cuda, width):
    """At the CLI's stacks (tensor-core forms) and at H 256 (the FMA forms)
    a forward and backward launches #1-#4 and never ``plain_stack``."""
    from pytorch_scalablefhvae_tpu_torch.models import fhvae
    from pytorch_scalablefhvae_tpu_torch.models.base import loss_from_outputs

    hus = (width, width)
    model = fhvae.FHVAE(1600, **{**FHVAE_CLI, "z1_hus": hus, "z2_hus": hus,
                                 "x_hus": hus},
                        generator=torch.Generator().manual_seed(4)).to(cuda)
    assert all(model.kernel_stacks.values())
    x = torch.randn((64, 20, 80), device=cuda)
    seq = torch.randint(0, 4620, (64,), device=cuda)
    calls = fhvae.plain_stack_calls
    before = [e.launches for e in model_entries()]
    tc = [e.launches_tc for e in model_entries()[:4]]
    out = model.apply(x, seq, torch.full((64,), 30.0, device=cuda),
                      sample=True)
    loss, _ = loss_from_outputs(out, torch.ones(64, device=cuda), 10.0)
    loss.backward()
    torch.cuda.synchronize()
    assert fhvae.plain_stack_calls == calls
    assert all(e.launches > n for e, n in zip(model_entries(), before))
    took_tc = [e.launches_tc > n for e, n in zip(model_entries()[:4], tc)]
    assert took_tc == [width == 128] * 4


def test_unequal_stacks_launch_no_lstm_kernel(cuda):
    """``--z1-hus 256 128 --z2-hus 256 128 --x-hus 256 128``: every stack on
    the plain route (three calls a forward), #1-#4 launched 0 times, #5/#6
    once each; the gradients equal those through the plain
    ``log q(y|z2)`` within 1e-4 of their norm."""
    from pytorch_scalablefhvae_tpu_torch.models import fhvae
    from pytorch_scalablefhvae_tpu_torch.models.base import loss_from_outputs

    hus = (256, 128)
    model = fhvae.FHVAE(1600, **{**FHVAE_CLI, "z1_hus": hus, "z2_hus": hus,
                                 "x_hus": hus},
                        generator=torch.Generator().manual_seed(4)).to(cuda)
    assert not any(model.kernel_stacks.values())
    g = torch.Generator().manual_seed(7)
    x = torch.randn((64, 20, 80), generator=g).to(cuda)
    seq = torch.randint(0, 4620, (64,), generator=g).to(cuda)
    noise = {k: torch.randn((64, 16), generator=g).to(cuda)
             for k in ("z2", "z1")}

    def grads():
        out = model.apply(x, seq, torch.full((64,), 30.0, device=cuda),
                          sample=True, noise=noise)
        loss, _ = loss_from_outputs(out, torch.ones(64, device=cuda), 10.0)
        return torch.autograd.grad(loss, list(model.parameters()))

    calls = fhvae.plain_stack_calls
    before = [e.launches for e in model_entries()]
    got = grads()
    torch.cuda.synchronize()
    launched = [e.launches - n for e, n in zip(model_entries(), before)]
    assert launched == [0, 0, 0, 0, 1, 1]
    assert fhvae.plain_stack_calls == calls + 3
    saved = discriminative.discriminative_log_qy
    discriminative.discriminative_log_qy = \
        discriminative.discriminative_log_qy_reference
    try:
        want = grads()
    finally:
        discriminative.discriminative_log_qy = saved
    assert rel_norm(got, want) <= 1e-4


# ---------------------------------------------- a mesh's K-step bundle


def test_nccl_mesh_bundle_replay_equals_eager_steps(cuda, tmp_path):
    """A one-rank NCCL mesh (``parallel/launch.run_ranks``): a K = 4 bundle
    replays one CUDA graph with the mesh's all-reduces inside and equals
    the same steps run eagerly on the mesh, bit for bit; every dispatch
    counts the eager one's launches, #7 forward and backward once a step
    and the single-table #5 and #6 never (rank side:
    ``tests/_torch_mesh_workers.py``)."""
    import json

    import _torch_mesh_workers as workers
    from pytorch_scalablefhvae_tpu_torch.parallel import launch

    k = 4
    codes = launch.run_ranks(workers.nccl_bundle_replays, 1,
                             (str(tmp_path), k), backend="nccl",
                             device="cuda", timeout_s=120,
                             join_timeout_s=600)
    assert codes == [0]
    r = json.loads((tmp_path / "nccl_bundle.json").read_text())
    assert r["backend"] == "nccl" and r["replays"] and r["graph"]
    assert r["losses"] == r["eager"] and r["equal"]
    assert r["deltas"][0] == r["deltas"][1] == r["deltas"][2]
    d = r["deltas"][0]
    assert d["discriminative_log_qy_sharded"] == k
    assert d["discriminative_log_qy_sharded_bwd"] == k
    assert "discriminative_log_qy" not in d
    assert "discriminative_log_qy_bwd" not in d
    assert d["lstm2_tm_proj"] == 2 * k and d["lstm2_tm"] == k


# -------------------------------------- a hierarchical round's MAP init


def test_map_pass_rows_on_a_one_rank_mesh_equals_cpu(cuda, tmp_path):
    """``device_map_pass_rows`` (a hierarchical round's MAP init on a mesh)
    on a one-rank NCCL mesh, its store a ``RowShard`` gathered through
    ``gather_sharded``, the z2 encoder through the LSTM kernels: the same
    table as its run on the CPU (no mesh, plain versions) within 1e-4 of
    its largest entry, the padded row exactly 0 (rank side:
    ``tests/_torch_mesh_workers.py``)."""
    import _torch_mesh_workers as workers
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        DeviceDataSource,
    )
    from pytorch_scalablefhvae_tpu_torch.data.feature_store import (
        FeatureStore,
    )
    from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
    from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
    from pytorch_scalablefhvae_tpu_torch.parallel import launch
    from pytorch_scalablefhvae_tpu_torch.train.device_step import (
        device_map_pass_rows,
    )

    rng = np.random.default_rng(5)
    lens = rng.integers(40, 120, 24)
    data = rng.standard_normal((int(lens.sum()), 80)).astype(np.float32)
    bounds = np.cumsum([0, *lens])
    store = FeatureStore.from_arrays({
        f"s{i}": data[lo:hi]
        for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))})
    sub_idx = [20, 3, 11, 7, 15]
    sub = store.subset([store.seq_keys[i] for i in sub_idx])
    ds = SegmentDataset(sub, seg_len=20, seg_shift=8)
    dims = dict(input_size=20 * 80, num_seqs=len(sub_idx), feat_dim=80)
    model = FHVAE(lstm_mm_dtype="float32",
                  generator=torch.Generator().manual_seed(5), **dims)
    batch, num_rows = 64, len(sub_idx) + 1
    n_batches = -(-len(ds) // batch) + 1
    src = DeviceDataSource(store, torch.device("cpu"))
    starts, nsegs = src.stage_meta(ds)
    want = device_map_pass_rows(
        model, src.data, starts, nsegs, seg_len=20, seg_shift=8,
        batch_size=batch, n_batches=n_batches, num_rows=num_rows,
        pz2_var=float(np.exp(model.pz2_logvar))).numpy()
    np.savez(tmp_path / "in.npz", store_data=data, store_lens=lens,
             sub_idx=np.array(sub_idx), seg_len=20, seg_shift=8,
             batch=batch, n_batches=n_batches, num_rows=num_rows,
             **{f"param.{k}": v.detach().numpy()
                for k, v in model.state_dict().items()})
    codes = launch.run_ranks(workers.map_pass_rows_card, 1,
                             (str(tmp_path / "in.npz"), str(tmp_path), dims),
                             backend="nccl", device="cuda", timeout_s=120,
                             join_timeout_s=600)
    assert codes == [0]
    with np.load(tmp_path / "rank0.npz") as z:
        got, launches = z["table"], int(z["launches"])
    assert launches == n_batches
    assert got.shape == want.shape and (got[len(sub_idx):] == 0).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
