"""The port's CUDA kernels against their plain versions, on a GPU.

Each test needs a CUDA device (a CUDA kernel has no CPU mode) and skips
without one. This file imports no jax, so it also runs where jax is not
installed; there, skip the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

chip_smoke.py checks the same kernels at the serving shapes.
"""

import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu_torch.ops import discriminative, lstm_cuda

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
