"""The port's discriminative backward against the JAX Pallas VJP, on the CPU.

On CPU tensors ``discriminative_log_qy``'s autograd Function runs the plain
forward and the plain backward (``discriminative_log_qy_bwd_reference``),
the function the CUDA backward kernel is held against on the card. Here it
is held against ``jax.vjp`` of ``discriminative_log_qy_pallas(...,
interpret=True)`` (the TPU kernel's ``_bwd_call``) with padded table rows,
on the same numpy inputs and cotangent. The limit is fp32 sum-order noise
relative to the largest gradient; padded rows must get exactly zero. The
kernel's geometry (how it cuts the batch and the table) is pure Python and
is checked here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.ops.discriminative import (
    discriminative_log_qy_pallas,
)
from pytorch_scalablefhvae_tpu_torch.ops.discriminative import (
    bwd_geometry,
    discriminative_log_qy,
    discriminative_log_qy_bwd,
    discriminative_log_qy_bwd_reference,
)

B, N, D = 12, 40, 16
PZ2_LOGVAR = float(np.log(0.5 ** 2))
TOL = 1e-5


def inputs(seed, num_real):
    rng = np.random.default_rng(seed)
    mu2 = rng.standard_normal((N, D)).astype(np.float32)
    seq = rng.integers(0, num_real, B).astype(np.int32)
    z2 = (mu2[seq] + 0.5 * rng.standard_normal((B, D))).astype(np.float32)
    g = rng.standard_normal(B).astype(np.float32)
    return z2, mu2, seq, g


@pytest.mark.parametrize("num_real", [N, N - 7], ids=["full", "padded"])
def test_grads_match_pallas_vjp(num_real):
    z2, mu2, seq, g = inputs(0, num_real)
    _, vjp = jax.vjp(
        lambda a, b: discriminative_log_qy_pallas(
            a, b, jnp.asarray(seq), PZ2_LOGVAR, num_real=num_real,
            interpret=True),
        jnp.asarray(z2), jnp.asarray(mu2))
    want_z2, want_mu2 = (np.asarray(v) for v in vjp(jnp.asarray(g)))

    tz2 = torch.tensor(z2, requires_grad=True)
    tmu2 = torch.tensor(mu2, requires_grad=True)
    out = discriminative_log_qy(tz2, tmu2, torch.from_numpy(seq), PZ2_LOGVAR,
                                num_real)
    got_z2, got_mu2 = torch.autograd.grad(out, (tz2, tmu2),
                                          torch.from_numpy(g))
    for got, want in ((got_z2.numpy(), want_z2), (got_mu2.numpy(), want_mu2)):
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    assert (got_mu2[num_real:] == 0).all()
    assert np.abs(got_mu2[:num_real].numpy()).max() > 0
    assert discriminative_log_qy_bwd.launches == 0  # the plain version ran


def test_bwd_entry_on_cpu_is_the_plain_backward():
    """The entry called directly on CPU tensors runs the plain backward; an
    index outside the table picks nothing, so it pushes only -p."""
    z2, mu2, seq, g = inputs(1, N - 3)
    seq[4] = N + 2
    args = [torch.from_numpy(a) for a in (z2, mu2, seq)]
    logits = 2.0 * (2.0 * z2 @ mu2.T - (mu2 * mu2).sum(-1))
    logits[:, N - 3:] = -1e30
    lse = torch.from_numpy(np.log(np.exp(
        logits - logits.max(1, keepdims=True)).sum(1)) + logits.max(1))
    got = discriminative_log_qy_bwd(*args, lse, torch.from_numpy(g),
                                    PZ2_LOGVAR, N - 3)
    want = discriminative_log_qy_bwd_reference(*args, lse,
                                               torch.from_numpy(g),
                                               PZ2_LOGVAR, N - 3)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    p = np.exp(logits[4] - lse[4].item())
    np.testing.assert_allclose(
        got[0][4].numpy(), 4.0 * (-g[4] * p) @ mu2, rtol=1e-4, atol=1e-5)


# (batch rows, table rows): the train step, a mesh rank, a LibriSpeech-960
# table, its shard on 4 ranks, and small or ragged edges
@pytest.mark.parametrize("b,n", [(1024, 4620), (512, 2310), (1024, 281241),
                                 (1024, 70311), (1024, 1), (1, 129),
                                 (63, 3001)])
def test_bwd_geometry(b, n):
    target = 4 * 132  # four blocks per SM of an H100
    chunk_tiles, n_chunks, group_tiles, n_groups = bwd_geometry(b, n, target)
    assert 1 <= chunk_tiles <= 8
    # the chunks of 128-row tiles cover the table, and none is empty
    rows = chunk_tiles * 128
    assert (n_chunks - 1) * rows < n <= n_chunks * rows
    # the groups of 64-row tiles cover the batch, and none is empty
    assert (n_groups - 1) * group_tiles * 64 < b <= n_groups * group_tiles * 64
    # the chunking follows N alone
    for other in (1, 63, 512, 1024, 4096):
        assert bwd_geometry(other, n, target)[:2] == (chunk_tiles, n_chunks)
    assert n_chunks * n_groups <= target
    if n >= 4620:  # enough table tiles to fill the card without groups
        assert n_chunks * n_groups >= target // 2
