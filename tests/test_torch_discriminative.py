"""The port's discriminative log q(y | z2) against the JAX jnp path.

On the CPU the port runs its plain version; the JAX side runs
``discriminative_log_qy(use_pallas="never")``, which tests/test_ops.py pins
to the Pallas kernel. Inputs come from a numpy seed. The forward kernel's
geometry (how it cuts the batch and the table) is pure Python and is checked
here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.models.base import (
    discriminative_log_qy as jax_log_qy,
)
from pytorch_scalablefhvae_tpu_torch.ops.discriminative import (
    discriminative_log_qy,
    fwd_geometry,
)

B, N, D = 12, 40, 16
PZ2_LOGVAR = float(np.log(0.5 ** 2))


def inputs(seed):
    rng = np.random.default_rng(seed)
    mu2 = rng.standard_normal((N, D)).astype(np.float32)
    seq = rng.integers(0, N - 5, B).astype(np.int32)
    z2 = (mu2[seq] + 0.5 * rng.standard_normal((B, D))).astype(np.float32)
    return z2, mu2, seq


@pytest.mark.parametrize("num_real", [None, N - 5], ids=["full", "padded"])
def test_matches_jax(num_real):
    z2, mu2, seq = inputs(0)
    want = np.asarray(jax_log_qy(jnp.asarray(z2), jnp.asarray(mu2),
                                 jnp.asarray(seq), PZ2_LOGVAR,
                                 use_pallas="never", num_real=num_real))
    got = discriminative_log_qy(torch.from_numpy(z2), torch.from_numpy(mu2),
                                torch.from_numpy(seq), PZ2_LOGVAR, num_real)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert discriminative_log_qy.launches == 0  # the CPU runs the plain version


def test_index_outside_table_picks_nothing():
    """A served request may number more utterances than the table has rows:
    such an index must not raise, and (as in the Pallas kernel) it picks no
    logit, so its log_qy is -logsumexp. Rows inside the table still match
    JAX."""
    z2, mu2, seq = inputs(1)
    seq_out = seq.copy()
    seq_out[[2, 7]] = [N, N + 9]
    got = discriminative_log_qy(torch.from_numpy(z2), torch.from_numpy(mu2),
                                torch.from_numpy(seq_out), PZ2_LOGVAR).numpy()
    want = np.asarray(jax_log_qy(jnp.asarray(z2), jnp.asarray(mu2),
                                 jnp.asarray(seq), PZ2_LOGVAR,
                                 use_pallas="never"))
    inside = np.ones(B, bool)
    inside[[2, 7]] = False
    np.testing.assert_allclose(got[inside], want[inside], atol=1e-5, rtol=0)
    logits = 2.0 * (2.0 * z2 @ mu2.T - (mu2 * mu2).sum(-1))  # 1/(2 sigma^2) = 2
    lse = np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1)) \
        + logits.max(1)
    np.testing.assert_allclose(got[~inside], -lse[~inside], rtol=1e-5)


# (batch rows, table rows): the train step, a mesh rank, a LibriSpeech-960
# table, its shard on 4 ranks, and small or ragged edges (test_bwd_geometry's)
@pytest.mark.parametrize("b,n", [(1024, 4620), (512, 2310), (1024, 281241),
                                 (1024, 70311), (1024, 1), (1, 129),
                                 (63, 3001)])
def test_fwd_geometry(b, n):
    target = 4 * 132  # four blocks per SM of an H100
    chunk_tiles, n_chunks, group_tiles, n_groups = fwd_geometry(b, n, target)
    # the chunks of 128-row tiles cover the table, and none is empty
    rows = chunk_tiles * 128
    assert chunk_tiles >= 1
    assert (n_chunks - 1) * rows < n <= n_chunks * rows
    # the groups of 64-row tiles cover the batch, and none is empty
    assert (n_groups - 1) * group_tiles * 64 < b <= n_groups * group_tiles * 64
    # the chunking follows N alone
    for other in (1, 63, 512, 1024, 4096):
        assert fwd_geometry(other, n, target)[:2] == (chunk_tiles, n_chunks)
    # few partials for the combine, and no more blocks than the target
    assert n_chunks <= target // 32
    assert n_chunks * n_groups <= target
