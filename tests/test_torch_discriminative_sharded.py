"""The sharded discriminative entry against the JAX package's.

``discriminative_log_qy_pallas_sharded`` runs in interpret mode on the
virtual CPU mesh of ``tests/conftest.py``; the port runs its plain versions
(CPU tensors). In one process the port's per-shard partials, each with its
row offset, are merged as the entry merges them (``combine_shard_partials``)
and the per-shard backward is summed as the entry's autograd Function and the
train step sum it. With real process groups (gloo, four spawned ranks) the
entry itself runs forward and backward on a ``(2, 2)`` mesh.

Limits, the JAX tests' own (``tests/test_ops.py``): ``log_qy`` 1e-4; ``dz2``
and ``dmu2`` 1e-3 relative and 1e-4 absolute; padded rows exactly 0.
"""

import numpy as np
import pytest
import torch

import _torch_mesh_workers as workers
from pytorch_scalablefhvae_tpu_torch.ops import discriminative as disc
from pytorch_scalablefhvae_tpu_torch.parallel.launch import run_ranks
from pytorch_scalablefhvae_tpu_torch.parallel.mesh import padded_num_seqs

PZ2_LOGVAR = float(np.log(0.5 ** 2))
B, D = 16, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests start up to four ranks beside the test process while
    other test processes run: every process keeps to one thread, as the
    ranks do (``OMP_NUM_THREADS=1``), so that none waits for a core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def inputs(num_real, m, seed=0, b=B):
    """``(z2, padded table, seq, g)``: z2 near its own sequence's row, as a
    trained encoder puts it; the padding rows hold noise, which the masks
    must keep out."""
    rng = np.random.default_rng(seed)
    n_pad = padded_num_seqs(num_real, m)
    table = rng.standard_normal((n_pad, D)).astype(np.float32)
    seq = rng.integers(0, num_real, b).astype(np.int32)
    z2 = (table[seq] + 0.5 * rng.standard_normal((b, D))).astype(np.float32)
    g = rng.standard_normal(b).astype(np.float32)
    return z2, table, seq, g


def port_shards(z2, table, seq, g, num_real, m):
    """``(log_qy, lse, dz2, dmu2)`` from ``m`` shards in one process."""
    z2, table, seq, g = (torch.from_numpy(a) for a in (z2, table, seq, g))
    per = table.shape[0] // m
    shards = [table[j * per:(j + 1) * per] for j in range(m)]
    parts = [disc.shard_partials(z2, shards[j], seq, PZ2_LOGVAR, num_real,
                                 j * per) for j in range(m)]
    log_qy, lse = disc.combine_shard_partials(parts)
    back = [disc.discriminative_log_qy_sharded_bwd(
        z2, shards[j], seq, lse, g, PZ2_LOGVAR, num_real, j * per)
        for j in range(m)]
    dz2 = sum(b[0] for b in back)
    dmu2 = torch.cat([b[1] for b in back])
    return log_qy.numpy(), lse.numpy(), dz2.numpy(), dmu2.numpy(), parts


def jax_sharded(z2, table, seq, g, num_real, mesh_shape):
    import jax
    import jax.numpy as jnp

    from pytorch_scalablefhvae_tpu.ops.discriminative import (
        discriminative_log_qy_pallas_sharded,
    )
    from pytorch_scalablefhvae_tpu.parallel.mesh import make_mesh

    d, m = mesh_shape
    mesh = make_mesh(mesh_shape, devices=jax.devices()[:d * m])

    def f(z2, table):
        return discriminative_log_qy_pallas_sharded(
            z2, table, jnp.asarray(seq), PZ2_LOGVAR, mesh, num_real=num_real,
            interpret=True)

    out, vjp = jax.vjp(f, jnp.asarray(z2), jnp.asarray(table))
    dz2, dmu2 = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dz2), np.asarray(dmu2)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (8, 1), (1, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_shards_match_jax_sharded(mesh_shape):
    """203 rows, padded to 204 on 4 shards and 208 on 8."""
    num_real, m = 203, mesh_shape[1]
    z2, table, seq, g = inputs(num_real, m)
    want, want_dz2, want_dmu2 = jax_sharded(z2, table, seq, g, num_real,
                                            mesh_shape)
    got, _, dz2, dmu2, _ = port_shards(z2, table, seq, g, num_real, m)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dz2, want_dz2, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(dmu2, want_dmu2, rtol=1e-3, atol=1e-4)
    assert (dmu2[num_real:] == 0.0).all()
    assert np.abs(dmu2[:num_real]).max() > 0


@pytest.mark.parametrize("num_real,m", [(203, 1), (203, 2), (203, 4),
                                        (203, 8), (13, 4), (30, 8)])
def test_shards_match_the_single_table(num_real, m):
    """Merged shards against the port's own single-table plain version on
    the unpadded table, forward and backward."""
    z2, table, seq, g = inputs(num_real, m, seed=1)
    got, lse, dz2, dmu2, _ = port_shards(z2, table, seq, g, num_real, m)
    t = [torch.from_numpy(a) for a in (z2, table[:num_real], seq)]
    want, want_lse = disc._forward_plain(*t, PZ2_LOGVAR, num_real)
    want_dz2, want_dmu2 = disc.discriminative_log_qy_bwd_reference(
        *t, want_lse, torch.from_numpy(g), PZ2_LOGVAR, num_real)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lse, want_lse.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dz2, want_dz2.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(dmu2[:num_real], want_dmu2.numpy(), rtol=1e-3,
                               atol=1e-4)
    assert (dmu2[num_real:] == 0.0).all()


def test_all_padding_shards_leave_the_result_unchanged():
    """5 rows over 8 shards: shards 5..7 hold only padding. They report
    ``m = -1e30`` exactly, ``e^(m - m*)`` is exactly 0, and the merge with
    them equals the merge without them bit for bit."""
    num_real, m = 5, 8
    z2, table, seq, g = inputs(num_real, m, seed=2)
    got, lse, _, dmu2, parts = port_shards(z2, table, seq, g, num_real, m)
    for mj, sj, pj in parts[num_real:]:
        assert (mj == -1e30).all() and (sj == 1.0).all() and (pj == 0).all()
    real, real_lse = disc.combine_shard_partials(parts[:num_real])
    assert np.array_equal(got, real.numpy())
    assert np.array_equal(lse, real_lse.numpy())
    assert (dmu2[num_real:] == 0.0).all()
    want = disc.discriminative_log_qy_reference(
        torch.from_numpy(z2), torch.from_numpy(table[:num_real]),
        torch.from_numpy(seq), PZ2_LOGVAR)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-4)


def test_an_index_owned_by_another_shard_picks_nothing_here():
    """Rows 0..49 live in shard 0 of 4: for a batch that picks only those,
    the other shards' ``picked`` is 0 and shard 0's is the row's logit; an
    index past the table picks nothing anywhere. Ignoring the offset (every
    shard fed offset 0) misses the limit."""
    num_real, m = 203, 4
    z2, table, seq, g = inputs(num_real, m, seed=3)
    seq[:] = np.arange(B) % 50
    seq[3] = 300
    _, _, _, _, parts = port_shards(z2, table, seq, g, num_real, m)
    for j in range(1, m):
        assert (parts[j][2] == 0).all()
    assert parts[0][2][3] == 0 and (parts[0][2][:3] != 0).all()
    t = [torch.from_numpy(a) for a in (z2, table, seq)]
    per = table.shape[0] // m
    wrong, _ = disc.combine_shard_partials([
        disc.shard_partials_reference(t[0], t[1][j * per:(j + 1) * per], t[2],
                                      PZ2_LOGVAR, num_real, 0)
        for j in range(m)])
    want = disc.discriminative_log_qy_reference(t[0], t[1][:num_real], t[2],
                                                PZ2_LOGVAR)
    assert float((wrong - want).abs().max()) > 1.0


def test_entry_through_real_groups(tmp_path, monkeypatch):
    """``discriminative_log_qy_sharded`` on a ``(2, 2)`` mesh of four gloo
    ranks, forward and backward: every rank's rows of ``log_qy`` and ``dz2``
    (the same on both ranks of a model group), and ``dmu2`` of each shard
    summed over the data group, against JAX's sharded entry on a ``(2, 2)``
    mesh and the port's single table."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    num_real, shape = 13, (2, 2)
    z2, table, seq, g = inputs(num_real, shape[1], seed=4)
    np.savez(tmp_path / "in.npz", z2=z2, table=table, seq=seq, g=g)
    codes = run_ranks(workers.sharded_entry, 4, (
        str(tmp_path / "in.npz"), str(tmp_path), shape, PZ2_LOGVAR, num_real),
        backend="gloo", device="cpu", timeout_s=60, join_timeout_s=120)
    assert codes == [0, 0, 0, 0]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for i in (0, 1):  # the two ranks of a model group hold the same rows
        for k in ("log_qy", "dz2"):
            assert np.array_equal(ranks[2 * i][k], ranks[2 * i + 1][k])
    got = np.concatenate([ranks[0]["log_qy"], ranks[2]["log_qy"]])
    dz2 = np.concatenate([ranks[0]["dz2"], ranks[2]["dz2"]])
    dmu2 = np.concatenate([ranks[0]["dmu2"] + ranks[2]["dmu2"],
                           ranks[1]["dmu2"] + ranks[3]["dmu2"]])
    assert all(int(r["launches"]) == 0 for r in ranks)  # CPU: plain version
    want, want_dz2, want_dmu2 = jax_sharded(z2, table, seq, g, num_real, shape)
    one, _, one_dz2, one_dmu2, _ = port_shards(z2, table, seq, g, num_real, 1)
    for w, w_dz2, w_dmu2 in ((want, want_dz2, want_dmu2),
                             (one, one_dz2, one_dmu2)):
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(dz2, w_dz2, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(dmu2, w_dmu2, rtol=1e-3, atol=1e-4)
    assert (dmu2[num_real:] == 0.0).all()


def test_a_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    """On a CUDA tensor the wrappers launch the kernel or raise; here there
    is no card, so a tensor that claims to be on one must raise."""
    z2, table, seq, g = (torch.from_numpy(a) for a in inputs(13, 2))

    class OnCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda:0")

    fake = z2.as_subclass(OnCuda)
    with pytest.raises((RuntimeError, ValueError, OSError)):
        disc.shard_partials(fake, table[:7], seq, PZ2_LOGVAR, 13, 0)
    lse = torch.zeros(B)
    with pytest.raises((RuntimeError, ValueError, OSError)):
        disc.discriminative_log_qy_sharded_bwd(fake, table[:7], seq, lse, g,
                                               PZ2_LOGVAR, 13, 0)
