"""The port's FHVAE against the JAX FHVAE at the same weights and inputs.

JAX ``FHVAE.init`` params cross over through ``params_from_jax``. On the CPU
the JAX model runs its scan/jnp path (``lstm_pallas``/``use_pallas``
"never"), which ignores ``lstm_mm_dtype``; the port honours it, so both run
with fp32 LSTM operands there. The serving default, bf16 LSTM operands, is
held against the JAX model's fused Pallas path (``lstm_pallas="always"``,
which runs the kernels in interpret mode on the CPU). Inputs come from a
numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.models.fhvae import FHVAE as JaxFHVAE
from pytorch_scalablefhvae_tpu_torch.models.base import (
    METRIC_KEYS,
    build_model,
    loss_from_outputs,
)
from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
from pytorch_scalablefhvae_tpu_torch.train.checkpoint import params_from_jax

B, T, F, NSEQ = 6, 5, 8, 5
DIMS = dict(z1_hus=(16, 16), z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4,
            z2_dim=4, num_seqs=NSEQ, feat_dim=F)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    jm = JaxFHVAE(input_size=T * F, use_pallas="never", lstm_pallas="never",
                  lstm_mm_dtype="float32", **DIMS)
    params = jm.init(jax.random.PRNGKey(0))
    tm = FHVAE(T * F, lstm_mm_dtype="float32", **DIMS)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    return jm, params, tm


def batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    seq = rng.integers(0, NSEQ, B).astype(np.int32)
    nsegs = rng.integers(1, 9, B).astype(np.float32)
    return x, seq, nsegs


def test_apply_matches_jax_all_fields(models):
    jm, params, tm = models
    x, seq, nsegs = batch(0)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(seq),
                    jnp.asarray(nsegs), jax.random.PRNGKey(1), sample=False)
    with torch.inference_mode():
        got = tm.apply(torch.from_numpy(x), torch.from_numpy(seq),
                       torch.from_numpy(nsegs), sample=False)
    assert got._fields == want._fields and len(got._fields) == 10
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL,
                                   err_msg=name)


def test_bf16_compute_near_jax(models):
    """``compute_dtype="bfloat16"``: on the CPU JAX rounds every matmul
    operand of its scan path to bf16, which is what the port does with bf16
    projections/heads plus bf16 LSTM operands. Sums run in another order, so
    a bf16 rounding may flip: bf16-level tolerance."""
    jm, params, tm = models
    jb = JaxFHVAE(input_size=T * F, use_pallas="never", lstm_pallas="never",
                  compute_dtype="bfloat16", **DIMS)
    tb = FHVAE(T * F, compute_dtype="bfloat16", lstm_mm_dtype="bfloat16",
               **DIMS)
    tb.load_state_dict(tm.state_dict())
    x, seq, nsegs = batch(5)
    want = jb.apply(params, jnp.asarray(x), jnp.asarray(seq),
                    jnp.asarray(nsegs), jax.random.PRNGKey(1), sample=False)
    with torch.inference_mode():
        got = tb.apply(torch.from_numpy(x), torch.from_numpy(seq),
                       torch.from_numpy(nsegs), sample=False)
        f32 = tm.apply(torch.from_numpy(x), torch.from_numpy(seq),
                       torch.from_numpy(nsegs), sample=False)
    for name in ("z1_mu", "z2_mu", "x_mu", "x_logvar"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=0.05, rtol=0.03, err_msg=name)
    assert not torch.equal(got.x_mu, f32.x_mu)  # the rounding is applied


def test_bf16_lstm_operands_match_jax_fused_pallas(models):
    """The served setting (bf16 LSTM operands, fp32 compute) against JAX's
    ``_apply_fused`` with its Pallas kernels at ``mm_dtype=bfloat16``. Both
    round the same operands, so the tolerance is fp32-tight, and the port's
    fp32-operand output fails it: a skipped or misplaced rounding would."""
    _, params, tm = models
    jb = JaxFHVAE(input_size=T * F, use_pallas="never", lstm_pallas="always",
                  lstm_mm_dtype="bfloat16", **DIMS)
    assert jb._fused_ready(params, B, T)
    tb = FHVAE(T * F, lstm_mm_dtype="bfloat16", **DIMS)
    tb.load_state_dict(tm.state_dict())
    x, seq, nsegs = batch(6)
    want = jb.apply(params, jnp.asarray(x), jnp.asarray(seq),
                    jnp.asarray(nsegs), jax.random.PRNGKey(1), sample=False)
    args = (torch.from_numpy(x), torch.from_numpy(seq),
            torch.from_numpy(nsegs))
    with torch.inference_mode():
        got = tb.apply(*args, sample=False)
        f32 = tm.apply(*args, sample=False)
    tol = dict(atol=2e-6, rtol=1e-6)
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **tol,
                                   err_msg=name)
    for name in ("lower_bound", "log_qy", "z1_mu", "z2_mu", "x_mu",
                 "x_logvar"):
        assert not np.allclose(getattr(f32, name).numpy(),
                               np.asarray(getattr(want, name)), **tol), name


def test_encode_decode_encode_z2_match_jax(models):
    jm, params, tm = models
    x, _, _ = batch(1)
    enc = jm.encode(params, jnp.asarray(x), jax.random.PRNGKey(2),
                    sample=False)
    with torch.inference_mode():
        got = tm.encode(torch.from_numpy(x))
        z2_only = tm.encode_z2(torch.from_numpy(x))
        dec = tm.decode(got["z1"], got["z2"], num_frames=T)
    for k in enc:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(enc[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(z2_only.numpy(),
                               np.asarray(jm.encode_z2(params, jnp.asarray(x))),
                               **TOL)
    want_dec = jm.decode(params, enc["z1"], enc["z2"], num_frames=T)
    for a, b in zip(dec, want_dec):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_loss_and_table_override_match_jax(models):
    from pytorch_scalablefhvae_tpu.models.base import (
        loss_from_outputs as jax_loss,
    )

    jm, params, tm = models
    x, seq, nsegs = batch(2)
    table = np.random.default_rng(3).standard_normal((NSEQ + 2, 4)) \
        .astype(np.float32)
    weight = np.array([1, 1, 1, 1, 0, 0], np.float32)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(seq),
                    jnp.asarray(nsegs), jax.random.PRNGKey(1), sample=False,
                    mu2_table=jnp.asarray(table))
    _, want_m = jax_loss(want, jnp.asarray(weight), 10.0)
    with torch.inference_mode():
        out = tm.apply(torch.from_numpy(x), torch.from_numpy(seq),
                       torch.from_numpy(nsegs), sample=False,
                       mu2_table=torch.from_numpy(table))
        _, got_m = loss_from_outputs(out, torch.from_numpy(weight), 10.0)
    assert tuple(got_m) == METRIC_KEYS
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), **TOL)


def test_index_past_table_runs(models):
    """Utterance numbers past the table's rows clamp the mu2 gather (as JAX
    does) and pick nothing in log_qy; the forward must not fail."""
    _, _, tm = models
    x, seq, nsegs = batch(3)
    seq[:2] = [NSEQ, NSEQ + 3]
    with torch.inference_mode():
        out = tm.apply(torch.from_numpy(x), torch.from_numpy(seq),
                       torch.from_numpy(nsegs), sample=False)
    assert all(torch.isfinite(v).all() for v in out)


def test_sampling_uses_explicit_noise(models):
    _, _, tm = models
    x, seq, nsegs = batch(4)
    args = (torch.from_numpy(x), torch.from_numpy(seq), torch.from_numpy(nsegs))
    with torch.inference_mode():
        a = tm.apply(*args, sample=True,
                     generator=torch.Generator().manual_seed(5))
        b = tm.apply(*args, sample=True,
                     generator=torch.Generator().manual_seed(5))
        c = tm.apply(*args, sample=False)
    torch.testing.assert_close(a.x_mu, b.x_mu)
    assert not torch.equal(a.x_mu, c.x_mu)
    torch.testing.assert_close(a.z2_mu, c.z2_mu)


def test_unsupported_stacks_and_models_raise():
    """Every LSTM stack runs (``tests/test_torch_stacks.py``); an unknown
    model type raises."""
    with pytest.raises(ValueError, match="Unknown model_type"):
        build_model("lstm_fhvae", T * F, None, NSEQ)
