"""The port's train, eval and encode steps against the JAX package's.

Same JAX-initialised parameters and zero Adam state on both sides; the JAX
step (``make_train_step``) runs its scan/jnp path on the CPU with fp32
operands, and the port its plain versions, with the explicit plain
backward. Each step's reparameterization noise is drawn from JAX's key
schedule (``fold_in(rng, step)``, then the splits of ``FHVAE.apply``) and
handed to the port.

Limits: per-step losses to 1e-5 relative (fp32 sum order). After the steps,
Adam's moments to 1e-4 of each tensor's largest value. Parameters: Adam
moves each element by ``lr * mu_hat / (sqrt(nu_hat) + eps)``, a step of
~``lr = 1e-3`` whatever the gradient's size, so an element whose gradients
are all near zero (where the two implementations' fp32 sum orders differ
relatively most) can take a step of another size. At most 0.5% of each
tensor's elements may differ by more than 1e-5, and none by more than 2e-4,
a fifth of one step (measured: one element of 1,792 at 9.8e-5, the rest
within 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.models.fhvae import FHVAE as JaxFHVAE
from pytorch_scalablefhvae_tpu.train import step as jax_step
from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
from pytorch_scalablefhvae_tpu_torch.train import step
from pytorch_scalablefhvae_tpu_torch.train.checkpoint import (
    jax_leaf_names,
    params_from_jax,
    train_state_from_jax,
)

B, T, F, NSEQ, ALPHA = 6, 5, 8, 5, 10.0
DIMS = dict(z1_hus=(16, 16), z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4,
            z2_dim=4, num_seqs=NSEQ, feat_dim=F)
STEPS = 4


def batch(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((B, T, F))).astype(np.float32)
    seq = rng.integers(0, NSEQ, B).astype(np.int32)
    nsegs = rng.integers(1, 9, B).astype(np.float32)
    weight = np.array([1, 1, 1, 1, 1, 0], np.float32)
    return x, seq, nsegs, weight


def jax_noise(state, model):
    """The noise ``FHVAE.apply`` draws inside JAX's train step."""
    k_enc, _ = jax.random.split(jax.random.fold_in(state.rng, state.step))
    k2, k1 = jax.random.split(k_enc)
    return {"z2": torch.tensor(np.asarray(jax.random.normal(
                k2, (B, model.z2_dim), jnp.float32))),
            "z1": torch.tensor(np.asarray(jax.random.normal(
                k1, (B, model.z1_dim), jnp.float32)))}


@pytest.fixture(scope="module")
def trajectory():
    """STEPS steps on both sides from the same start: the first batch is
    scaled so that its gradient norm passes the clip at 100."""
    jm = JaxFHVAE(input_size=T * F, use_pallas="never", lstm_pallas="never",
                  lstm_mm_dtype="float32", **DIMS)
    opt = jax_step.make_optimizer(1e-3, 0.95, 0.999)
    jstate = jax_step.create_train_state(jm, opt, seed=0)
    jfn = jax_step.make_train_step(jm, opt, ALPHA, donate=False)

    tm = FHVAE(T * F, lstm_mm_dtype="float32", **DIMS)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate.params)))
    tstate = step.create_train_state(tm, seed=0)
    topt = step.make_optimizer(1e-3, 0.95, 0.999)

    batches = [batch(s, scale=30.0 if s == 0 else 1.0) for s in range(STEPS)]
    x0, s0, n0, w0 = (jnp.asarray(a) for a in batches[0])
    grads0 = jax.grad(lambda p: jax_step.loss_from_outputs(
        jm.apply(p, x0, s0, n0, jax.random.PRNGKey(0), sample=True), w0,
        ALPHA)[0])(jstate.params)
    first_norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in
                                    jax.tree_util.tree_leaves(grads0))))
    losses = []
    for arrs in batches:
        noise = jax_noise(jstate, jm)
        jstate, jm_metrics = jfn(jstate, *(jnp.asarray(a) for a in arrs))
        tm_metrics = step.train_step(tstate, topt,
                                     *(torch.from_numpy(a) for a in arrs),
                                     ALPHA, noise=noise)
        losses.append((float(jm_metrics["loss"]),
                       float(tm_metrics["loss"])))
    return jstate, tstate, losses, first_norm


def test_losses_match_step_by_step(trajectory):
    _, tstate, losses, first_norm = trajectory
    assert first_norm > 100.0  # the first step ran through the clip
    for want, got in losses:
        assert abs(got - want) <= 1e-5 * abs(want), losses
    assert tstate.step == STEPS and tstate.count == STEPS


def test_params_and_moments_match(trajectory):
    jstate, tstate, _, _ = trajectory
    names = jax_leaf_names(dict(tstate.model.named_parameters()))
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)]
    want = train_state_from_jax(leaves, names)
    assert want["step"] == STEPS and want["count"] == STEPS
    got = dict(tstate.model.named_parameters())
    for n in names:
        diff = np.abs(got[n].detach().numpy() - want["params"][n])
        assert diff.max() <= 2e-4, (n, diff.max())
        assert (diff > 1e-5).mean() <= 0.005, (n, (diff > 1e-5).sum())
        for key in ("mu", "nu"):
            ref = want[key][n]
            err = np.abs(getattr(tstate, key)[n].numpy() - ref).max()
            assert err <= 1e-4 * max(np.abs(ref).max(), 1e-30), (n, key)


def test_clip_matches_optax():
    """The clip scales by max_norm / norm once the global norm reaches the
    limit, and leaves smaller gradients alone (optax, not torch's
    clip_grad_norm_, which divides by norm + 1e-6)."""
    import optax

    rng = np.random.default_rng(5)
    tm = FHVAE(T * F, lstm_mm_dtype="float32", **DIMS)
    names = jax_leaf_names(dict(tm.named_parameters()))
    for scale in (1e-3, 1e3):
        grads = {n: (scale * rng.standard_normal(p.shape)).astype(np.float32)
                 for n, p in tm.named_parameters()}
        tx = optax.chain(optax.clip_by_global_norm(100.0),
                         optax.adam(1e-3, b1=0.95, b2=0.999))
        params = {n: p.detach().numpy().copy()
                  for n, p in tm.named_parameters()}
        upd, _ = tx.update(grads, tx.init(params), params)
        want = optax.apply_updates(params, upd)
        tstate = step.create_train_state(
            FHVAE(T * F, lstm_mm_dtype="float32", **DIMS), seed=0)
        tstate.model.load_state_dict({k: torch.from_numpy(v)
                                      for k, v in params.items()})
        step.make_optimizer(1e-3, 0.95, 0.999).update(
            tstate, {n: torch.from_numpy(g) for n, g in grads.items()})
        got = dict(tstate.model.named_parameters())
        for n in names:
            np.testing.assert_allclose(got[n].detach().numpy(),
                                       np.asarray(want[n]), atol=1e-7,
                                       rtol=0, err_msg=(scale, n))
            np.testing.assert_allclose(
                tstate.mu[n].numpy(),
                0.05 * grads[n] * min(1.0, 100.0 / np.sqrt(sum(
                    float((g.astype(np.float64) ** 2).sum())
                    for g in grads.values()))), rtol=1e-5, atol=1e-12)


def test_eval_and_encode_steps_match_jax():
    jm = JaxFHVAE(input_size=T * F, use_pallas="never", lstm_pallas="never",
                  lstm_mm_dtype="float32", **DIMS)
    params = jm.init(jax.random.PRNGKey(3))
    tm = FHVAE(T * F, lstm_mm_dtype="float32", **DIMS)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    x, seq, nsegs, weight = batch(9)
    table = np.random.default_rng(2).standard_normal((NSEQ + 3, 4)) \
        .astype(np.float32)
    want = jax_step.make_eval_step(jm, ALPHA, with_table_override=True)(
        params, jnp.asarray(x), jnp.asarray(seq), jnp.asarray(nsegs),
        jnp.asarray(weight), jax.random.PRNGKey(0), jnp.asarray(table))
    got = step.eval_step(tm, *(torch.from_numpy(a)
                               for a in (x, seq, nsegs, weight)), ALPHA,
                         torch.from_numpy(table))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-4, err_msg=k)
    z2 = step.encode_step(tm, torch.from_numpy(x))
    np.testing.assert_allclose(
        z2.numpy(), np.asarray(jax_step.make_encode_step(jm)(
            params, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_noise_is_a_function_of_seed_and_step():
    """A resumed run draws what an uninterrupted one would: the noise
    depends on (seed, step) only."""
    tm = FHVAE(T * F, **DIMS)
    a = step.create_train_state(tm, seed=3)
    b = step.create_train_state(tm, seed=3)
    a.step = b.step = 7
    na, nb = (step.step_noise(s, B, torch.device("cpu")) for s in (a, b))
    for k in ("z1", "z2"):
        torch.testing.assert_close(na[k], nb[k], rtol=0, atol=0)
    b.step = 8
    assert not torch.equal(na["z2"], step.step_noise(
        b, B, torch.device("cpu"))["z2"])
