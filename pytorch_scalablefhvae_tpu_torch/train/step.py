"""Training, evaluation and encoding steps: counterpart of ``train/step.py``.

One train step is forward (``FHVAE.apply`` with ``sample=True``), the loss
``-mean(lower_bound + alpha * log_qy)`` over real rows, backward (through
the kernels' autograd Functions), a global-norm clip and Adam, as the JAX
package's ``optax.chain(clip_by_global_norm(100), adam(lr, b1, b2))``.
PyTorch runs eagerly, so there is nothing to compile; the state is updated in
place.

Noise: JAX draws each step's noise from ``fold_in(rng, step)``. Here each
step seeds a fresh generator on the batch's device from ``(seed, step)``, so
a resumed run draws what an uninterrupted one would, and no generator state
is saved. The two frameworks' generators give different numbers; the tests
hand the JAX draws in through ``noise``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pytorch_scalablefhvae_tpu_torch.models.base import loss_from_outputs
from pytorch_scalablefhvae_tpu_torch.train.checkpoint import jax_leaf_names


@dataclass
class TrainState:
    """Parameters (the model's), Adam moments keyed by parameter name, the
    Adam update count, the optimizer step and the noise seed."""

    model: torch.nn.Module
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: int = 0
    step: int = 0
    seed: int = 0

    @property
    def names(self) -> list[str]:
        """Parameter names in the JAX tree's leaf order (sorted keys), the
        order the global norm sums in."""
        return jax_leaf_names(dict(self.model.named_parameters()))

    def params(self) -> dict[str, torch.Tensor]:
        named = dict(self.model.named_parameters())
        return {n: named[n] for n in self.names}


def create_train_state(model: torch.nn.Module, seed: int = 0) -> TrainState:
    """Zero Adam moments for every parameter of ``model``, step 0."""
    mu = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    nu = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return TrainState(model=model, mu=mu, nu=nu, count=0, step=0, seed=seed)


@dataclass(frozen=True)
class Optimizer:
    """Global-norm clip, then Adam in optax's bias-corrected form.

    The clip scales every gradient by ``max_norm / norm`` when the global
    norm reaches ``max_norm`` (``optax.clip_by_global_norm``;
    ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead).
    Adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
    ``p -= lr * mu_hat / (sqrt(nu_hat) + eps)`` with ``mu_hat = mu / (1 -
    b1^count)`` and the bias corrections taken in fp32, as optax does.
    """

    learning_rate: float
    beta_one: float
    beta_two: float
    grad_clip_norm: float | None = 100.0
    eps: float = 1e-8

    @torch.no_grad()
    def update(self, state: TrainState, grads: dict[str, torch.Tensor]):
        names = state.names
        params = state.params()
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        if self.grad_clip_norm is not None:
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            scale = torch.where(norm < self.grad_clip_norm,
                                torch.ones_like(norm),
                                self.grad_clip_norm / norm)
            g = torch._foreach_mul(g, scale)
        b1, b2 = self.beta_one, self.beta_two
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1.0 - b2)
        state.count += 1
        one = np.float32(1.0)
        bc1 = float(one - np.float32(b1) ** np.int32(state.count))
        bc2 = float(one - np.float32(b2) ** np.int32(state.count))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_add_(p, torch._foreach_div(
            torch._foreach_div(mu, bc1), denom), alpha=-self.learning_rate)


def make_optimizer(learning_rate: float, beta_one: float, beta_two: float,
                   grad_clip_norm: float | None = 100.0) -> Optimizer:
    """Adam with the reference hyperparameters after a global-norm clip
    (``grad_clip_norm=None`` turns the clip off)."""
    return Optimizer(learning_rate, beta_one, beta_two, grad_clip_norm)


def noise_seed(seed: int, step: int) -> int:
    """The generator seed of one step's noise."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def step_noise(state: TrainState, batch: int,
               device: torch.device) -> dict[str, torch.Tensor]:
    """This step's reparameterization noise: z2's draw, then z1's."""
    model = state.model
    g = torch.Generator(device=device)
    g.manual_seed(noise_seed(state.seed, state.step))
    eps2 = torch.randn((batch, model.z2_dim), generator=g, device=device)
    eps1 = torch.randn((batch, model.z1_dim), generator=g, device=device)
    return {"z2": eps2, "z1": eps1}


def train_step(state: TrainState, optimizer: Optimizer, feats, seq_idx, nsegs,
               weight, alpha: float, noise: dict | None = None) -> dict:
    """One optimizer step in place; returns the step's metrics (0-dim
    tensors on the batch's device, keys ``METRIC_KEYS``)."""
    if noise is None:
        noise = step_noise(state, feats.shape[0], feats.device)
    out = state.model.apply(feats, seq_idx, nsegs, sample=True, noise=noise)
    loss, metrics = loss_from_outputs(out, weight, alpha)
    params = state.params()
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    optimizer.update(state, {
        n: torch.zeros_like(p) if g is None else g
        for (n, p), g in zip(params.items(), grads)})
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


@torch.inference_mode()
def eval_step(model, feats, seq_idx, nsegs, weight, alpha: float,
              table: torch.Tensor | None = None) -> dict:
    """Posterior-mean forward: weighted sums of every metric plus the row
    count ``count``, so a caller accumulates exact split means."""
    out = model.apply(feats, seq_idx, nsegs, sample=False, mu2_table=table)
    _, metrics = loss_from_outputs(out, weight, alpha)
    n = weight.sum()
    sums = {k: v * n for k, v in metrics.items()}
    sums["count"] = n
    return sums


@torch.inference_mode()
def encode_step(model, feats) -> torch.Tensor:
    """z2 posterior means only (the z2 trunk alone)."""
    return model.encode_z2(feats)
