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

On a mesh of ranks (``parallel/mesh.py``) the same functions take this
rank's batch rows and a ``mesh``: the loss divides by the whole batch's
weight, every gradient is summed over the data group exactly once (one
all-reduce of all of them, the step's metrics riding along), the clip's
global norm counts replicated leaves once and adds the table shards' squares
over the model group, and the noise is drawn for the whole batch, of which
the rank keeps its rows: a ``(d, m)`` step is the single-device step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pytorch_scalablefhvae_tpu_torch.models.base import loss_from_outputs
from pytorch_scalablefhvae_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    is_sharded,
)
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
    def update(self, state: TrainState, grads: dict[str, torch.Tensor],
               mesh=None):
        names = state.names
        params = state.params()
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        if self.grad_clip_norm is not None:
            squares = [torch.sum(x * x) for x in g]
            if mesh is not None:
                # a row-sharded leaf's squares add up over the model group
                squares = [mesh.model_sum(q) if is_sharded(n, x) else q
                           for n, x, q in zip(names, g, squares)]
            norm = torch.sqrt(sum(squares))
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


def step_noise(state: TrainState, batch: int, device: torch.device,
               mesh=None) -> dict[str, torch.Tensor]:
    """This step's reparameterization noise: z2's draw, then z1's. With a
    ``mesh``, ``batch`` is this rank's row count: the draw is the whole
    batch's and the rank keeps its rows."""
    model = state.model
    g = torch.Generator(device=device)
    g.manual_seed(noise_seed(state.seed, state.step))
    rows = slice(None)
    if mesh is not None:
        batch *= mesh.shape[0]
        rows = mesh.local_rows(batch)
    eps2 = torch.randn((batch, model.z2_dim), generator=g, device=device)
    eps1 = torch.randn((batch, model.z1_dim), generator=g, device=device)
    return {"z2": eps2[rows], "z1": eps1[rows]}


def _sum_over_data(mesh, grads: list, metrics: dict):
    """Every gradient and metric summed over the data group in one
    all-reduce of their concatenation."""
    parts = [*grads, *metrics.values()]
    flat = mesh.all_reduce_(torch.cat([t.detach().reshape(-1) for t in parts]),
                            DATA_AXIS)
    out, at = [], 0
    for t in parts:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out[:len(grads)], dict(zip(metrics, out[len(grads):]))


def train_step(state: TrainState, optimizer: Optimizer, feats, seq_idx, nsegs,
               weight, alpha: float, noise: dict | None = None,
               mesh=None) -> dict:
    """One optimizer step in place; returns the step's metrics (0-dim
    tensors on the batch's device, keys ``METRIC_KEYS``). With a ``mesh``
    the batch arrays (and ``noise``) are this rank's rows and the model is
    the rank's (``parallel.mesh.shard_model``); the metrics returned are the
    whole batch's, the same on every rank."""
    if noise is None:
        noise = step_noise(state, feats.shape[0], feats.device, mesh)
    out = state.model.apply(feats, seq_idx, nsegs, sample=True, noise=noise)
    loss, metrics = loss_from_outputs(out, weight, alpha, mesh)
    params = state.params()
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]
    if mesh is not None:
        grads, metrics = _sum_over_data(mesh, grads, metrics)
    optimizer.update(state, dict(zip(params, grads)), mesh)
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


@torch.inference_mode()
def eval_step(model, feats, seq_idx, nsegs, weight, alpha: float,
              table: torch.Tensor | None = None) -> dict:
    """Posterior-mean forward: weighted sums of every metric plus the row
    count ``count``, so a caller accumulates exact split means. In a mesh
    run the sums are those of the rows given; the caller adds the data
    group's."""
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
