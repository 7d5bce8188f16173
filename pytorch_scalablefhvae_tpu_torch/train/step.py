"""Training, evaluation and encoding steps: counterpart of ``train/step.py``.

One train step is forward (the model's ``apply`` with ``sample=True``:
``FHVAE`` or ``SimpleFHVAE``, which share its surface), the loss
``-mean(lower_bound + alpha * log_qy)`` over real rows, backward (through
the kernels' autograd Functions), a global-norm clip and Adam, as the JAX
package's ``optax.chain(clip_by_global_norm(100), adam(lr, b1, b2))``.
A step runs eagerly, or K of them replay as one CUDA graph
(``train/graphs.py``); the state is updated in place.

Noise: JAX draws each step's noise from ``fold_in(rng, step)``. Here each
step seeds a generator on the batch's device from ``(seed, step)``, so
a resumed run draws what an uninterrupted one would, and no generator state
is saved. The two frameworks' generators give different numbers; the tests
hand the JAX draws in through ``noise``.

:func:`step_body` is the one definition of a step's device work, shared by
the eager step (:func:`train_step`) and the K-step bundle that
``train/graphs.py`` captures as a CUDA graph. It reads Adam's bias
corrections from a device tensor and touches no host state (``count``,
``step``): a capture runs the Python once, so a host value read or
incremented inside it would be frozen at capture time.

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


@torch.no_grad()
def replace_mu2_table(state: TrainState, table: torch.Tensor) -> None:
    """A hierarchical round's turnover (the JAX loop's
    ``_replace_mu2_table``): the new round's table, whole and padded to the
    model's ``num_seqs_padded`` rows, into ``mu2_table`` (on a mesh this
    rank's rows of it, ``Mesh.table_shard``) and its Adam ``mu`` and ``nu``
    zeroed, matched by the parameter's name, not by shape; the other
    moments, ``count`` and ``step`` stay. In place (``copy_``, ``zero_``):
    a captured K-step graph keeps the addresses of the parameters and the
    moments (under NCCL with its all-reduces inside), so a tensor bound in
    their place would never be read by its replays."""
    mesh = state.model.shard_mesh
    if mesh is not None:
        table = mesh.table_shard(table)
    for name, p in state.model.named_parameters():
        if name.rsplit(".", 1)[-1] == "mu2_table":
            p.copy_(table)
            state.mu[name].zero_()
            state.nu[name].zero_()


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

    def bias_corrections(self, count: int, n: int = 1,
                         device="cpu") -> np.ndarray:
        """``[n, 2]`` fp32: the operands of Adam's bias corrections ``(1 -
        b1^c, 1 - b2^c)`` for the update counts ``c = count + 1 .. count +
        n`` on ``device``. Each correction is computed on the host as
        optax's fp32 arithmetic gives it, and its operand is what
        ``_foreach_div`` by that host float uses on ``device`` (see
        :func:`unbias`), so a step gives the same bits with its
        corrections on the device as with host floats."""
        one = np.float32(1.0)
        bc = np.array([[float(one - np.float32(b) ** np.int32(c))
                        for b in (self.beta_one, self.beta_two)]
                       for c in range(count + 1, count + n + 1)])
        if torch.device(device).type == "cuda":
            bc = 1.0 / bc
        return bc.astype(np.float32)

    @torch.no_grad()
    def update(self, state: TrainState, grads: dict[str, torch.Tensor],
               mesh=None, bc: torch.Tensor | None = None):
        """One update of ``state``'s parameters and moments in place.
        ``bc``: this update's :meth:`bias_corrections`, a ``[2]`` fp32
        tensor on the parameters' device, with which the update touches no
        host state (the K-step bundle's form). Without it this is the next
        update of ``state.count``: the corrections come from the host and
        the count goes up by one."""
        names = state.names
        params = state.params()
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        if bc is None:
            bc = host_to_device(self.bias_corrections(
                state.count, device=p[0].device)[0], p[0].device)
            state.count += 1
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
        denom = torch._foreach_sqrt(unbias(nu, bc[1]))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_add_(p, torch._foreach_div(unbias(mu, bc[0]), denom),
                            alpha=-self.learning_rate)


def unbias(xs: list, operand: torch.Tensor) -> list:
    """``xs`` divided by a bias correction whose operand
    (:meth:`Optimizer.bias_corrections`) is on their device, bit for bit as
    ``torch._foreach_div(xs, correction)`` by the host float: on CUDA that
    multiplies by the fp32 rounding of the float's reciprocal (taken in
    double), on the CPU it divides by the float's fp32 rounding."""
    if operand.is_cuda:
        return torch._foreach_mul(xs, operand)
    return torch._foreach_div(xs, operand)


def host_to_device(arr, device: torch.device) -> torch.Tensor:
    """A host array (numpy, or a CPU tensor such as a bfloat16 batch) on
    ``device`` without waiting for the device: on a GPU a pinned copy and
    an asynchronous transfer."""
    t = (arr.contiguous() if isinstance(arr, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(arr)))
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def make_optimizer(learning_rate: float, beta_one: float, beta_two: float,
                   grad_clip_norm: float | None = 100.0) -> Optimizer:
    """Adam with the reference hyperparameters after a global-norm clip
    (``grad_clip_norm=None`` turns the clip off)."""
    return Optimizer(learning_rate, beta_one, beta_two, grad_clip_norm)


def noise_seed(seed: int, step: int) -> int:
    """The generator seed of one step's noise."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def draw_noise(model, generator: torch.Generator, batch: int,
               device: torch.device) -> dict[str, torch.Tensor]:
    """One step's reparameterization noise from ``generator``: z2's draw,
    then z1's."""
    return {"z2": torch.randn((batch, model.z2_dim), generator=generator,
                              device=device),
            "z1": torch.randn((batch, model.z1_dim), generator=generator,
                              device=device)}


def seeded_noise(model, seed: int, batch: int, device: torch.device,
                 mesh=None) -> dict[str, torch.Tensor]:
    """:func:`draw_noise` from a generator on ``device`` seeded with
    ``seed``. With a ``mesh``, ``batch`` is this rank's row count: the draw
    is the whole batch's and the rank keeps its rows."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rows = slice(None)
    if mesh is not None:
        batch *= mesh.shape[0]
        rows = mesh.local_rows(batch)
    eps = draw_noise(model, g, batch, device)
    return {k: v[rows] for k, v in eps.items()}


def step_noise(state: TrainState, batch: int, device: torch.device,
               mesh=None) -> dict[str, torch.Tensor]:
    """This step's reparameterization noise: z2's draw, then z1's
    (:func:`seeded_noise` of ``(seed, step)``)."""
    return seeded_noise(state.model, noise_seed(state.seed, state.step),
                        batch, device, mesh)


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


def batch_grads(state: TrainState, feats, seq_idx, nsegs, weight,
                alpha: float, noise: dict, mesh=None):
    """Forward, loss and backward of one batch: ``(grads, metrics)``, the
    gradient of every parameter by name (in the JAX tree's leaf order; on a
    mesh summed over the data group) and the batch's metrics."""
    out = state.model.apply(feats, seq_idx, nsegs, sample=True, noise=noise)
    loss, metrics = loss_from_outputs(out, weight, alpha, mesh)
    params = state.params()
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]
    if mesh is not None:
        grads, metrics = _sum_over_data(mesh, grads, metrics)
    return dict(zip(params, grads)), metrics


def step_body(state: TrainState, optimizer: Optimizer, feats, seq_idx, nsegs,
              weight, alpha: float, noise: dict, mesh=None,
              bc: torch.Tensor | None = None) -> dict:
    """A step's device work: forward, loss, backward (:func:`batch_grads`),
    clip and Adam in place; returns the step's metrics (0-dim tensors on the
    batch's device, keys ``METRIC_KEYS``). With ``bc`` (see
    :meth:`Optimizer.update`) it touches no host state."""
    grads, metrics = batch_grads(state, feats, seq_idx, nsegs, weight, alpha,
                                 noise, mesh)
    optimizer.update(state, grads, mesh, bc)
    return {k: v.detach() for k, v in metrics.items()}


def snapshot_noise(state: TrainState, epoch: int, batch: int,
                   device: torch.device, mesh=None) -> dict:
    """The noise of epoch ``epoch``'s gradient snapshot: the JAX loop draws
    it from its eval key folded with ``100000 + epoch``; here
    :func:`seeded_noise` of ``(seed + 17, 100000 + epoch)``."""
    return seeded_noise(state.model,
                        noise_seed(state.seed + 17, 100000 + epoch), batch,
                        device, mesh)


def make_grad_step(alpha: float, mesh=None):
    """The ``--log-params`` gradient snapshot (JAX ``make_grad_step``): the
    gradient of every parameter for one batch, with no update, through the
    step's own forward and backward (:func:`batch_grads`, so on CUDA the
    kernels' forward and backward). It runs eagerly, also beside a K-step
    bundle, whose captured graph reads the parameters and never this
    snapshot's tensors. Returns ``fn(state, feats, seq_idx, nsegs, weight,
    noise) -> {name: grad}``; on a mesh every rank calls it with its rows,
    and the table's gradient is the rank's shard."""

    def grad_step(state: TrainState, feats, seq_idx, nsegs, weight,
                  noise: dict) -> dict:
        grads, _ = batch_grads(state, feats, seq_idx, nsegs, weight, alpha,
                               noise, mesh)
        return {k: v.detach() for k, v in grads.items()}

    return grad_step


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
    metrics = step_body(state, optimizer, feats, seq_idx, nsegs, weight,
                        alpha, noise, mesh)
    state.step += 1
    return metrics


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
