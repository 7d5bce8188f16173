"""Neural-net building blocks: counterpart of ``models/layers.py``.

Parameters keep the JAX layout and tree names: a dense layer is
``x @ w + b`` with ``w [d_in, d_out]``; an MLP holds ``layers``, a list of
dense layers (``z2_pre.layers.0.w``); a Gaussian head holds ``mu`` and
``logvar`` dense layers. Initialization: Glorot-uniform weights, zero biases,
drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

LOGVAR_BOUND = 9.0
_LOG_2PI = math.log(2.0 * math.pi)


def uniform(shape, limit: float, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, generator: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(uniform((d_in, d_out),
                                      math.sqrt(6.0 / (d_in + d_out)),
                                      generator))
        self.b = nn.Parameter(torch.zeros(d_out))


class MLP(nn.Module):
    def __init__(self, d_in: int, hus, generator: torch.Generator):
        super().__init__()
        dims = [d_in, *hus]
        self.layers = nn.ModuleList(Dense(a, b, generator)
                                    for a, b in zip(dims, dims[1:]))


class GaussHead(nn.Module):
    def __init__(self, d_in: int, dim: int, generator: torch.Generator):
        super().__init__()
        self.mu = Dense(d_in, dim, generator)
        self.logvar = Dense(d_in, dim, generator)


def matmul(x: torch.Tensor, w: torch.Tensor,
           compute_dtype: str = "float32") -> torch.Tensor:
    """``x @ w``; ``compute_dtype="bfloat16"`` rounds both operands to bf16
    and accumulates in fp32 (the MXU semantics of the JAX layer)."""
    if compute_dtype == "bfloat16":
        x, w = x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
    return x @ w


def dense(p: Dense, x: torch.Tensor, compute_dtype: str = "float32"):
    """``x @ w + b``, the product by :func:`matmul`."""
    return matmul(x, p.w, compute_dtype) + p.b


def mlp(p: MLP, x: torch.Tensor, compute_dtype: str = "float32"):
    """A ReLU after every dense layer (the reference's stacked
    ``VariableLinearLayer``)."""
    for layer in p.layers:
        x = torch.relu(dense(layer, x, compute_dtype))
    return x


def gauss_head(p: GaussHead, x: torch.Tensor, compute_dtype: str = "float32",
               sample: bool = False, eps: torch.Tensor | None = None,
               generator: torch.Generator | None = None):
    """Gaussian layer: ``(mu, logvar, z)``.

    logvar is softly bounded to ``±LOGVAR_BOUND`` with a tanh so the ELBO's
    ``exp(±logvar)`` terms cannot overflow fp32 (the JAX package's documented
    deviation from the reference). With ``sample`` the draw is
    ``mu + eps * exp(logvar / 2)``, ``eps`` given or drawn from ``generator``
    (which must live on ``x``'s device); without it ``z = mu``.
    """
    mu = dense(p.mu, x, compute_dtype)
    logvar = LOGVAR_BOUND * torch.tanh(dense(p.logvar, x, compute_dtype)
                                       / LOGVAR_BOUND)
    if not sample:
        return mu, logvar, mu
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                          dtype=mu.dtype)
    return mu, logvar, mu + eps * torch.exp(0.5 * logvar)


def log_gauss(x, mu=0.0, logvar=0.0):
    """log N(x; mu, exp(logvar)), elementwise."""
    logvar = torch.as_tensor(logvar, dtype=torch.float32)
    return -0.5 * (_LOG_2PI + logvar + (x - mu) ** 2 / torch.exp(logvar))


def kld(p_mu, p_logvar, q_mu, q_logvar):
    """D_KL(N(p_mu, e^p_logvar) || N(q_mu, e^q_logvar)), elementwise."""
    q_logvar = torch.as_tensor(q_logvar, dtype=torch.float32)
    return -0.5 * (1.0 + p_logvar - q_logvar
                   - ((p_mu - q_mu) ** 2 + torch.exp(p_logvar))
                   / torch.exp(q_logvar))
