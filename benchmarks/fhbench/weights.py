"""The initial weights of a run, made from its seed on the device, and the
file the program starts from.

Glorot-uniform weights, zero biases with an LSTM cell's forget-gate slice at
1.0, and a ``N(0, mu2_init_std^2)`` mu2 table (the models' published
initialisation), drawn in two calls: one uniform draw for every weight and
one normal draw for the table. The file is the program's named ``.npz``
checkpoint layout with its JSON sidecar; the program reads it with
``--finetune`` semantics (weights only), and the reference gets the same
tensors.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from reference import common


def make(model, num_seqs: int, mu2_init_std: float, seed: int,
         device: torch.device) -> dict:
    """``{name: float32 tensor on device}`` for ``model``'s parameters."""
    shapes = model.shapes(num_seqs)
    names = sorted(shapes)
    weights = [n for n in names if common.glorot_limit(n, shapes[n])]
    g = torch.Generator(device=device)
    g.manual_seed((seed * 7919 + 11) % (1 << 63))
    sizes = [int(np.prod(shapes[n])) for n in weights]
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    params = {}
    for n, part in zip(weights, torch.split(flat, sizes)):
        params[n] = (part * common.glorot_limit(n, shapes[n])) \
            .reshape(shapes[n])
    params["mu2_table"] = mu2_init_std * torch.randn(
        shapes["mu2_table"], generator=g, device=device)
    for n in names:
        if n not in params:
            params[n] = common.bias_init(n, shapes[n]).to(device)
    return {n: params[n].contiguous() for n in names}


def write(path: Path, params: dict, model_type: str) -> Path:
    """``path`` (``.npz``) and its sidecar in the program's checkpoint
    layout: one named array per parameter, no optimizer state."""
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{n: t.detach().cpu().numpy() for n, t in params.items()})
    path.with_suffix(".json").write_text(json.dumps({
        "schema_version": 1, "format": "torch_named",
        "model_type": model_type, "epoch": -1, "num_leaves": len(params)}))
    return path
