"""Checkpoints: read the JAX package's, write the port's own.

Counterpart of ``train/checkpoint.py`` (load side, plus the port's save).

The JAX ``.npz`` holds positional arrays ``leaf_0 .. leaf_{n-1}`` in the
order of ``jax.tree_util.tree_leaves(TrainState)`` plus a JSON sidecar.
``TrainState``'s params come first, and tree flattening orders dict keys
sorted and list items in order, so the name of each parameter leaf is
reckoned here in plain Python (:func:`jax_leaf_names`) without jax.

The port writes the same file names (``<model>_<run>_e<epoch>.npz`` plus
sidecar, and a ``best_model_`` copy) but with named arrays, one per
``state_dict`` key, and ``"format": "torch_named"`` in the sidecar.
Orbax checkpoint directories are not yet ported.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path

import numpy as np
import torch

_SCHEMA_VERSION = 1
PORT_FORMAT = "torch_named"


# ---------------------------------------------------------------- naming


def _nest(names):
    """Dotted names -> nested dicts; digit keys mark list items."""
    root: dict = {}
    for name in names:
        node = root
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = name
    return root


def _leaves(node) -> list[str]:
    if isinstance(node, str):
        return [node]
    keys = list(node)
    if keys and all(k.isdigit() for k in keys):
        keys.sort(key=int)  # a list: items in order
    else:
        keys.sort()         # a dict: keys sorted, as jax flattens them
    return [leaf for k in keys for leaf in _leaves(node[k])]


def jax_leaf_names(names) -> list[str]:
    """The parameter names in ``jax.tree_util.tree_leaves`` order."""
    return _leaves(_nest(names))


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """A JAX params tree (nested dicts/lists of arrays) -> a ``state_dict``
    with dotted names (``z2_lstm.cells.0.w``)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        items = (node.items() if isinstance(node, dict)
                 else enumerate(node) if isinstance(node, (list, tuple))
                 else None)
        if items is None:
            out[prefix] = torch.from_numpy(np.array(node, np.float32))
            return
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else str(k))

    walk(tree, "")
    return out


def params_to_jax(state_dict) -> dict:
    """Inverse of :func:`params_from_jax`: a nested tree of numpy arrays."""

    def build(node):
        if isinstance(node, str):
            return state_dict[node].detach().cpu().numpy()
        if node and all(k.isdigit() for k in node):
            return [build(node[k]) for k in sorted(node, key=int)]
        return {k: build(v) for k, v in node.items()}

    return build(_nest(state_dict.keys()))


# ------------------------------------------------------------------ load


def read_checkpoint_meta(checkpoint_file) -> dict:
    return json.loads(Path(checkpoint_file).with_suffix(".json").read_text())


def _adapt_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    """Slice or zero-pad dim 0 to ``rows`` (a mu2 table padded to a mesh's
    model axis)."""
    if arr.shape[0] > rows:
        return arr[:rows]
    return np.pad(arr, ((0, rows - arr.shape[0]), (0, 0)))


def load_params(checkpoint_file, model: torch.nn.Module) -> dict:
    """Load a JAX or port ``.npz`` checkpoint's parameters into ``model``
    (in place, on the model's device); returns the sidecar meta."""
    checkpoint_file = Path(checkpoint_file)
    if checkpoint_file.suffix == ".orbax":
        raise NotImplementedError(
            f"{checkpoint_file}: orbax checkpoints are not yet ported "
            f"(ROADMAP.md); save the run with --ckpt-backend npz")
    meta = read_checkpoint_meta(checkpoint_file)
    target = model.state_dict()
    with np.load(checkpoint_file) as z:
        if meta.get("format") == PORT_FORMAT:
            arrays = {k: z[k] for k in target if k in z.files}
        else:
            names = jax_leaf_names(target)
            if meta["num_leaves"] < len(names):
                raise ValueError(
                    f"{checkpoint_file} has {meta['num_leaves']} leaves; the "
                    f"model has {len(names)} parameters")
            arrays = {n: z[f"leaf_{i}"] for i, n in enumerate(names)}
    missing = sorted(set(target) - set(arrays))
    if missing:
        raise ValueError(f"{checkpoint_file} lacks parameters {missing}")
    loaded = {}
    for name, arr in arrays.items():
        want = tuple(target[name].shape)
        if arr.shape != want:
            if (name.endswith("mu2_table") and arr.ndim == 2
                    and arr.shape[1] == want[1]):
                arr = _adapt_rows(arr, want[0])
            else:
                raise ValueError(f"{name}: checkpoint {arr.shape} vs model "
                                 f"{want}")
        loaded[name] = torch.from_numpy(np.asarray(arr, np.float32))
    model.load_state_dict(loaded)
    return meta


# ------------------------------------------------------------------ save


def save_checkpoint(checkpoint_dir, model: torch.nn.Module, *, model_type: str,
                    model_params: tuple, run_info: str, epoch: int,
                    best_epoch: int, best_val_lb: float, values: dict,
                    extra_meta: dict | None = None) -> Path:
    """Write ``<model>_<run_info>_e<epoch>.npz`` with one named array per
    parameter, its sidecar, and a ``best_model_`` copy when this epoch is
    the best. Both files are committed by rename, so a killed save leaves
    no truncated checkpoint for discovery to find."""
    checkpoint_dir = Path(checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    f_str = f"{model_type}_{run_info}_e{epoch}"
    npz_path = checkpoint_dir / f"{f_str}.npz"
    meta_path = checkpoint_dir / f"{f_str}.json"
    arrays = {k: v.detach().cpu().numpy()
              for k, v in model.state_dict().items()}
    tmp = checkpoint_dir / f".{f_str}.npz.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, npz_path)
    finally:
        tmp.unlink(missing_ok=True)
    meta = {
        "schema_version": _SCHEMA_VERSION, "format": PORT_FORMAT,
        "model_type": model_type, "model_params": list(model_params),
        "epoch": epoch, "best_epoch": best_epoch,
        "best_val_lb": float(best_val_lb), "values": values,
        "num_leaves": len(arrays), **(extra_meta or {}),
    }
    meta_tmp = checkpoint_dir / f".{f_str}.json.{os.getpid()}.tmp"
    meta_tmp.write_text(json.dumps(meta, indent=2))
    os.replace(meta_tmp, meta_path)
    if best_epoch == epoch:
        shutil.copyfile(npz_path, checkpoint_dir / f"best_model_{f_str}.npz")
        shutil.copyfile(meta_path, checkpoint_dir / f"best_model_{f_str}.json")
    return npz_path


# ------------------------------------------------------------- discovery


def _epoch_of(path: Path) -> int:
    """The epoch of ``<...>_e<N>.npz``; -1 for mid-epoch (``_e<N>s<B>``) or
    unparseable names."""
    m = re.search(r"_e(\d+)\.(npz|orbax)$", path.name)
    return int(m.group(1)) if m else -1


def _one_run(exp_dir: Path, matches: list[Path], what: str) -> None:
    prefixes = {m.name.rsplit("_e", 1)[0] for m in matches}
    if len(prefixes) > 1:
        raise ValueError(
            f"{exp_dir} holds {what} checkpoints from {len(prefixes)} "
            f"different runs ({sorted(prefixes)}); pass the checkpoint path "
            f"explicitly")


def find_best_checkpoint(exp_dir) -> Path:
    """The ``best_model_*.npz`` of the experiment's one run (highest epoch
    number when several)."""
    exp_dir = Path(exp_dir)
    matches = sorted(exp_dir.glob("best_model_*.npz"), key=_epoch_of)
    if matches:
        _one_run(exp_dir, matches, "best-model")
        return matches[-1]
    if (exp_dir / "best_model_pointer.json").exists():
        raise NotImplementedError(
            f"{exp_dir} holds orbax checkpoints, which are not yet ported "
            f"(ROADMAP.md)")
    raise FileNotFoundError(f"No best-model checkpoint under {exp_dir}")


def find_epoch_checkpoint(exp_dir, step: int) -> Path:
    """The ``step``-th epoch checkpoint in epoch-number order (negative
    indices count from the end)."""
    exp_dir = Path(exp_dir)
    matches = sorted(
        (p for p in exp_dir.glob("*_e*.npz")
         if not p.name.startswith("best_model_") and _epoch_of(p) >= 0),
        key=_epoch_of)
    if not matches:
        raise FileNotFoundError(f"No epoch checkpoints under {exp_dir}")
    _one_run(exp_dir, matches, "epoch")
    return matches[step]
