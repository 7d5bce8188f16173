"""Checkpoints: read the JAX package's, write the port's own.

Counterpart of ``train/checkpoint.py``.

The JAX ``.npz`` holds positional arrays ``leaf_0 .. leaf_{n-1}`` in the
order of ``jax.tree_util.tree_leaves(TrainState)`` plus a JSON sidecar.
Tree flattening orders dict keys sorted and list items in order, so the
name of each parameter leaf is reckoned here in plain Python
(:func:`jax_leaf_names`) without jax, and a whole JAX ``TrainState`` —
params, then the Adam ``count``, ``mu`` and ``nu`` (the clip has no state),
then ``step`` and the PRNG key — maps onto the port's
(:func:`train_state_from_jax`): a JAX run resumes in the port.

The port writes the same file names (``<model>_<run>_e<epoch>.npz`` plus
sidecar, and a ``best_model_`` copy; a step checkpoint of
``--ckpt-every-steps`` / ``--max-steps`` is
``<model>_<run>_e<epoch>s<batches>`` with the epoch's cursor in its sidecar
and no ``best_model_`` copy, and :func:`cleanup_mid_epoch` deletes it once
its epoch's checkpoint is committed) but with named arrays, one per
``state_dict`` key, plus ``adam_mu.<name>``, ``adam_nu.<name>``,
``adam_count`` and ``step`` when it saves a training state, and
``"format": "torch_named"`` in the sidecar. ``--ckpt-backend orbax`` saves
asynchronously into ``.orbax`` directories of ``torch.distributed.checkpoint``
(``train/orbax_backend.py``); :func:`load_params`, :func:`load_train_state`
and :func:`saved_table_rows` take either, as the JAX package's loads do, and
:func:`find_best_checkpoint` resolves the orbax backend's
``best_model_pointer.json``, falling back to the best committed epoch when
the pointer's save never committed.

A mesh run (``parallel/mesh.py``) saves from rank 0 the whole mu2 table and
its moments, padded to the run's model axis and gathered over the model
group (the orbax backend writes each rank's rows instead); a load fits the
rows to the loading run's padding and keeps the rank's shard, so a
checkpoint moves between mesh shapes and to one device, and a JAX mesh
run's checkpoint loads the same way.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import warnings
from pathlib import Path

import numpy as np
import torch

from pytorch_scalablefhvae_tpu_torch.parallel.mesh import whole_tensors
from pytorch_scalablefhvae_tpu_torch.train import trace

_SCHEMA_VERSION = 1
PORT_FORMAT = "torch_named"
_MU, _NU, _COUNT, _STEP = "adam_mu.", "adam_nu.", "adam_count", "step"


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


def _fit_table(arr: np.ndarray, model) -> np.ndarray:
    """A saved mu2 table (or moment of it) for ``model``: its rows fitted to
    the model's padding and, in a mesh run, the rank's shard of them."""
    arr = _adapt_rows(arr, model.num_seqs_padded)
    mesh = model.shard_mesh
    return arr if mesh is None else arr[mesh.table_rows(arr.shape[0])]


def load_params(checkpoint_file, model: torch.nn.Module) -> dict:
    """Load a JAX or port ``.npz`` checkpoint's, or an ``.orbax``
    directory's, parameters into ``model`` (in place, on the model's
    device); returns the sidecar meta."""
    checkpoint_file = Path(checkpoint_file)
    if checkpoint_file.suffix == ".orbax":
        from pytorch_scalablefhvae_tpu_torch.train.orbax_backend import (
            load_params_orbax,
        )

        return load_params_orbax(checkpoint_file, model)
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
        if (name.endswith("mu2_table") and arr.ndim == 2
                and arr.shape[1] == want[1]):
            arr = _fit_table(arr, model)
        if arr.shape != want:
            raise ValueError(f"{name}: checkpoint {arr.shape} vs model "
                             f"{want}")
        loaded[name] = torch.from_numpy(np.asarray(arr, np.float32))
    model.load_state_dict(loaded)
    return meta


def saved_table_rows(checkpoint_file, model: torch.nn.Module) -> int:
    """The row count of the mu2 table a port or JAX ``.npz`` holds
    (``model`` names the JAX checkpoint's leaves), or an ``.orbax``
    directory (its DCP metadata; the sidecar's ``table_rows`` or
    ``num_seqs`` where that cannot be read)."""
    meta = read_checkpoint_meta(checkpoint_file)
    if Path(checkpoint_file).suffix == ".orbax":
        from pytorch_scalablefhvae_tpu_torch.train.orbax_backend import (
            saved_mu2_rows,
        )

        rows = saved_mu2_rows(checkpoint_file)
        return int(rows if rows is not None
                   else meta.get("table_rows", meta.get("num_seqs")))
    name = next(n for n in model.state_dict() if n.endswith("mu2_table"))
    if meta.get("format") != PORT_FORMAT:
        name = f"leaf_{jax_leaf_names(model.state_dict()).index(name)}"
    with np.load(checkpoint_file) as z:
        return int(z[name].shape[0])


def train_state_from_jax(leaves, names) -> dict:
    """A JAX ``TrainState``'s leaves (``tree_leaves`` order) -> the port's:
    ``{"params", "mu", "nu"}`` (name -> array) plus ``count`` and ``step``.
    ``names`` are the parameter names in leaf order
    (:func:`jax_leaf_names`)."""
    n = len(names)
    if len(leaves) != 3 * n + 3:
        raise ValueError(
            f"a JAX TrainState of {n} parameters has {3 * n + 3} leaves "
            f"(params, Adam count/mu/nu, step, PRNG key); got {len(leaves)}")
    return {
        "params": dict(zip(names, leaves[:n])),
        "count": int(np.asarray(leaves[n])),
        "mu": dict(zip(names, leaves[n + 1:2 * n + 1])),
        "nu": dict(zip(names, leaves[2 * n + 1:3 * n + 1])),
        "step": int(np.asarray(leaves[3 * n + 1])),
    }


def corpus_fingerprint(seq_keys) -> str:
    """Order-sensitive fingerprint of a corpus's sequence keys (the JAX
    package's, so either package's checkpoints compare): the mu2 table pairs
    row i with sequence i by position."""
    h = hashlib.blake2b(digest_size=16)
    for k in seq_keys:
        h.update(str(k).encode())
        h.update(b"\n")
    return h.hexdigest()


def check_same_corpus(meta: dict, expected_num_seqs: int | None,
                      checkpoint_file,
                      expected_fingerprint: str | None = None) -> None:
    """Refuse to resume onto another corpus: the mu2 table is per-sequence
    state (``--finetune`` is the cross-corpus path). Sidecars without the
    keys skip the check."""
    saved = meta.get("num_seqs")
    if (saved is not None and expected_num_seqs is not None
            and int(saved) != int(expected_num_seqs)):
        raise ValueError(
            f"Checkpoint {checkpoint_file} was trained on a corpus of {saved} "
            f"sequences but this run has {expected_num_seqs}: the mu2 table "
            f"is per-sequence state and cannot transfer. Use --finetune to "
            f"reuse the encoder/decoder weights with a fresh table.")
    saved_fp = meta.get("corpus_fingerprint")
    if (saved_fp is not None and expected_fingerprint is not None
            and saved_fp != expected_fingerprint):
        raise ValueError(
            f"Checkpoint {checkpoint_file} was trained on a corpus whose "
            f"ordered sequence keys differ from this run's: the mu2 table "
            f"pairs rows with sequences by position. Use --finetune to reuse "
            f"the encoder/decoder weights with a fresh table.")


def load_train_state(checkpoint_file, state, finetune: bool = False,
                     expected_num_seqs: int | None = None,
                     expected_fingerprint: str | None = None) -> dict:
    """Restore a training state (in place) from a port or JAX ``.npz``, or
    from an ``.orbax`` directory (``orbax_backend.load_checkpoint_orbax``).

    The parameters always load. Unless ``finetune``, the Adam moments, count
    and step load too and ``meta["start_epoch"]`` is the saved epoch + 1;
    with ``finetune`` the optimizer state stays fresh, the history is
    dropped and training starts at epoch 0. A non-finetune load onto another
    corpus raises (:func:`check_same_corpus`). Returns the sidecar meta.
    """
    checkpoint_file = Path(checkpoint_file)
    if checkpoint_file.suffix == ".orbax":
        from pytorch_scalablefhvae_tpu_torch.train.orbax_backend import (
            load_checkpoint_orbax,
        )

        return load_checkpoint_orbax(checkpoint_file, state, finetune,
                                     expected_num_seqs, expected_fingerprint)
    meta = load_params(checkpoint_file, state.model)
    if finetune:
        return dict(meta, start_epoch=0, values={}, best_val_lb=-np.inf,
                    best_epoch=0)
    check_same_corpus(meta, expected_num_seqs, checkpoint_file,
                      expected_fingerprint)
    names = jax_leaf_names(state.mu)
    with np.load(checkpoint_file) as z:
        if meta.get("format") == PORT_FORMAT:
            missing = [k for k in (_COUNT, _STEP) if k not in z.files]
            if missing:
                raise ValueError(f"{checkpoint_file} holds no training state "
                                 f"(no {missing}); resume needs one, or use "
                                 f"--finetune")
            saved = {"mu": {n: z[_MU + n] for n in names},
                     "nu": {n: z[_NU + n] for n in names},
                     "count": int(z[_COUNT]), "step": int(z[_STEP])}
        else:
            saved = train_state_from_jax(
                [z[f"leaf_{i}"] for i in range(meta["num_leaves"])], names)
    for key in ("mu", "nu"):
        target = getattr(state, key)
        for n in names:
            arr = saved[key][n]
            if n.endswith("mu2_table"):
                arr = _fit_table(arr, state.model)
            target[n].copy_(torch.from_numpy(np.asarray(arr, np.float32)))
    state.count, state.step = saved["count"], saved["step"]
    return dict(meta, start_epoch=meta["epoch"] + 1)


# ------------------------------------------------------------------ save


def save_checkpoint(checkpoint_dir, model: torch.nn.Module, *, model_type: str,
                    model_params: tuple, run_info: str, epoch: int,
                    best_epoch: int, best_val_lb: float, values: dict,
                    extra_meta: dict | None = None, train_state=None,
                    summary_vals: dict | None = None,
                    suffix: str = "") -> Path:
    """Write ``<model>_<run_info>_e<epoch><suffix>.npz`` with one named array
    per parameter (plus the Adam moments, count and step of ``train_state``
    when given), its sidecar, and a ``best_model_`` copy when this epoch is
    the best and ``suffix`` is empty (a step checkpoint, ``s<batches>``,
    never makes one: the best is an epoch's). Both files are committed by
    rename, so a killed save leaves no truncated checkpoint for discovery
    to find. In a mesh run every rank calls this (the row-sharded leaves
    are gathered over the model group) and rank 0 alone writes."""
    checkpoint_dir = Path(checkpoint_dir)
    f_str = f"{model_type}_{run_info}_e{epoch}{suffix}"
    npz_path = checkpoint_dir / f"{f_str}.npz"
    meta_path = checkpoint_dir / f"{f_str}.json"
    tensors = dict(model.state_dict())
    if train_state is not None:
        for n in train_state.mu:
            tensors[_MU + n] = train_state.mu[n]
            tensors[_NU + n] = train_state.nu[n]
    mesh = getattr(model, "shard_mesh", None)
    with trace.span("save.to_host"):
        if mesh is not None:
            tensors = whole_tensors(mesh, tensors)
            if mesh.rank != 0:
                return npz_path
        arrays = {k: v.detach().cpu().numpy() for k, v in tensors.items()}
    if train_state is not None:
        arrays[_COUNT] = np.int32(train_state.count)
        arrays[_STEP] = np.int32(train_state.step)
    if trace.ON:
        trace.count("ckpt_bytes", sum(a.nbytes for a in arrays.values()))
    with trace.span("save.write"):
        checkpoint_dir.mkdir(parents=True, exist_ok=True)
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
            "summary_vals": summary_vals or {}, "num_leaves": len(arrays),
            **({} if train_state is None else {"step": train_state.step,
                                               "seed": train_state.seed}),
            **(extra_meta or {}),
        }
        meta_tmp = checkpoint_dir / f".{f_str}.json.{os.getpid()}.tmp"
        meta_tmp.write_text(json.dumps(meta, indent=2))
        os.replace(meta_tmp, meta_path)
    if best_epoch == epoch and not suffix:
        with trace.span("save.best_copy"):
            shutil.copyfile(npz_path,
                            checkpoint_dir / f"best_model_{f_str}.npz")
            shutil.copyfile(meta_path,
                            checkpoint_dir / f"best_model_{f_str}.json")
    return npz_path


def cleanup_mid_epoch(checkpoint_dir, model_type: str, run_info: str,
                      upto_epoch: int) -> None:
    """Delete this run's step-cadence checkpoints (``_e<E>s<B>.npz`` and
    ``.json``; an ``.orbax`` directory as well) of epochs up to
    ``upto_epoch``: once that epoch's checkpoint is committed they are
    redundant. Another run's files in the same directory stay."""
    checkpoint_dir = Path(checkpoint_dir)
    pat = re.compile(re.escape(f"{model_type}_{run_info}_e")
                     + r"(\d+)s\d+\.(npz|json|orbax)$")
    for p in checkpoint_dir.glob(f"{model_type}_{run_info}_e*s*"):
        m = pat.match(p.name)
        if m and int(m.group(1)) <= upto_epoch:
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
            else:
                p.unlink(missing_ok=True)


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
    number when several), else the ``.orbax`` directory that
    ``best_model_pointer.json`` names. A pointer whose save never committed
    falls back, with a warning, to the epoch that the newest committed
    epoch checkpoint of the same run records as best (else that newest
    one), as the JAX package's does."""
    exp_dir = Path(exp_dir)
    matches = sorted(exp_dir.glob("best_model_*.npz"), key=_epoch_of)
    if matches:
        _one_run(exp_dir, matches, "best-model")
        return matches[-1]
    pointer = exp_dir / "best_model_pointer.json"
    if pointer.exists():
        target = Path(json.loads(pointer.read_text())["path"])
        if target.exists():
            return target
        run_prefix = target.name.rsplit("_e", 1)[0]
        committed = sorted((p for p in exp_dir.glob(f"{run_prefix}_e*.orbax")
                            if _epoch_of(p) >= 0), key=_epoch_of)
        if committed:
            pick = committed[-1]
            try:
                best = int(read_checkpoint_meta(pick).get("best_epoch", -1))
            except (OSError, ValueError):
                best = -1
            pick = {_epoch_of(p): p for p in committed}.get(best, pick)
            warnings.warn(
                f"best_model_pointer.json points at {target} which never "
                f"committed (interrupted async save); falling back to the "
                f"best committed checkpoint {pick}")
            return pick
    raise FileNotFoundError(f"No best-model checkpoint under {exp_dir}")


def find_epoch_checkpoint(exp_dir, step: int) -> Path:
    """The ``step``-th epoch checkpoint in epoch-number order (negative
    indices count from the end): the ``.npz`` files, else the ``.orbax``
    directories; never a ``best_model_`` copy or a step checkpoint."""
    exp_dir = Path(exp_dir)

    def epochs(pattern):
        return sorted((p for p in exp_dir.glob(pattern)
                       if not p.name.startswith("best_model_")
                       and _epoch_of(p) >= 0), key=_epoch_of)

    matches = epochs("*_e*.npz") or epochs("*_e*.orbax")
    if not matches:
        raise FileNotFoundError(f"No epoch checkpoints under {exp_dir}")
    _one_run(exp_dir, matches, "epoch")
    return matches[step]
