"""Async, sharded checkpoints on ``torch.distributed.checkpoint`` (DCP):
counterpart of ``train/orbax_backend.py`` (``--ckpt-backend orbax``).

The name stays the JAX package's (``cli/args.py`` is a copy held equal to
the original), and so does what it means: saves are asynchronous and every
rank of a mesh writes its own shard, without the whole-table gather of the
npz backend (``train/checkpoint.py``).

A checkpoint is the directory ``<model>_<run>_e<epoch><suffix>.orbax``
plus its JSON sidecar ``<model>_<run>_e<epoch><suffix>.json``, which holds
the JAX sidecar's keys (``schema_version``, ``backend: "orbax"``,
``epoch``, ``table_rows`` and the loop's meta) and ``"format":
"torch_dcp"``. The DCP keys are the npz backend's names: the parameters,
``adam_mu.<name>``, ``adam_nu.<name>``, ``adam_count`` and ``step``. The
best epoch's save writes ``best_model_pointer.json`` (``{"path",
"epoch"}``); a step checkpoint (``suffix`` ``s<batches>``) never does.

:func:`save_checkpoint_orbax` returns once the state is staged: every
tensor copied into host memory, the copies finished before it returns, so
the optimizer's in-place updates and the K-step graph replays that follow
cannot reach what is being written. The writes run on one background
thread, one save after another as orbax's checkpointer serialises them;
:func:`wait_for_saves` joins them and raises the first write that failed,
and the next save raises a failed one too. DCP's own stagers are not used:
the copy is this module's, whatever the torch version.

DCP writes into its target directly, so a save writes into a hidden
``.<name>.orbax.tmp`` and renames it once DCP's ``.metadata`` is written,
which on a mesh comes after DCP's finishing collective, when every rank's
files are in: as with orbax, "the ``.orbax`` directory exists" means
"committed". The sidecar and the pointer are written when the save is
staged, so a crash before the commit leaves a sidecar without its
directory; :func:`load_checkpoint_orbax` then falls back to the newest
committed checkpoint of the same run, and ``find_best_checkpoint`` to the
best committed epoch (JAX ``train/checkpoint.py:312-370``).

On a mesh (``parallel/mesh.py``) every rank calls the save; rank 0 alone
writes the sidecar and the pointer and commits. The mu2 table and its two
moments go to DCP as ``DTensor`` s placed ``[Replicate(), Shard(0)]`` on a
``(data, model)`` device mesh (JAX's ``P("model", None)``), so each model
rank's rows are written once, by one rank of its column, and no rank holds
the whole table; DCP writes every replicated tensor once too. DCP's
collectives run on a gloo group of all ranks made at the first save, so
that the step's NCCL all-reduces and their captured graphs stay as they
are. A load reads each tensor whole at its saved shape and fits the table
to the loading run (``checkpoint._fit_table``), so a checkpoint moves
between mesh shapes and to and from one device.

Directories that the JAX package's orbax wrote hold no DCP ``.metadata``
and are refused: reading them needs the ``orbax`` package, which the port
does not use (``ROADMAP.md``).
"""

from __future__ import annotations

import functools
import json
import os
import re
import shutil
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pytorch_scalablefhvae_tpu_torch.parallel.mesh import is_sharded
from pytorch_scalablefhvae_tpu_torch.train import trace
from pytorch_scalablefhvae_tpu_torch.train.checkpoint import (
    _COUNT,
    _MU,
    _NU,
    _STEP,
    _fit_table,
    check_same_corpus,
    read_checkpoint_meta,
)

_SCHEMA_VERSION = 1
DCP_FORMAT = "torch_dcp"


@functools.cache
def _dcp():
    """``torch.distributed.checkpoint``, imported at the first save or load:
    the import adds about a second to a process's start, which the npz
    backend's runs, ``eval`` and ``serve`` need not pay."""
    import torch.distributed.checkpoint as dcp

    # DCP warns on every save and load with no_dist=True (one device, and
    # every load), which is this module's intent, not a fault
    warnings.filterwarnings("ignore", message=r"torch\.distributed is "
                            r"disabled, unavailable or uninitialized")
    return dcp


class _Saver:
    """One background writer: a save's writes run after the one before it
    (the JAX module's long-lived checkpointer)."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="dcp-save")
        self._pending: list[Future] = []

    def submit(self, write) -> None:
        self.raise_failed()
        self._pending.append(self._pool.submit(write))

    def raise_failed(self) -> None:
        """Drop the finished saves; raise the first that failed."""
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            f.result()

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        errors = []
        for f in pending:
            try:
                f.result()
            except Exception as e:  # joined all first, then raised
                errors.append(e)
        if errors:
            raise errors[0]


_SAVER: _Saver | None = None
_GROUPS: dict = {}  # "world": their default group, "gloo", shape: DeviceMesh


def _saver() -> _Saver:
    global _SAVER
    if _SAVER is None:
        _SAVER = _Saver()
    return _SAVER


def wait_for_saves() -> None:
    """Block until every async save of this process has committed; raise
    the first one that failed."""
    if _SAVER is not None:
        _SAVER.wait()


def _mesh_groups(mesh):
    """The gloo group of all ranks that DCP collects on, made once per
    default process group (every rank makes it at the same save, as
    ``new_group`` needs), and the ``(data, model)`` ``DeviceMesh`` of the
    table's DTensors, which makes no group of its own."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.group.WORLD
    if _GROUPS.get("world") is not world:
        _GROUPS.clear()
        _GROUPS.update(world=world, gloo=dist.new_group(backend="gloo"))
    shape = tuple(mesh.shape)
    if shape not in _GROUPS:
        _GROUPS[shape] = DeviceMesh(
            "cpu", torch.arange(shape[0] * shape[1]).reshape(shape),
            mesh_dim_names=("data", "model"), _init_backend=False)
    return _GROUPS["gloo"], _GROUPS[shape]


def state_tensors(state) -> dict[str, torch.Tensor]:
    """The training state by its checkpoint names: the parameters, the Adam
    moments, ``adam_count`` and ``step`` (0-d int64)."""
    tensors = dict(state.model.state_dict())
    for n in state.mu:
        tensors[_MU + n] = state.mu[n]
        tensors[_NU + n] = state.nu[n]
    tensors[_COUNT] = torch.tensor(state.count, dtype=torch.int64)
    tensors[_STEP] = torch.tensor(state.step, dtype=torch.int64)
    return tensors


def _stage(state, device_mesh=None) -> dict:
    """Host copies of the state (finished when this returns); the table and
    its moments as DTensors on ``device_mesh`` in a mesh run."""
    staged = {}
    for name, t in state_tensors(state).items():
        host = t.detach().to("cpu", copy=True)
        if device_mesh is not None and is_sharded(name, t):
            from torch.distributed.tensor import DTensor, Replicate, Shard

            m = device_mesh.size(1)
            host = DTensor.from_local(
                host, device_mesh, [Replicate(), Shard(0)], run_check=False,
                shape=torch.Size((host.shape[0] * m, host.shape[1])),
                stride=(host.shape[1], 1))
        staged[name] = host
    return staged


def _write_json(path: Path, obj) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(obj, indent=2))
    os.replace(tmp, path)


def save_checkpoint_orbax(checkpoint_dir, state, *, model_type: str,
                          run_info: str, epoch: int, meta: dict,
                          suffix: str = "") -> Path:
    """Stage ``state`` and write it asynchronously to
    ``<model_type>_<run_info>_e<epoch><suffix>.orbax``; returns that path.
    Rank 0 (or the one process) writes the sidecar (``meta`` with the
    backend's keys) and, for the best epoch's save without ``suffix``, the
    best pointer. On a mesh every rank must call it."""
    checkpoint_dir = Path(checkpoint_dir)
    name = f"{model_type}_{run_info}_e{epoch}{suffix}"
    path = (checkpoint_dir / f"{name}.orbax").resolve()
    tmp = path.with_name(f".{path.name}.tmp")
    mesh = getattr(state.model, "shard_mesh", None)
    first = mesh is None or mesh.rank == 0
    group, device_mesh = (None, None) if mesh is None else _mesh_groups(mesh)
    if first:
        checkpoint_dir.mkdir(parents=True, exist_ok=True)
    with trace.span("save.to_host"):
        staged = _stage(state, device_mesh)
    if trace.ON:
        trace.count("ckpt_bytes", sum(
            (t.to_local() if hasattr(t, "to_local") else t).nbytes
            for t in staged.values()))

    dcp = _dcp()
    parent = trace.current()  # the save that the write on the thread is of

    def write():
        with trace.span("save.write", parent=parent):
            if first:  # a stale save's files; the other ranks write later
                shutil.rmtree(tmp, ignore_errors=True)
            dcp.save(staged, storage_writer=dcp.FileSystemWriter(tmp),
                     process_group=group, no_dist=mesh is None)
            if first:  # every rank's files and .metadata are in: commit
                shutil.rmtree(path, ignore_errors=True)
                os.replace(tmp, path)

    _saver().submit(write)
    if not first:
        return path
    meta_out = dict(meta, schema_version=_SCHEMA_VERSION, backend="orbax",
                    epoch=epoch, format=DCP_FORMAT,
                    table_rows=int(state.model.num_seqs_padded))
    _write_json(checkpoint_dir / f"{name}.json", meta_out)
    if meta.get("best_epoch") == epoch and not suffix:
        _write_json(checkpoint_dir / "best_model_pointer.json",
                    {"path": str(path), "epoch": epoch})
    return path


# ------------------------------------------------------------------ load


def _metadata(path: Path):
    """DCP's ``.metadata`` of a committed checkpoint; a directory without
    one (an orbax directory of the JAX package) raises."""
    if not (path / ".metadata").is_file():
        raise NotImplementedError(
            f"{path} holds no torch.distributed.checkpoint .metadata, so it "
            f"is not a checkpoint of the port's --ckpt-backend orbax: orbax "
            f"directories written by the JAX package need the orbax "
            f"package, which the port does not use (ROADMAP.md); resume "
            f"such a run with the JAX CLI, or save it with --ckpt-backend "
            f"npz")
    return _dcp().FileSystemReader(str(path)).read_metadata()


def _table_key(names) -> str:
    return next(n for n in names if not n.startswith(("adam_", "step"))
                and n.endswith("mu2_table"))


def saved_mu2_rows(checkpoint_path) -> int | None:
    """The mu2 table's saved row count, from DCP's ``.metadata`` (JAX's
    ``_saved_mu2_rows``); ``None`` where it cannot be read."""
    path = Path(checkpoint_path)
    if not (path / ".metadata").is_file():
        return None
    md = _metadata(path).state_dict_metadata
    size = tuple(md[_table_key(md)].size)
    return int(size[0]) if len(size) == 2 else None


def _ckpt_order(p: Path):
    """Training progress of a checkpoint name: ``(epoch, batches)``, an
    epoch's own checkpoint after its step checkpoints."""
    m = re.search(r"_e(\d+)(?:s(\d+))?\.orbax$", p.name)
    if not m:
        return (-1, -1)
    return (int(m.group(1)), int(m.group(2)) if m.group(2) else 1 << 62)


def committed_path(checkpoint_path) -> Path:
    """``checkpoint_path`` if it committed; else, with a warning, the newest
    committed checkpoint of the same run in its directory (a sidecar
    without its directory: a save interrupted before its commit)."""
    path = Path(checkpoint_path).resolve()
    if path.exists():
        return path
    run_prefix = path.name.rsplit("_e", 1)[0]
    committed = sorted(
        (p for p in path.parent.glob(f"{run_prefix}_e*.orbax")
         if p.exists() and p != path and _ckpt_order(p) >= (0, 0)),
        key=_ckpt_order)
    if not committed:
        raise FileNotFoundError(
            f"Checkpoint {path} has no committed orbax directory — the save "
            f"was likely interrupted (crash/preemption before the async "
            f"commit finished) — and no earlier committed checkpoint of the "
            f"same run exists to fall back to.")
    warnings.warn(
        f"Checkpoint {path} never committed (interrupted async save); "
        f"falling back to the latest committed checkpoint {committed[-1]}")
    return committed[-1]


def _read(path: Path, targets: dict[str, torch.Tensor], model) -> dict:
    """The tensors ``targets`` names, read whole at their saved shapes; the
    mu2 table and its moments fitted to ``model`` (its padding and, on a
    mesh, the rank's rows), any other shape mismatch raised."""
    md = _metadata(path).state_dict_metadata
    missing = sorted(set(targets) - set(md))
    if missing:
        raise ValueError(f"{path} lacks {missing}")
    out = {k: torch.empty(tuple(md[k].size), dtype=md[k].properties.dtype)
           for k in targets}
    dcp = _dcp()
    dcp.load(out, storage_reader=dcp.FileSystemReader(str(path)),
             no_dist=True)
    for k, want in targets.items():
        got = out[k]
        if (k.endswith("mu2_table") and got.dim() == 2 and want.dim() == 2
                and got.shape[1] == want.shape[1]):
            got = torch.from_numpy(_fit_table(got.numpy(), model))
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"{k}: checkpoint {tuple(got.shape)} vs model "
                             f"{tuple(want.shape)}")
        out[k] = got
    return out


def load_params_orbax(checkpoint_path, model: torch.nn.Module) -> dict:
    """Load a checkpoint's parameters into ``model`` (in place, on its
    device); returns the sidecar meta."""
    wait_for_saves()
    path = committed_path(checkpoint_path)
    target = model.state_dict()
    loaded = _read(path, target, model)
    model.load_state_dict(loaded)
    return read_checkpoint_meta(path)


def load_checkpoint_orbax(checkpoint_path, state, finetune: bool = False,
                          expected_num_seqs: int | None = None,
                          expected_fingerprint: str | None = None) -> dict:
    """Restore a training state in place, with ``load_train_state``'s
    semantics: the parameters always; unless ``finetune`` the Adam state
    and step too, ``meta["start_epoch"]`` the saved epoch + 1, after the
    corpus check; with ``finetune`` a fresh optimizer, no history, epoch 0.
    Flushes this process's saves first. Returns the sidecar meta."""
    wait_for_saves()
    path = committed_path(checkpoint_path)
    meta = read_checkpoint_meta(path)
    if finetune:
        load_params_orbax(path, state.model)
        return dict(meta, start_epoch=0, values={}, best_val_lb=-np.inf,
                    best_epoch=0)
    check_same_corpus(meta, expected_num_seqs, path, expected_fingerprint)
    targets = state_tensors(state)
    loaded = _read(path, targets, state.model)
    state.model.load_state_dict({k: loaded[k]
                                 for k in state.model.state_dict()})
    with torch.no_grad():
        for n in state.mu:
            state.mu[n].copy_(loaded[_MU + n])
            state.nu[n].copy_(loaded[_NU + n])
    state.count, state.step = int(loaded[_COUNT]), int(loaded[_STEP])
    return dict(meta, start_epoch=meta["epoch"] + 1)
