"""Start and join the ranks of a mesh on one machine, and join a process
group that a launcher set up.

The JAX CLI needs no launcher for ``--mesh``: one program drives all devices.
Here every rank is a process. :func:`run_ranks` starts them
(``torch.multiprocessing``, start method ``spawn``), each of which joins the
default process group through a ``file://`` rendezvous and then runs the
target; :func:`init_from_env` joins a group described by a launcher's
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` (the ``--distributed`` flag).

The backend named is the backend used. With ``nccl`` every rank owns one
card: rank ``r`` of a node takes card ``LOCAL_RANK`` and the run raises when
the node has fewer cards than ranks. With ``gloo`` the ranks take cards as
``rank % device_count`` and may share one, or run on the CPU. Every group
has a timeout and every join a limit, so a rank that dies ends the run with
an error instead of leaving the others waiting in a collective.
"""

from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600.0
_GRACE_S = 15.0  # what the other ranks get once one has failed


def rank_device(device: str, backend: str, local_rank: int,
                local_world: int) -> str:
    """The torch device of a rank: ``cpu``, or its card under ``backend``."""
    if backend not in BACKENDS:
        raise ValueError(f"--dist-backend must be one of {BACKENDS}")
    if device == "cpu":
        if backend != "gloo":
            raise ValueError("--device cpu needs --dist-backend gloo: nccl "
                             "reduces CUDA tensors only")
        return "cpu"
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "device 'cuda' was requested but no CUDA device is present; pass "
            "--device cpu --dist-backend gloo to run the ranks on the CPU")
    if backend == "nccl":
        if local_world > n:
            raise RuntimeError(
                f"--dist-backend nccl gives every rank a card of its own: "
                f"{local_world} ranks on this node, {n} cards (gloo lets "
                f"ranks share a card)")
        return f"cuda:{local_rank}"
    return f"cuda:{local_rank % n}"


def _init(backend: str, device: str, init_method: str, rank: int, world: int,
          timeout_s: float) -> None:
    if device != "cpu":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


def init_from_env(backend: str, device: str,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the process group a launcher described in the environment
    (unless this process has joined one already); returns this rank's
    device. ``LOCAL_WORLD_SIZE`` defaults to the world size (one node)."""
    if dist.is_initialized():
        world = dist.get_world_size()
        local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    else:
        missing = [v for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if v not in os.environ]
        if missing:
            raise RuntimeError(
                f"--distributed joins the process group a launcher set up, "
                f"but {missing} are not in the environment")
        world = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = rank_device(device, backend, local_rank, local_world)
    if not dist.is_initialized():
        _init(backend, dev, "env://", int(os.environ["RANK"]), world,
              timeout_s)
    elif dev != "cpu":
        torch.cuda.set_device(torch.device(dev))
    return dev


def _rank_main(rank: int, world: int, backend: str, device: str,
               init_method: str, timeout_s: float, target, args) -> None:
    """A spawned rank: join the group, run ``target(*args)``, leave with its
    return code (``None`` counts as 0)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    code = 1
    try:
        if device == "cpu" and "OMP_NUM_THREADS" not in os.environ:
            # ranks on the CPU share its cores instead of each taking all
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        _init(backend, rank_device(device, backend, rank, world), init_method,
              rank, world, timeout_s)
        code = int(target(*args) or 0)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    # leave without the interpreter's teardown: a rank whose peers are gone
    # must not wait for them again in a destructor
    os._exit(code)


def run_ranks(target, world: int, args: tuple = (), *, backend: str = "nccl",
              device: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S,
              join_timeout_s: float | None = None) -> list[int]:
    """Run ``target(*args)`` in ``world`` spawned ranks of one default
    process group and return their exit codes, in rank order.

    ``target`` must be importable by the spawned processes (a module-level
    function). ``timeout_s`` is the groups' collective timeout;
    ``join_timeout_s`` limits the whole run (``None``: no limit, a training
    run may take days). Once one rank has exited with an error the others
    get a short grace period and are then terminated; a rank that was
    terminated or killed reports a negative code."""
    if world < 1:
        raise ValueError(f"world size {world}")
    for r in range(world):  # fail here, not in every rank
        rank_device(device, backend, r, world)
    rendezvous = tempfile.mkdtemp(prefix="sfhvae_ranks_")
    init_method = f"file://{rendezvous}/init"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, backend, device, init_method, timeout_s, target, args))
        for r in range(world)]
    try:
        for p in procs:
            p.start()
        t0 = time.monotonic()
        failed_at = None
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if failed_at is None and any(
                    p.exitcode not in (None, 0) for p in procs):
                failed_at = now
            if ((failed_at is not None and now - failed_at > _GRACE_S)
                    or (join_timeout_s is not None
                        and now - t0 > join_timeout_s)):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(rendezvous, ignore_errors=True)
    return [p.exitcode for p in procs]
