"""K whole train steps per dispatch, replayed as one CUDA graph.

Counterpart of the JAX package's ``make_multi_train_step``
(``train/step.py``), whose ``lax.scan`` runs K optimizer steps over stacked
``[K, B, ...]`` batches in one dispatched program; ``train/device_step.py``
builds the same bundle over the staged store (``make_device_train_step(k)``)
and ``parallel/sharded_step.py``'s ``make_sharded_multi_train_step`` the
same on a mesh. A step issued from Python costs several times its device
work in host launches; replaying a graph of K steps issues them all at once.

:class:`StepBundle` runs the K steps through ``train/step.py``'s
:func:`step_body`, the eager step's own body, so both give the same bits.
Everything the captured body reads lives at a fixed address and is written
before each replay:

- the batch inputs, through an inputs object whose ``views(i)`` gives step
  ``i``'s ``(feats, seq_idx, nsegs, weight)`` (:class:`HostInputs` here:
  static ``[K, B, ...]`` buffers filled from the host loader; the device
  tier's plan offsets in ``train/device_step.py``); on a mesh, this rank's
  rows of each batch;
- the K steps' Adam bias corrections, ``[K, 2]`` fp32, computed on the host
  from ``state.count`` as the eager step computes them
  (``Optimizer.bias_corrections``);
- K persistent generators, one per step, registered with the graph and
  seeded before each replay from ``(seed, step + i)``: each step draws what
  ``step_noise`` draws for it (on a mesh the whole batch's noise, of which
  the rank keeps its rows), so a resumed run repeats an uninterrupted one
  and no generator state is saved.

Host state stays out of the graph: ``state.count`` and ``state.step`` are
counted here per dispatch, and the kernel wrappers' launch counters, which
count once while the capture runs the Python, are put back after the capture
and advanced by the capture's counts at every replay (each rank of a mesh
keeps its own).

Whether a bundle replays a graph is decided by configuration before its
first dispatch (:func:`replays_graph`): on a GPU without a mesh, or on a
mesh whose backend is NCCL, whose all-reduces are kernels on the card and
are captured with the steps (the data group's gradient sum, the model
group's reductions of the sharded ``log_qy`` and of the clip, the row-sharded
store's gather). gloo's all-reduce of a CUDA tensor passes through the host
and cannot be captured: with gloo, as on the CPU, every dispatch runs the
body eagerly through the same buffers, with noise drawn from the same
generators or handed in (the tests hand in the JAX draws). Where it
replays, the first dispatch runs the body eagerly: those are real steps,
and they build the kernels and initialise cuBLAS, autograd, every kernel's
shared-memory opt-in and every NCCL communicator of the step before
anything is captured. The second dispatch captures the graph and replays
it, and every later one replays it. A failed capture or replay raises;
nothing falls back to eager steps.

Each dispatch, the bundle's or an eager step's, runs in a
``dispatch.launch`` span (:func:`launch_span`) and each capture in a
``capture`` span, counted as ``dispatches``, ``graph_replays``,
``eager_steps`` and ``captures`` (``train/trace.py``).
"""

from __future__ import annotations

import torch

from pytorch_scalablefhvae_tpu_torch.train import trace
from pytorch_scalablefhvae_tpu_torch.train.step import (
    Optimizer,
    TrainState,
    draw_noise,
    noise_seed,
    step_body,
)


def replays_graph(device_type: str, backend: str | None) -> bool:
    """Whether a K-step bundle on a ``device_type`` device, on a mesh of
    ``backend`` (``None``: no mesh), replays a CUDA graph: on a GPU without
    a mesh or under NCCL; with gloo or on the CPU it runs its steps
    eagerly."""
    return device_type == "cuda" and backend in (None, "nccl")


def dispatch_line(k: int, device_type: str, backend: str | None) -> str:
    """What the training loop says of its K-step dispatches."""
    line = f"{k} steps per dispatch"
    if replays_graph(device_type, backend):
        return line + ", replayed as one CUDA graph" + (
            "" if backend is None else " (NCCL all-reduces inside)")
    if device_type == "cuda":
        return line + ", run eagerly: gloo all-reduces pass through the host"
    return line


def kernel_entries() -> list:
    """Every kernel wrapper of the port that counts its launches."""
    from pytorch_scalablefhvae_tpu_torch.ops import (
        discriminative,
        fbank_cuda,
        lstm_cuda,
        window_gather,
    )

    return [f for m in (lstm_cuda, discriminative, window_gather, fbank_cuda)
            for f in vars(m).values() if hasattr(f, "launches")]


_COUNTERS = ("launches", "launches_tc", "launches_bf16")
_REPLAY, _EAGER = {"replay": True}, {"replay": False}


def launch_span(replay: bool, steps: int = 1):
    """The ``dispatch.launch`` span of one dispatch: a graph replay, or
    ``steps`` steps run eagerly; counted in ``dispatches`` and in
    ``graph_replays`` or ``eager_steps``."""
    if trace.ON:
        trace.count("dispatches")
        trace.count("graph_replays" if replay else "eager_steps",
                    1 if replay else steps)
    return trace.span("dispatch.launch", _REPLAY if replay else _EAGER)


def launch_counts() -> dict:
    """``{(entry, counter): value}`` of every kernel wrapper's counters."""
    return {(e, c): getattr(e, c) for e in kernel_entries() for c in _COUNTERS
            if hasattr(e, c)}


class Staging:
    """Host-to-device copies into ``dst`` (a tensor at a fixed address). On
    a GPU through two pinned host buffers in turn, each refilled only after
    its last copy has run, so the host fills one while the other's copy
    waits on the stream; on the CPU a plain copy."""

    def __init__(self, dst: torch.Tensor):
        self.dst = dst
        cuda = dst.device.type == "cuda"
        self._bufs = [torch.empty(dst.shape, dtype=dst.dtype, pin_memory=cuda)
                      for _ in range(2 if cuda else 1)]
        self._events = [torch.cuda.Event() if cuda else None
                        for _ in self._bufs]
        self._turn = 0

    def host(self) -> torch.Tensor:
        """The next host buffer, free to fill."""
        i = self._turn % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()
        return self._bufs[i]

    def send(self) -> None:
        """Copy the buffer :meth:`host` gave into ``dst`` on the current
        stream, without waiting for it."""
        i = self._turn % len(self._bufs)
        self.dst.copy_(self._bufs[i], non_blocking=True)
        if self._events[i] is not None:
            self._events[i].record()
        self._turn += 1


class HostInputs:
    """The bundle's inputs from the host loader: static ``[K, B, seg_len,
    dim]`` feats (in the loader's transfer dtype, ``feats_dtype``) and ``[K,
    B]`` ``seq_idx`` (int32), ``nsegs`` and ``weight`` on ``device``, each
    filled by one copy per dispatch (the counterpart of
    ``stack_prefetch``). With a ``mesh``, ``B`` is this rank's rows of each
    ``batch_size``-row batch (``Mesh.local_rows``)."""

    def __init__(self, k: int, batch_size: int, seg_len: int, dim: int,
                 device: torch.device,
                 feats_dtype: torch.dtype = torch.float32, mesh=None):
        self.rows = (slice(0, batch_size) if mesh is None
                     else mesh.local_rows(batch_size))
        kb = (k, self.rows.stop - self.rows.start)
        self.k = k
        self.arrays = (
            torch.zeros(kb + (seg_len, dim), dtype=feats_dtype,
                        device=device),
            torch.zeros(kb, dtype=torch.int32, device=device),
            torch.ones(kb, dtype=torch.float32, device=device),
            torch.zeros(kb, dtype=torch.float32, device=device))
        self._staging = [Staging(a) for a in self.arrays]

    def load(self, batches) -> None:
        """Stack ``k`` loader batches into the static inputs."""
        for staging, field in zip(self._staging,
                                  ("feats", "seq_idx", "nsegs", "weight")):
            buf = staging.host()
            for i, b in enumerate(batches):
                buf[i].copy_(torch.as_tensor(getattr(b, field)[self.rows]))
            staging.send()

    def views(self, i: int):
        return tuple(a[i] for a in self.arrays)


class StepBundle:
    """K optimizer steps on ``state`` per call, from ``inputs.views(i)``
    (see the module docstring); with a ``mesh``, this rank's part of K mesh
    steps, its state the rank's (``parallel.mesh.shard_model``). A call
    returns the K steps' metrics, each stacked ``[K]``; after a replay they
    are the graph's static outputs, which the next replay overwrites."""

    def __init__(self, state: TrainState, optimizer: Optimizer, alpha: float,
                 k: int, inputs, device: torch.device, mesh=None):
        self.state, self.optimizer, self.alpha, self.k = (state, optimizer,
                                                          alpha, k)
        self.inputs = inputs
        self.device = torch.device(device)
        self.mesh = mesh
        self.replays = replays_graph(self.device.type,
                                     None if mesh is None else mesh.backend)
        self.bc = torch.zeros((k, 2), dtype=torch.float32, device=self.device)
        self._bc_staging = Staging(self.bc)
        self.generators = [torch.Generator(device=self.device)
                           for _ in range(k)]
        self.graph = None
        self.outputs = None
        self.launch_deltas: dict = {}
        self.dispatches = 0

    def body(self, noise=None) -> dict:
        """The K steps' device work, step ``i`` on ``inputs.views(i)`` with
        bias corrections ``bc[i]`` and noise from ``generators[i]`` (or
        ``noise[i]``, this rank's rows on a mesh)."""
        steps = []
        for i in range(self.k):
            feats, seq_idx, nsegs, weight = self.inputs.views(i)
            eps = noise[i] if noise is not None else self.draw(
                i, feats.shape[0])
            steps.append(step_body(self.state, self.optimizer, feats, seq_idx,
                                   nsegs, weight, self.alpha, eps, self.mesh,
                                   bc=self.bc[i]))
        return {key: torch.stack([m[key] for m in steps]) for key in steps[0]}

    def draw(self, i: int, rows: int) -> dict:
        """Step ``i``'s noise for ``rows`` rows from ``generators[i]``; on a
        mesh the whole batch's draw, of which the rank keeps its rows, as
        ``step.seeded_noise`` draws it."""
        keep = slice(None)
        if self.mesh is not None:
            rows *= self.mesh.shape[0]
            keep = self.mesh.local_rows(rows)
        eps = draw_noise(self.state.model, self.generators[i], rows,
                         self.device)
        return {k: v[keep] for k, v in eps.items()}

    def capture(self, keep_graph: bool = False) -> None:
        """Capture :meth:`body` as this bundle's CUDA graph. Nothing runs:
        the state, its counts and the launch counters stay as they were, and
        each counter's count during the capture is kept to be added at every
        replay. ``keep_graph`` keeps the captured graph beside its
        executable (``graph.raw_cuda_graph()``, to inspect its nodes)."""
        if not self.replays:
            raise ValueError("a CUDA graph needs a CUDA device and, on a "
                             "mesh, the NCCL backend")
        trace.count("captures")
        with trace.span("capture"):
            before = launch_counts()
            graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
            for g in self.generators:
                graph.register_generator_state(g)
            # on a mesh the NCCL watchdog thread queries the events of
            # earlier collectives while this thread captures: only this
            # thread's calls must be capture-safe
            mode = "global" if self.mesh is None else "thread_local"
            try:
                with torch.cuda.graph(graph, capture_error_mode=mode):
                    outputs = self.body()
            finally:
                after = launch_counts()
                for (entry, counter), n in before.items():
                    setattr(entry, counter, n)
            self.launch_deltas = {key: after[key] - n
                                  for key, n in before.items()
                                  if after[key] != n}
            self.graph, self.outputs = graph, outputs

    def __call__(self, noise=None) -> dict:
        """One dispatch: the K steps from ``state.step`` on the inputs
        loaded for it (``noise``, a list of K noise dicts, only where the
        bundle runs eagerly)."""
        st = self.state
        for i, g in enumerate(self.generators):
            g.manual_seed(noise_seed(st.seed, st.step + i))
        self._bc_staging.host().copy_(torch.from_numpy(
            self.optimizer.bias_corrections(st.count, self.k, self.device)))
        self._bc_staging.send()
        if self.replays and noise is not None:
            raise ValueError("noise is handed in only where the bundle runs "
                             "eagerly; a replayed graph draws it")
        replay = self.replays and self.dispatches > 0
        with launch_span(replay, self.k):
            if not replay:
                out = self.body(noise)
            else:
                if self.graph is None:
                    self.capture()
                self.graph.replay()
                for (entry, counter), n in self.launch_deltas.items():
                    setattr(entry, counter, getattr(entry, counter) + n)
                out = self.outputs
        self.dispatches += 1
        st.count += self.k
        st.step += self.k
        return out
