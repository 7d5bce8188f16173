"""K whole train steps per dispatch, replayed as one CUDA graph.

Counterpart of the JAX package's ``make_multi_train_step``
(``train/step.py``), whose ``lax.scan`` runs K optimizer steps over stacked
``[K, B, ...]`` batches in one dispatched program; ``train/device_step.py``
builds the same bundle over the staged store (``make_device_train_step(k)``).
A step issued from Python costs several times its device work in host
launches; replaying a graph of K steps issues them all at once.

:class:`StepBundle` runs the K steps through ``train/step.py``'s
:func:`step_body`, the eager step's own body, so both give the same bits.
Everything the captured body reads lives at a fixed address and is written
before each replay:

- the batch inputs, through an inputs object whose ``views(i)`` gives step
  ``i``'s ``(feats, seq_idx, nsegs, weight)`` (:class:`HostInputs` here:
  static ``[K, B, ...]`` buffers filled from the host loader; the device
  tier's plan offsets in ``train/device_step.py``);
- the K steps' Adam bias corrections, ``[K, 2]`` fp32, computed on the host
  from ``state.count`` as the eager step computes them
  (``Optimizer.bias_corrections``);
- K persistent generators, one per step, registered with the graph and
  seeded before each replay from ``(seed, step + i)``: each step draws what
  ``step_noise`` draws for it, so a resumed run repeats an uninterrupted one
  and no generator state is saved.

Host state stays out of the graph: ``state.count`` and ``state.step`` are
counted here per dispatch, and the kernel wrappers' launch counters, which
count once while the capture runs the Python, are put back after the capture
and advanced by the capture's counts at every replay.

On a GPU the first dispatch runs the body eagerly: those are real steps, and
they build the kernels and initialise cuBLAS, autograd and every kernel's
shared-memory opt-in before anything is captured. The second dispatch
captures the graph and replays it, and every later one replays it. A failed
capture or replay raises; nothing falls back to eager steps. On the CPU
every dispatch runs the body eagerly through the same buffers, with noise
drawn from the same generators or handed in (the tests hand in the JAX
draws).
"""

from __future__ import annotations

import torch

from pytorch_scalablefhvae_tpu_torch.train.step import (
    Optimizer,
    TrainState,
    draw_noise,
    noise_seed,
    step_body,
)


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
    ``stack_prefetch``)."""

    def __init__(self, k: int, batch_size: int, seg_len: int, dim: int,
                 device: torch.device,
                 feats_dtype: torch.dtype = torch.float32):
        kb = (k, batch_size)
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
                buf[i].copy_(torch.as_tensor(getattr(b, field)))
            staging.send()

    def views(self, i: int):
        return tuple(a[i] for a in self.arrays)


class StepBundle:
    """K optimizer steps on ``state`` per call, from ``inputs.views(i)``
    (see the module docstring). A call returns the K steps' metrics, each
    stacked ``[K]``; after a replay they are the graph's static outputs,
    which the next replay overwrites."""

    def __init__(self, state: TrainState, optimizer: Optimizer, alpha: float,
                 k: int, inputs, device: torch.device):
        self.state, self.optimizer, self.alpha, self.k = (state, optimizer,
                                                          alpha, k)
        self.inputs = inputs
        self.device = torch.device(device)
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
        ``noise[i]``)."""
        steps = []
        for i in range(self.k):
            feats, seq_idx, nsegs, weight = self.inputs.views(i)
            eps = (noise[i] if noise is not None else draw_noise(
                self.state.model, self.generators[i], feats.shape[0],
                self.device))
            steps.append(step_body(self.state, self.optimizer, feats, seq_idx,
                                   nsegs, weight, self.alpha, eps,
                                   bc=self.bc[i]))
        return {key: torch.stack([m[key] for m in steps]) for key in steps[0]}

    def capture(self, keep_graph: bool = False) -> None:
        """Capture :meth:`body` as this bundle's CUDA graph. Nothing runs:
        the state, its counts and the launch counters stay as they were, and
        each counter's count during the capture is kept to be added at every
        replay. ``keep_graph`` keeps the captured graph beside its
        executable (``graph.raw_cuda_graph()``, to inspect its nodes)."""
        if self.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device")
        before = launch_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        for g in self.generators:
            graph.register_generator_state(g)
        try:
            with torch.cuda.graph(graph):
                outputs = self.body()
        finally:
            after = launch_counts()
            for (entry, counter), n in before.items():
                setattr(entry, counter, n)
        self.launch_deltas = {key: after[key] - n for key, n in before.items()
                              if after[key] != n}
        self.graph, self.outputs = graph, outputs

    def __call__(self, noise=None) -> dict:
        """One dispatch: the K steps from ``state.step`` on the inputs
        loaded for it (``noise``, a list of K noise dicts, on the CPU
        only)."""
        st = self.state
        for i, g in enumerate(self.generators):
            g.manual_seed(noise_seed(st.seed, st.step + i))
        self._bc_staging.host().copy_(torch.from_numpy(
            self.optimizer.bias_corrections(st.count, self.k, self.device)))
        self._bc_staging.send()
        if self.device.type == "cpu":
            out = self.body(noise)
        elif noise is not None:
            raise ValueError("noise is handed in on the CPU only; on a GPU "
                             "the graph draws it")
        elif self.dispatches == 0:
            out = self.body()
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
