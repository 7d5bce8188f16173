"""Two-layer LSTM recurrence for the FHVAE stacks: CUDA kernel wrappers.

Counterpart of ``pytorch_scalablefhvae_tpu/ops/lstm_pallas.py`` (forward
only; the backward kernels come with the training path). Both entries run
the kernel in ``csrc/lstm2_fwd.cu`` for CUDA tensors and their plain PyTorch
versions (``*_reference``) for CPU tensors; nothing falls back from one to
the other.

A stack is given as ``cells = [(w1, b1), (w2, b2)]`` in the JAX layout:
``w1 [d_in + H, 4H]`` with the input rows on top and the recurrent rows
last, ``w2 [2H, 4H]``, gate order i, f, g, o. Time-major everywhere:
``x [T, B, D]``, ``tops [T, B, H]``.

``mm_dtype="bfloat16"`` rounds the matmul operands (weights, h, x) to bf16
while products, sums, gates and carries stay fp32 (``_make_ref_dot`` in the
Pallas module); ``"float32"`` keeps every operand fp32.

Each entry counts its kernel launches in ``<entry>.launches``.
"""

from __future__ import annotations

import torch

from pytorch_scalablefhvae_tpu_torch.ops import _build

MM_DTYPES = ("float32", "bfloat16")


def _mm(a: torch.Tensor, w: torch.Tensor, mm_dtype: str) -> torch.Tensor:
    if mm_dtype == "bfloat16":
        # bf16 x bf16 products are exact in fp32: round the operands, then
        # multiply and accumulate in fp32
        a = a.to(torch.bfloat16).float()
        w = w.to(torch.bfloat16).float()
    return a @ w


def _cell(gates: torch.Tensor, c: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _recurrence(g1_at, T: int, B: int, cells, mm_dtype: str):
    (w1, _), (w2, b2) = cells
    H = w2.shape[1] // 4
    w1h, w2x, w2h = w1[-H:], w2[:H], w2[H:]
    h1 = c1 = h2 = c2 = w2.new_zeros(B, H)
    tops = []
    for t in range(T):
        h1, c1 = _cell(g1_at(t) + _mm(h1, w1h, mm_dtype), c1)
        h2, c2 = _cell(_mm(h1, w2x, mm_dtype) + _mm(h2, w2h, mm_dtype) + b2,
                       c2)
        tops.append(h2)
    return torch.stack(tops), h2


def lstm2_tm_proj_reference(cells, x, xgc=None, mm_dtype="float32"):
    """Plain version of :func:`lstm2_tm_proj`."""
    (w1, b1), _ = cells
    T, B, D = x.shape
    xgc = b1.reshape(1, -1) if xgc is None else xgc
    xp = _mm(x.reshape(T * B, D), w1[:D], mm_dtype).reshape(T, B, -1) + xgc
    return _recurrence(lambda t: xp[t], T, B, cells, mm_dtype)


def lstm2_tm_reference(cells, xg1, T=None, mm_dtype="float32"):
    """Plain version of :func:`lstm2_tm`."""
    if xg1.dim() == 2:
        return _recurrence(lambda t: xg1, T, xg1.shape[0], cells, mm_dtype)
    return _recurrence(lambda t: xg1[t], xg1.shape[0], xg1.shape[1], cells,
                       mm_dtype)


def _stack_shapes(cells, d_x: int) -> int:
    """Validate a two-layer equal-width stack; returns H."""
    (w1, b1), (w2, b2) = cells
    H = w2.shape[1] // 4
    if (w1.dim() != 2 or w1.shape[1] != 4 * H or w1.shape[0] < d_x + H
            or tuple(w2.shape) != (2 * H, 4 * H)
            or tuple(b1.shape) != (4 * H,) or tuple(b2.shape) != (4 * H,)):
        raise ValueError(
            f"not a two-layer equal-width LSTM stack over {d_x} inputs: "
            f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    return H


def _check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the LSTM kernel runs on CUDA tensors, not {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the LSTM kernel is forward-only: its backward comes with the "
            "training slice (ROADMAP.md); run under torch.inference_mode()")
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"the LSTM kernel takes contiguous float32 tensors on one "
                f"device; got {t.dtype} {tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _launch(entry, cells, x, xadd, t_stride, row_stride, T, B, D, mm_dtype,
            with_tops):
    """Run ``csrc/lstm2_fwd.cu`` on CUDA tensors; returns (tops|None, h2)."""
    if mm_dtype not in MM_DTYPES:
        raise ValueError(f"mm_dtype must be one of {MM_DTYPES}")
    (w1, _), (w2, b2) = cells
    H = w2.shape[1] // 4
    _check_cuda(*(t for t in (x, xadd, w1, w2, b2) if t is not None))
    lib = _build.library()
    if lib.sfhvae_lstm2_threads(H) > 1024:
        raise ValueError(f"hidden width {H} exceeds the kernel's block size")
    wdt = torch.bfloat16 if mm_dtype == "bfloat16" else torch.float32
    w1 = w1.to(wdt).contiguous()
    w2 = w2.to(wdt).contiguous()
    w1h, w2x, w2h = w1[-H:], w2[:H], w2[H:]
    dev = xadd.device
    tops = (torch.empty((T, B, H), device=dev, dtype=torch.float32)
            if with_tops else None)
    h2 = torch.empty((B, H), device=dev, dtype=torch.float32)
    if B > 0 and T > 0:
        code = lib.sfhvae_lstm2_fwd(
            None if x is None else x.data_ptr(), xadd.data_ptr(), t_stride,
            row_stride, w1.data_ptr(), w1h.data_ptr(), w2x.data_ptr(),
            w2h.data_ptr(), b2.data_ptr(),
            None if tops is None else tops.data_ptr(), h2.data_ptr(),
            T, B, D, H, int(mm_dtype == "bfloat16"),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(code, entry.__name__)
        entry.launches += 1
    return tops, h2


def lstm2_tm_proj(cells, x, xgc=None, mm_dtype="float32", with_tops=True):
    """Projection-fused time-major entry (``lstm2_pallas_tm_proj``).

    ``x [T, B, D]`` raw inputs, projected by ``w1[:D]`` inside the kernel.
    ``xgc``: ``[B, 4H]`` or ``[1, 4H]`` additive gate block — the projection
    of the input's non-x part plus the layer-1 bias; ``None`` means the bias
    row ``b1`` alone. Returns ``(tops [T, B, H] | None, h2 [B, H])``; with
    ``with_tops=False`` the kernel skips the tops write (the encoders need
    only h2).
    """
    T, B, D = x.shape
    H = _stack_shapes(cells, D)
    if xgc is None:
        xgc = cells[0][1].reshape(1, 4 * H)
    if xgc.dim() != 2 or xgc.shape[1] != 4 * H or xgc.shape[0] not in (1, B):
        raise ValueError(f"xgc must be [{B}, {4 * H}] or [1, {4 * H}]; got "
                         f"{tuple(xgc.shape)}")
    if x.device.type == "cpu":
        tops, h2 = lstm2_tm_proj_reference(cells, x, xgc, mm_dtype)
        return (tops if with_tops else None), h2
    row_stride = 0 if xgc.shape[0] == 1 else 4 * H
    return _launch(lstm2_tm_proj, cells, x, xgc, 0, row_stride, T, B, D,
                   mm_dtype, with_tops)


def lstm2_tm(cells, xg1, T=None, mm_dtype="float32", with_tops=True):
    """Precomputed-gate time-major entry (``lstm2_pallas_tm``).

    ``xg1``: ``[T, B, 4H]`` layer-1 gate pre-activations (projection and
    bias applied), or ``[B, 4H]`` with ``T`` given when the input is the same
    at every step — the decoder's const mode, where the kernel reads the one
    block at every step and no ``[T, B, 4H]`` broadcast exists.
    Returns ``(tops [T, B, H] | None, h2 [B, H])``.
    """
    const = xg1.dim() == 2
    if const:
        if T is None:
            raise ValueError("const mode ([B, 4H] gates) needs T")
        B = xg1.shape[0]
    else:
        T, B = xg1.shape[0], xg1.shape[1]
    H = _stack_shapes(cells, 0)
    if xg1.shape[-1] != 4 * H:
        raise ValueError(f"xg1 last dim must be {4 * H}; got "
                         f"{tuple(xg1.shape)}")
    if xg1.device.type == "cpu":
        tops, h2 = lstm2_tm_reference(cells, xg1, T, mm_dtype)
        return (tops if with_tops else None), h2
    t_stride = 0 if const else B * 4 * H
    return _launch(lstm2_tm, cells, None, xg1, t_stride, 4 * H, T, B, 0,
                   mm_dtype, with_tops)


lstm2_tm_proj.launches = 0
lstm2_tm.launches = 0
