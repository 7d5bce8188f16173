"""Two-layer LSTM recurrence for the FHVAE stacks: CUDA kernel wrappers.

Counterpart of ``pytorch_scalablefhvae_tpu/ops/lstm_pallas.py``. Four
entries, each with its plain PyTorch version (``<entry>_reference``):

- :func:`lstm2_tm_proj`, :func:`lstm2_tm`: the forward entries,
  differentiable. They have two forms, picked by :func:`forward_form` from
  the operand type and the widths alone: the tensor-core form
  (``csrc/lstm2_fwd.cu``: bf16 operands at H = 128; the input projection of
  all steps at once, then the recurrence in two-block clusters that keep the
  recurrent weights in shared memory) and the FMA form
  (``csrc/lstm2_fwd_fma.cu``: fp32 operands and every other width);
- :func:`lstm2_tm_proj_bwd`, :func:`lstm2_tm_bwd`: their backward, which the
  forward entries' autograd Functions call. It has two forms, picked by
  :func:`backward_form` by the same rule: the tensor-core form
  (``csrc/lstm2_bwd.cu``: three passes: the gates of all steps, the
  reverse-time chain, the weight gradients) and the FMA form
  (``csrc/lstm2_bwd_fma.cu``).

Each entry runs its kernel for CUDA tensors and its plain version for CPU
tensors; nothing falls back from one to the other. The plain version of a
forward entry is differentiable too, and its backward is the plain backward.

A stack is given as ``cells = [(w1, b1), (w2, b2)]`` in the JAX layout:
``w1 [d_in + H, 4H]`` with the input rows on top and the recurrent rows
last, ``w2 [2H, 4H]``, gate order i, f, g, o. Time-major everywhere:
``x [T, B, D]``, ``tops [T, B, H]``.

``mm_dtype="bfloat16"`` rounds the matmul operands (weights, h, x) to bf16
while products, sums, gates and carries stay fp32 (``_make_ref_dot`` in the
Pallas module); ``"float32"`` keeps every operand fp32. The backward rounds
where ``_make_bwd_fns`` does: both operands of every product (the gate
adjoints ``dgates`` included), while the bias and input-gate gradients sum
the unrounded fp32 ``dgates``. Torch autograd through the plain forward
would round the product results instead and keep ``dgates`` fp32, a
different function, so the plain backward is an explicit reverse-time loop.

Under autograd a forward entry saves its residuals (``resid [T, B, 3H]`` =
h1 | c1 | c2 per step, and tops); without it the serving call writes none.

Each entry counts its kernel launches in ``<entry>.launches``, and those
that took the tensor-core form in ``<entry>.launches_tc``.
"""

from __future__ import annotations

import torch

from pytorch_scalablefhvae_tpu_torch.ops import _build

MM_DTYPES = ("float32", "bfloat16")


def _round(mm_dtype: str):
    """The value a matmul operand takes in ``mm_dtype``."""
    if mm_dtype == "bfloat16":
        # bf16 x bf16 products are exact in fp32: round the operands, then
        # multiply and accumulate in fp32
        return lambda a: a.to(torch.bfloat16).float()
    return lambda a: a


def _mm(a: torch.Tensor, w: torch.Tensor, mm_dtype: str) -> torch.Tensor:
    r = _round(mm_dtype)
    return r(a) @ r(w)


def _cell(gates: torch.Tensor, c: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _cell_bwd(gates, c_prev, c_new, dh, dc):
    """Adjoint of :func:`_cell` (``_cell_bwd`` of the Pallas module):
    ``(dgates [B, 4H], dc_prev)``."""
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.sigmoid(go)
    g = torch.tanh(gg)
    tc = torch.tanh(c_new)
    do = dh * tc * o * (1.0 - o)
    dc_tot = dc + dh * o * (1.0 - tc * tc)
    di = dc_tot * g * i * (1.0 - i)
    df = dc_tot * c_prev * f * (1.0 - f)
    dg = dc_tot * i * (1.0 - g * g)
    return torch.cat([di, df, dg, do], dim=-1), dc_tot * f


# ------------------------------------------------------- plain versions


def _recurrence(g1_at, T: int, B: int, w1h, w2x, w2h, b2, mm_dtype: str,
                with_resid: bool = False):
    """The forward recurrence; ``(tops, h2, resid | None)``."""
    H = w2x.shape[1] // 4
    h1 = c1 = h2 = c2 = w2x.new_zeros(B, H)
    tops, resid = [], []
    for t in range(T):
        h1, c1 = _cell(g1_at(t) + _mm(h1, w1h, mm_dtype), c1)
        h2, c2 = _cell(_mm(h1, w2x, mm_dtype) + _mm(h2, w2h, mm_dtype) + b2,
                       c2)
        tops.append(h2)
        if with_resid:
            resid.append(torch.cat([h1, c1, c2], dim=-1))
    return torch.stack(tops), h2, torch.stack(resid) if with_resid else None


def _proj_forward_plain(x, xgc, w1x, w1h, w2x, w2h, b2, mm_dtype,
                        with_resid=False):
    T, B, D = x.shape
    xp = _mm(x.reshape(T * B, D), w1x, mm_dtype).reshape(T, B, -1) + xgc
    return _recurrence(lambda t: xp[t], T, B, w1h, w2x, w2h, b2, mm_dtype,
                       with_resid)


def _tm_forward_plain(xg1, T, w1h, w2x, w2h, b2, mm_dtype,
                      with_resid=False):
    if xg1.dim() == 2:
        return _recurrence(lambda t: xg1, T, xg1.shape[0], w1h, w2x, w2h, b2,
                           mm_dtype, with_resid)
    return _recurrence(lambda t: xg1[t], T, xg1.shape[1], w1h, w2x, w2h, b2,
                       mm_dtype, with_resid)


def _bwd_plain(g1_at, T, B, resid, tops, w1h, w2x, w2h, b2, g_tops, g_h2,
               mm_dtype):
    """The reverse-time adjoint shared by both forms, rounding where
    ``_make_bwd_fns`` does. Returns ``(dgates1 [T, B, 4H], dw1h, dw2x, dw2h,
    db2)``; ``g1_at(t)`` recomputes the layer-1 input gates of step t."""
    r = _round(mm_dtype)
    H = w1h.shape[0]
    w1h_r, w2x_r, w2h_r = r(w1h), r(w2x), r(w2h)
    zero = resid.new_zeros(B, H)
    dh1 = dc1 = dc2 = zero
    dh2 = zero if g_h2 is None else g_h2
    dg1, dg2 = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        h1_t, c1_t, c2_t = resid[t].split(H, dim=-1)
        if t > 0:
            h1_p, c1_p, c2_p = resid[t - 1].split(H, dim=-1)
            h2_p = tops[t - 1]
        else:
            h1_p = c1_p = c2_p = h2_p = zero
        g2 = r(h1_t) @ w2x_r + r(h2_p) @ w2h_r + b2
        dh2_tot = dh2 if g_tops is None else dh2 + g_tops[t]
        d2, dc2 = _cell_bwd(g2, c2_p, c2_t, dh2_tot, dc2)
        dh2 = r(d2) @ w2h_r.T
        g1 = g1_at(t) + r(h1_p) @ w1h_r
        dh1_tot = dh1 + r(d2) @ w2x_r.T
        d1, dc1 = _cell_bwd(g1, c1_p, c1_t, dh1_tot, dc1)
        dh1 = r(d1) @ w1h_r.T
        dg1[t], dg2[t] = d1, d2
    dg1, dg2 = torch.stack(dg1), torch.stack(dg2)
    h1 = resid[..., :H]

    def tn(a, g):  # sum over the (t, b) rows of a^T g
        return r(a).reshape(-1, a.shape[-1]).T @ r(g).reshape(-1, g.shape[-1])

    return (dg1, tn(h1[:-1], dg1[1:]), tn(h1, dg2), tn(tops[:-1], dg2[1:]),
            dg2.sum((0, 1)))


def lstm2_tm_proj_bwd_reference(x, xgc, resid, tops, w1x, w1h, w2x, w2h, b2,
                                g_tops, g_h2, mm_dtype="float32",
                                need_dx=True):
    """Plain version of :func:`lstm2_tm_proj_bwd`."""
    r = _round(mm_dtype)
    T, B, _ = x.shape
    g1_at = lambda t: _mm(x[t], w1x, mm_dtype) + xgc  # noqa: E731
    dg1, dw1h, dw2x, dw2h, db2 = _bwd_plain(g1_at, T, B, resid, tops, w1h, w2x,
                                            w2h, b2, g_tops, g_h2, mm_dtype)
    flat = dg1.reshape(T * B, -1)
    dx = (r(flat) @ r(w1x).T).reshape(x.shape) if need_dx else None
    dxgc = (dg1.sum((0, 1)).reshape(1, -1) if xgc.shape[0] == 1
            else dg1.sum(0))
    dw1x = r(x.reshape(T * B, -1)).T @ r(flat)
    return dx, dxgc, dw1x, dw1h, dw2x, dw2h, db2


def lstm2_tm_bwd_reference(xg1, T, resid, tops, w1h, w2x, w2h, b2, g_tops,
                           g_h2, mm_dtype="float32"):
    """Plain version of :func:`lstm2_tm_bwd`."""
    const = xg1.dim() == 2
    B = xg1.shape[0] if const else xg1.shape[1]
    g1_at = (lambda t: xg1) if const else (lambda t: xg1[t])
    dg1, dw1h, dw2x, dw2h, db2 = _bwd_plain(g1_at, T, B, resid, tops, w1h, w2x,
                                            w2h, b2, g_tops, g_h2, mm_dtype)
    return (dg1.sum(0) if const else dg1), dw1h, dw2x, dw2h, db2


def lstm2_bwd_passes_reference(x, xadd, T, resid, tops, w1x, w1h, w2x, w2h,
                               b2, g_tops, g_h2, mm_dtype="float32",
                               need_dx=True):
    """The backward of both entries in the tensor-core kernels' pass
    structure, for tests: the gates of every step first (pass A), then the
    reverse-time loop without any recompute (pass B), then the reductions
    over the saved streams (pass C).

    ``x [T, B, D]`` or ``None`` (``xadd`` then carries the whole layer-1 input
    gates); ``xadd`` is ``[T, B, 4H]`` per-step gates, one ``[B, 4H]`` block
    for every step, or the ``[1, 4H]`` bias row. Returns ``(grads, streams)``:
    ``grads = (dx | None, dxadd, dw1x | None, dw1h, dw2x, dw2h, db2)`` with
    ``dxadd`` in the shape of ``xadd``, and ``streams`` the intermediates
    ``gates1``, ``gates2``, ``dgates1``, ``dgates2`` (``[T, B, 4H]`` fp32,
    the dgates unrounded).
    """
    r = _round(mm_dtype)
    B, H = resid.shape[1], w1h.shape[0]
    h1, c1, c2 = resid.split(H, dim=-1)

    def prev(a):  # the t-1 view, zero at t = 0
        return torch.cat([torch.zeros_like(a[:1]), a[:-1]])

    # pass A
    gates2 = r(h1) @ r(w2x) + r(prev(tops)) @ r(w2h) + b2
    gates1 = r(prev(h1)) @ r(w1h) + xadd
    if x is not None:
        gates1 = gates1 + r(x) @ r(w1x)
    # pass B
    c1_p, c2_p = prev(c1), prev(c2)
    w1h_r, w2x_r, w2h_r = r(w1h), r(w2x), r(w2h)
    zero = resid.new_zeros(B, H)
    dh1 = dc1 = dc2 = zero
    dh2 = zero if g_h2 is None else g_h2
    dg1, dg2 = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        dh2_tot = dh2 if g_tops is None else dh2 + g_tops[t]
        dg2[t], dc2 = _cell_bwd(gates2[t], c2_p[t], c2[t], dh2_tot, dc2)
        d2 = r(dg2[t])
        dh2 = d2 @ w2h_r.T
        dg1[t], dc1 = _cell_bwd(gates1[t], c1_p[t], c1[t],
                                dh1 + d2 @ w2x_r.T, dc1)
        dh1 = r(dg1[t]) @ w1h_r.T
    dg1, dg2 = torch.stack(dg1), torch.stack(dg2)
    # pass C

    def tn(a, g):  # sum over the (t, b) rows of a^T g
        return r(a).reshape(-1, a.shape[-1]).T @ r(g).reshape(-1, g.shape[-1])

    dw1h, dw2x = tn(h1[:-1], dg1[1:]), tn(h1, dg2)
    dw2h = tn(tops[:-1], dg2[1:])
    dx = dw1x = None
    if x is not None:
        dw1x = tn(x, dg1)
        if need_dx:
            dx = r(dg1) @ r(w1x).T
    if xadd.dim() == 3:
        dxadd = dg1
    elif xadd.shape[0] == 1 and x is not None:
        dxadd = dg1.sum((0, 1)).reshape(1, -1)
    else:
        dxadd = dg1.sum(0)
    streams = {"gates1": gates1, "gates2": gates2, "dgates1": dg1,
               "dgates2": dg2}
    return (dx, dxadd, dw1x, dw1h, dw2x, dw2h, dg2.sum((0, 1))), streams


def lstm2_fwd_passes_reference(x, xadd, T, w1x, w1h, w2x, w2h, b2,
                               mm_dtype="float32"):
    """The forward of both entries in the tensor-core kernels' structure,
    for tests: the input products of all rows first (pass A), then T + 1
    phases with the two layers one step apart, each one stacked product
    ``[h1 | h2] [[W1h, W2x], [0, W2h]]`` (phase p holds layer 1 at step p and
    layer 2 at step p - 1, which both read h1[p-1] and h2[p-2]).

    ``x [T, B, D]`` or ``None`` (``xadd`` then carries the whole layer-1
    input gates); ``xadd`` is ``[T, B, 4H]`` per-step gates, one ``[B, 4H]``
    block for every step, or the ``[1, 4H]`` bias row. Returns ``((tops, h2,
    resid), streams)`` with ``streams["xp"]`` the ``[T, B, 4H]`` layer-1 gates
    without their recurrent part, as pass A leaves them (``None`` without
    ``x``).
    """
    r = _round(mm_dtype)
    H = w1h.shape[0]
    xp = None
    if x is not None:
        xp = r(x) @ r(w1x) + xadd
        g1_at = lambda t: xp[t]  # noqa: E731
        B = x.shape[1]
    else:
        g1_at = (lambda t: xadd) if xadd.dim() == 2 else (lambda t: xadd[t])
        B = xadd.shape[-2]
    stacked = torch.cat([torch.cat([w1h, w2x], dim=1),
                         torch.cat([torch.zeros_like(w2h), w2h], dim=1)])
    stacked = r(stacked)
    h1 = c1 = h2 = c2 = w1h.new_zeros(B, H)
    tops, h1s, c1s, c2s = [], [], [], []
    for p in range(T + 1):
        g = r(torch.cat([h1, h2], dim=1)) @ stacked
        if p >= 1:
            h2, c2 = _cell(g[:, 4 * H:] + b2, c2)
            tops.append(h2)
            c2s.append(c2)
        if p < T:
            h1, c1 = _cell(g1_at(p) + g[:, :4 * H], c1)
            h1s.append(h1)
            c1s.append(c1)
    resid = torch.cat([torch.stack(h1s), torch.stack(c1s), torch.stack(c2s)],
                      dim=-1)
    return (torch.stack(tops), h2, resid), {"xp": xp}


# -------------------------------------------------------------- kernels


def _check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the LSTM kernels run on CUDA tensors, not {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"the LSTM kernels take contiguous float32 tensors on one "
                f"device; got {t.dtype} {tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _library(H: int, mm_dtype: str):
    if mm_dtype not in MM_DTYPES:
        raise ValueError(f"mm_dtype must be one of {MM_DTYPES}")
    lib = _build.library()
    if lib.sfhvae_lstm2_threads(H) > 1024:
        raise ValueError(f"hidden width {H} exceeds the kernels' block size")
    return lib


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _xadd_strides(xadd: torch.Tensor, T: int, proj: bool) -> tuple[int, int]:
    """(time stride, row stride) of the additive layer-1 gate block: the
    bias row or a ``[B, 4H]`` block repeat at every step; ``[T, B, 4H]``
    gates advance a block per step."""
    H4 = xadd.shape[-1]
    if xadd.dim() == 3:
        return xadd.shape[1] * H4, H4
    return 0, (0 if proj and xadd.shape[0] == 1 else H4)


TC_H = 128       # the hidden width of the tensor-core forms
TC_MAX_D = 128   # their widest fused input
MAX_H = 512      # the widest hidden layer of every form: the FMA kernels'
                 # blocks run kNRG (2) threads a unit, at most 1024
                 # (csrc/lstm2_common.cuh; sfhvae_lstm2_threads)


def forward_form(mm_dtype: str, H: int, D: int) -> str:
    """Which form a forward call on CUDA tensors takes, from the operand
    type and the widths alone (``D`` = 0 without an input projection):
    ``"tc"``, the tensor-core form, for bf16 operands at H = 128 with D a
    multiple of 16 up to 128 (the fhvae stacks: D = 80 for the encoders, 0
    for the decoder); ``"fma"`` for fp32 operands, which must stay true fp32,
    and for every other width."""
    if mm_dtype not in MM_DTYPES:
        raise ValueError(f"mm_dtype must be one of {MM_DTYPES}")
    if (mm_dtype == "bfloat16" and H == TC_H and D % 16 == 0
            and 0 <= D <= TC_MAX_D):
        return "tc"
    return "fma"


def _forward_shapes(x, xadd, w1h):
    """(B, D, H) of a forward call."""
    B = xadd.shape[-2] if xadd.dim() == 3 or x is None else x.shape[1]
    return B, (0 if x is None else x.shape[2]), w1h.shape[0]


def _forward_kernel(entry, x, xadd, T, w1x, w1h, w2x, w2h, b2, mm_dtype,
                    with_tops, with_resid, streams=None):
    """Run the forward in the form :func:`forward_form` names; returns
    (tops | None, h2, resid | None). ``streams``: a dict that receives the
    tensor-core form's intermediate stream ``xp`` (tests only)."""
    B, D, H = _forward_shapes(x, xadd, w1h)
    form = forward_form(mm_dtype, H, D)
    if streams is not None and form != "tc":
        raise ValueError("only the tensor-core form has intermediate streams")
    args = (entry, x, xadd, T, w1x, w1h, w2x, w2h, b2, mm_dtype, with_tops,
            with_resid)
    return _forward_tc(*args, streams) if form == "tc" else _forward_fma(*args)


def _forward_outputs(xadd, T, B, H, with_tops, with_resid):
    dev = xadd.device
    tops = (torch.empty((T, B, H), device=dev, dtype=torch.float32)
            if with_tops or with_resid else None)
    h2 = torch.empty((B, H), device=dev, dtype=torch.float32)
    resid = (torch.empty((T, B, 3 * H), device=dev, dtype=torch.float32)
             if with_resid else None)
    return tops, h2, resid


def _check_aligned(what: str, *tensors) -> None:
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"the tensor-core {what} reads 16-byte vectors: "
                             "every tensor must start on a 16-byte boundary")


def _forward_tc(entry, x, xadd, T, w1x, w1h, w2x, w2h, b2, mm_dtype,
                with_tops, with_resid, streams=None):
    """``csrc/lstm2_fwd.cu``, counted on ``entry``: pass A writes ``xp = x
    w1x + xadd`` for all steps into a ``[T, B, 4H]`` fp32 scratch (proj entry
    only), then the chain walks the T + 1 phases. The kernels read the fp32 weights as they
    lie and round them on the way: no cast, no copy."""
    B, D, H = _forward_shapes(x, xadd, w1h)
    _check_cuda(*(t for t in (x, xadd, w1x, w1h, w2x, w2h, b2)
                  if t is not None))
    lib = _library(H, mm_dtype)
    if mm_dtype != "bfloat16" or not lib.sfhvae_lstm2_tc_takes(H, D):
        raise ValueError(f"the tensor-core forward does not take {mm_dtype} "
                         f"operands at H={H}, D={D}")
    _check_aligned("forward", x, xadd, w1x, w1h, w2x, w2h, b2)
    tops, h2, resid = _forward_outputs(xadd, T, B, H, with_tops, with_resid)
    xp = (torch.empty((T, B, 4 * H), device=xadd.device, dtype=torch.float32)
          if x is not None else None)
    t_stride, row_stride = _xadd_strides(xadd, T, x is not None)
    if B > 0 and T > 0:
        _build.check(lib.sfhvae_lstm2_fwd(
            _ptr(x), xadd.data_ptr(), t_stride, row_stride, _ptr(w1x),
            w1h.data_ptr(), w2x.data_ptr(), w2h.data_ptr(), b2.data_ptr(),
            _ptr(xp), _ptr(tops), h2.data_ptr(), _ptr(resid), T, B, D, H,
            torch.cuda.current_stream(xadd.device).cuda_stream),
            entry.__name__)
        entry.launches += 1
        entry.launches_tc += 1
    if streams is not None:
        streams["xp"] = xp
    return tops, h2, resid


def fwd_chain_probe(T: int, B: int, probe: int, device="cuda"):
    """A callable that launches the chain of the tensor-core forward alone
    (the decoder entry's call, with residuals) on random per-step gates and
    zero weights, for timing (``chip_smoke.py``): ``probe`` 0 the whole chain,
    1 without the loop's global loads and stores (cells, exchange, barrier
    and products: the chain's floor), 3 without the products as well."""
    lib = _library(TC_H, "bfloat16")
    H = TC_H
    xg = 0.5 * torch.randn((T, B, 4 * H), device=device)
    w = torch.zeros((H, 4 * H), device=device)
    tops, h2, resid = _forward_outputs(xg, T, B, H, True, True)
    stream = torch.cuda.current_stream(xg.device).cuda_stream

    def launch():
        _build.check(lib.sfhvae_lstm2_fwd_chain_probe(
            xg.data_ptr(), w.data_ptr(), w.data_ptr(), w.data_ptr(),
            w.data_ptr(), tops.data_ptr(), h2.data_ptr(), resid.data_ptr(),
            T, B, probe, stream), "lstm2_fwd chain probe")
    return launch


def _forward_fma(entry, x, xadd, T, w1x, w1h, w2x, w2h, b2, mm_dtype,
                 with_tops, with_resid):
    """``csrc/lstm2_fwd_fma.cu``, counted on ``entry``: one recurrent kernel,
    fp32 multiply-adds; in bf16 mode it takes bf16 copies of the weights."""
    B, D, H = _forward_shapes(x, xadd, w1h)
    _check_cuda(*(t for t in (x, xadd, w1x, w1h, w2x, w2h, b2)
                  if t is not None))
    lib = _library(H, mm_dtype)
    wdt = torch.bfloat16 if mm_dtype == "bfloat16" else torch.float32
    w1x, w1h, w2x, w2h = (None if w is None else w.to(wdt).contiguous()
                          for w in (w1x, w1h, w2x, w2h))
    tops, h2, resid = _forward_outputs(xadd, T, B, H, with_tops, with_resid)
    t_stride, row_stride = _xadd_strides(xadd, T, x is not None)
    if B > 0 and T > 0:
        code = lib.sfhvae_lstm2_fwd_fma(
            _ptr(x), xadd.data_ptr(), t_stride, row_stride, _ptr(w1x),
            w1h.data_ptr(), w2x.data_ptr(), w2h.data_ptr(), b2.data_ptr(),
            _ptr(tops), h2.data_ptr(), _ptr(resid), T, B, D, H,
            int(mm_dtype == "bfloat16"),
            torch.cuda.current_stream(xadd.device).cuda_stream)
        _build.check(code, entry.__name__)
        entry.launches += 1
    return tops, h2, resid


def backward_form(mm_dtype: str, H: int, D: int) -> str:
    """Which form a backward call on CUDA tensors takes: the rule of
    :func:`forward_form` (``"tc"``, the three-pass tensor-core form, for bf16
    operands at H = 128 with D a multiple of 16 up to 128; else ``"fma"``)."""
    return forward_form(mm_dtype, H, D)


def _backward_kernel(entry, x, xadd, T, resid, tops, w1x, w1h, w2x, w2h, b2,
                     g_tops, g_h2, mm_dtype, need_dx, streams=None):
    """Run the backward in the form :func:`backward_form` names. Returns
    ``(dx | None, dxadd, dw1x | None, dw1h, dw2x, dw2h, db2)``; dxadd has the
    shape of ``xadd``. ``streams``: a dict that receives the tensor-core
    form's intermediate streams (tests only; it splits the call in two)."""
    H = w1h.shape[0]
    B = resid.shape[1]
    D = 0 if x is None else x.shape[2]
    g_tops = None if g_tops is None else g_tops.contiguous()
    g_h2 = None if g_h2 is None else g_h2.contiguous()
    _check_cuda(*(t for t in (resid, tops, x, xadd, w1x, w1h, w2x, w2h, b2,
                              g_tops, g_h2) if t is not None))
    lib = _library(H, mm_dtype)
    form = backward_form(mm_dtype, H, D)
    if streams is not None and form != "tc":
        raise ValueError("only the tensor-core form has intermediate streams")
    run = _backward_tc if form == "tc" else _backward_fma
    return run(lib, entry, x, xadd, T, B, D, H, resid, tops, w1x, w1h, w2x,
               w2h, b2, g_tops, g_h2, mm_dtype, x is not None and need_dx,
               streams)


def _outputs(xadd, x, T, B, D, H4, need_dx, dg1):
    """The backward's output tensors: ``(mode, dxadd, dx, dw1x, dw1h, dw2x,
    dw2h, db2)``; mode says how dxadd comes from dgates1."""
    def empty(*shape):
        return torch.empty(shape, device=xadd.device, dtype=torch.float32)

    t_stride, row_stride = _xadd_strides(xadd, T, x is not None)
    if t_stride:          # per-step gates: their gradient is dgates1
        mode, dxadd = 0, dg1
    elif row_stride:      # one [B, 4H] block for every step: sum over t
        mode, dxadd = 1, empty(B, H4)
    else:                 # the bias row: sum over t and rows
        mode, dxadd = 2, empty(1, H4)
    H = H4 // 4
    return (mode, dxadd, empty(T, B, D) if need_dx else None,
            empty(D, H4) if x is not None else None, empty(H, H4),
            empty(H, H4), empty(H, H4), empty(H4))


def _backward_tc(lib, entry, x, xadd, T, B, D, H, resid, tops, w1x, w1h, w2x,
                 w2h, b2, g_tops, g_h2, mm_dtype, need_dx, streams):
    """``csrc/lstm2_bwd.cu``, counted on ``entry`` (one launch a call, also
    when ``streams`` splits it): pass A writes the gates of all steps into two
    ``[T, B, 4H]`` fp32 buffers, pass B walks time backwards and writes the
    dgates as bf16 streams (and, for per-step gates, fp32 dgates1 over the
    layer-1 gates), pass C reduces the streams. The kernels read the fp32
    weights as they lie and round them on the way: no cast, no transposed
    copy."""
    H4 = 4 * H
    dev = resid.device
    if not lib.sfhvae_lstm2_tc_takes(H, D):
        raise ValueError(f"the tensor-core backward does not take H={H}, "
                         f"D={D}")
    _check_aligned("backward", x, xadd, resid, tops, w1x, w1h, w2x, w2h, b2,
                   g_tops, g_h2)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, device=dev, dtype=dtype)

    g1, g2 = empty(T, B, H4), empty(T, B, H4)
    dg1b = empty(T, B, H4, dtype=torch.bfloat16)
    dg2b = empty(T, B, H4, dtype=torch.bfloat16)
    mode, dxadd, dx, dw1x, dw1h, dw2x, dw2h, db2 = _outputs(
        xadd, x, T, B, D, H4, need_dx, g1)
    rows = lib.sfhvae_lstm2_bwd_chunk_rows()
    part = empty(4 * -(-(T * B) // rows) * H * H4)
    rowsum1 = empty(B, H4) if mode == 2 else None
    rowsum2 = empty(B, H4)
    t_stride, row_stride = _xadd_strides(xadd, T, x is not None)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(passes):
        _build.check(lib.sfhvae_lstm2_bwd(
            _ptr(x), xadd.data_ptr(), t_stride, row_stride, resid.data_ptr(),
            tops.data_ptr(), _ptr(g_tops), _ptr(g_h2), _ptr(w1x),
            w1h.data_ptr(), w2x.data_ptr(), w2h.data_ptr(), b2.data_ptr(),
            g1.data_ptr(), g2.data_ptr(), dg1b.data_ptr(), dg2b.data_ptr(),
            _ptr(dx), dxadd.data_ptr(), mode, _ptr(dw1x), dw1h.data_ptr(),
            dw2x.data_ptr(), dw2h.data_ptr(), db2.data_ptr(),
            part.data_ptr(), _ptr(rowsum1), rowsum2.data_ptr(), T, B, D, H,
            passes, 0, stream), entry.__name__)

    if B > 0 and T > 0:
        if streams is None:
            run(7)
        else:
            run(1)
            streams.update(gates1=g1.clone(), gates2=g2.clone())
            run(6)
            streams.update(dgates1=dg1b, dgates2=dg2b)
        entry.launches += 1
        entry.launches_tc += 1
    return dx, dxadd, dw1x, dw1h, dw2x, dw2h, db2


def chain_probe(T: int, B: int, probe: int, device="cuda"):
    """A callable that launches pass B of the tensor-core backward alone on
    random gates and zero weights, for timing the reverse-time chain
    (``chip_smoke.py``): ``probe`` 0 the whole pass, 1 without the loop's
    global loads and stores (cell adjoints, exchange, barriers and products:
    the chain's floor), 3 without the products as well (cell adjoints,
    exchange and barriers alone)."""
    lib = _library(TC_H, "bfloat16")
    H, H4 = TC_H, 4 * TC_H
    z = 0.5 * torch.randn((T, B, H4), device=device)
    resid, gt = z[..., :3 * H].contiguous(), z[..., :H].contiguous()
    w = torch.zeros((H, H4), device=device)
    dgb = torch.empty((2, T, B, H4), device=device, dtype=torch.bfloat16)
    rowsum = torch.empty((2, B, H4), device=device)
    stream = torch.cuda.current_stream(z.device).cuda_stream

    def launch():
        _build.check(lib.sfhvae_lstm2_bwd(
            None, z.data_ptr(), 0, 0, resid.data_ptr(), gt.data_ptr(),
            gt.data_ptr(), None, None, w.data_ptr(), w.data_ptr(),
            w.data_ptr(), w.data_ptr(), z.data_ptr(), z.data_ptr(),
            dgb[0].data_ptr(), dgb[1].data_ptr(), None, rowsum[0].data_ptr(),
            1, None, None, None, None, None, None, None,
            rowsum[1].data_ptr(), T, B, 0, H, 2, probe, stream),
            "lstm2_bwd chain probe")
    return launch


def _backward_fma(lib, entry, x, xadd, T, B, D, H, resid, tops, w1x, w1h, w2x,
                  w2h, b2, g_tops, g_h2, mm_dtype, need_dx, streams):
    """``csrc/lstm2_bwd_fma.cu``, counted on ``entry``: one recurrent kernel
    that recomputes the gates per step, then the reductions, all in fp32
    multiply-adds."""
    H4 = 4 * H
    wdt = torch.bfloat16 if mm_dtype == "bfloat16" else torch.float32
    w1x_k, w1h_k, w2x_k, w2h_k = (None if w is None else w.to(wdt).contiguous()
                                  for w in (w1x, w1h, w2x, w2h))
    w1hT, w2xT, w2hT = (w.t().contiguous() for w in (w1h_k, w2x_k, w2h_k))
    dev = resid.device

    def empty(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    t_stride, row_stride = _xadd_strides(xadd, T, x is not None)
    dg1, dg2 = empty(T, B, H4), empty(T, B, H4)
    mode, dxadd, dx, dw1x, dw1h, dw2x, dw2h, db2 = _outputs(
        xadd, x, T, B, D, H4, need_dx, dg1)
    rows = lib.sfhvae_lstm2_bwd_fma_chunk_rows()
    part = empty(-(-(T * B) // rows) * max(D, H) * H4)
    rowsum = empty(B, H4)
    if B > 0 and T > 0:
        code = lib.sfhvae_lstm2_bwd_fma(
            _ptr(x), xadd.data_ptr(), t_stride, row_stride, resid.data_ptr(),
            tops.data_ptr(), _ptr(g_tops), _ptr(g_h2), _ptr(w1x_k),
            w1h_k.data_ptr(), w2x_k.data_ptr(), w2h_k.data_ptr(),
            w1hT.data_ptr(), w2xT.data_ptr(), w2hT.data_ptr(),
            _ptr(w1x if dx is not None else None), b2.data_ptr(),
            dg1.data_ptr(), dg2.data_ptr(), _ptr(dx), dxadd.data_ptr(), mode,
            _ptr(dw1x), dw1h.data_ptr(), dw2x.data_ptr(), dw2h.data_ptr(),
            db2.data_ptr(), part.data_ptr(), rowsum.data_ptr(), T, B, D, H,
            int(mm_dtype == "bfloat16"),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(code, entry.__name__)
        entry.launches += 1
    return dx, dxadd, dw1x, dw1h, dw2x, dw2h, db2


def lstm2_tm_proj_bwd(x, xgc, resid, tops, w1x, w1h, w2x, w2h, b2, g_tops,
                      g_h2, mm_dtype="float32", need_dx=True, streams=None):
    """Backward of :func:`lstm2_tm_proj` (the VJP ``_bwd_call_p``).

    Takes the forward's inputs (``x [T, B, D]``, ``xgc [B or 1, 4H]``, the
    weight blocks ``w1x [D, 4H]``, ``w1h``, ``w2x``, ``w2h [H, 4H]``,
    ``b2 [4H]``), its residuals (``resid [T, B, 3H]``, ``tops [T, B, H]``)
    and the cotangents of ``tops`` and ``h2`` (``None`` means zero).
    Returns ``(dx | None, dxgc, dw1x, dw1h, dw2x, dw2h, db2)``.
    ``streams``: see :func:`_backward_kernel` (CUDA tensors only).
    """
    if x.device.type == "cpu":
        return lstm2_tm_proj_bwd_reference(x, xgc, resid, tops, w1x, w1h, w2x,
                                           w2h, b2, g_tops, g_h2, mm_dtype,
                                           need_dx)
    return _backward_kernel(lstm2_tm_proj_bwd, x, xgc, x.shape[0], resid,
                            tops, w1x, w1h, w2x, w2h, b2, g_tops, g_h2,
                            mm_dtype, need_dx, streams)


def lstm2_tm_bwd(xg1, T, resid, tops, w1h, w2x, w2h, b2, g_tops, g_h2,
                 mm_dtype="float32", streams=None):
    """Backward of :func:`lstm2_tm` (the VJP ``_bwd_call``). Returns
    ``(dxg1, dw1h, dw2x, dw2h, db2)``; in const mode (``xg1 [B, 4H]``)
    ``dxg1`` is summed over the T steps. ``streams``: see
    :func:`_backward_kernel` (CUDA tensors only)."""
    if xg1.device.type == "cpu":
        return lstm2_tm_bwd_reference(xg1, T, resid, tops, w1h, w2x, w2h, b2,
                                      g_tops, g_h2, mm_dtype)
    _, dxg1, _, dw1h, dw2x, dw2h, db2 = _backward_kernel(
        lstm2_tm_bwd, None, xg1, T, resid, tops, None, w1h, w2x, w2h, b2,
        g_tops, g_h2, mm_dtype, False, streams)
    return dxg1, dw1h, dw2x, dw2h, db2


# ------------------------------------------------------------- autograd


class _ProjFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, xgc, w1x, w1h, w2x, w2h, b2, mm_dtype, plain):
        if plain:
            tops, h2, resid = _proj_forward_plain(
                x, xgc, w1x, w1h, w2x, w2h, b2, mm_dtype, with_resid=True)
        else:
            tops, h2, resid = _forward_kernel(
                lstm2_tm_proj, x, xgc, x.shape[0], w1x, w1h, w2x, w2h, b2,
                mm_dtype, True, True)
        ctx.save_for_backward(x, xgc, resid, tops, w1x, w1h, w2x, w2h, b2)
        ctx.mm_dtype, ctx.plain = mm_dtype, plain
        ctx.set_materialize_grads(False)
        return tops, h2

    @staticmethod
    def backward(ctx, g_tops, g_h2):
        bwd = lstm2_tm_proj_bwd_reference if ctx.plain else lstm2_tm_proj_bwd
        grads = bwd(*ctx.saved_tensors, g_tops, g_h2, ctx.mm_dtype,
                    ctx.needs_input_grad[0])
        return (*grads, None, None)


class _TmFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg1, w1h, w2x, w2h, b2, T, mm_dtype, plain):
        if plain:
            tops, h2, resid = _tm_forward_plain(xg1, T, w1h, w2x, w2h, b2,
                                                mm_dtype, with_resid=True)
        else:
            tops, h2, resid = _forward_kernel(lstm2_tm, None, xg1, T, None,
                                              w1h, w2x, w2h, b2, mm_dtype,
                                              True, True)
        ctx.save_for_backward(xg1, resid, tops, w1h, w2x, w2h, b2)
        ctx.T, ctx.mm_dtype, ctx.plain = T, mm_dtype, plain
        ctx.set_materialize_grads(False)
        return tops, h2

    @staticmethod
    def backward(ctx, g_tops, g_h2):
        xg1, resid, tops, w1h, w2x, w2h, b2 = ctx.saved_tensors
        bwd = lstm2_tm_bwd_reference if ctx.plain else lstm2_tm_bwd
        grads = bwd(xg1, ctx.T, resid, tops, w1h, w2x, w2h, b2, g_tops, g_h2,
                    ctx.mm_dtype)
        return (*grads, None, None, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# ----------------------------------------------------------------- entries


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


def _proj(plain: bool, cells, x, xgc, mm_dtype, with_tops):
    T, B, D = x.shape
    H = _stack_shapes(cells, D)
    (w1, b1), (w2, b2) = cells
    if xgc is None:
        xgc = b1.reshape(1, 4 * H)
    if xgc.dim() != 2 or xgc.shape[1] != 4 * H or xgc.shape[0] not in (1, B):
        raise ValueError(f"xgc must be [{B}, {4 * H}] or [1, {4 * H}]; got "
                         f"{tuple(xgc.shape)}")
    args = (x, xgc, w1[:D], w1[-H:], w2[:H], w2[H:], b2)
    if _needs_grad(*args):
        tops, h2 = _ProjFn.apply(*args, mm_dtype, plain)
    elif plain:
        tops, h2, _ = _proj_forward_plain(*args, mm_dtype)
    else:
        tops, h2, _ = _forward_kernel(lstm2_tm_proj, x, xgc, T, *args[2:],
                                      mm_dtype, with_tops, False)
    return (tops if with_tops else None), h2


def _tm(plain: bool, cells, xg1, T, mm_dtype, with_tops):
    if xg1.dim() == 2:
        if T is None:
            raise ValueError("const mode ([B, 4H] gates) needs T")
    else:
        T = xg1.shape[0]
    H = _stack_shapes(cells, 0)
    if xg1.shape[-1] != 4 * H:
        raise ValueError(f"xg1 last dim must be {4 * H}; got "
                         f"{tuple(xg1.shape)}")
    (w1, _), (w2, b2) = cells
    args = (xg1, w1[-H:], w2[:H], w2[H:], b2)
    if _needs_grad(*args):
        tops, h2 = _TmFn.apply(*args, T, mm_dtype, plain)
    elif plain:
        tops, h2, _ = _tm_forward_plain(xg1, T, *args[1:], mm_dtype)
    else:
        tops, h2, _ = _forward_kernel(lstm2_tm, None, xg1, T, None, *args[1:],
                                      mm_dtype, with_tops, False)
    return (tops if with_tops else None), h2


def lstm2_tm_proj(cells, x, xgc=None, mm_dtype="float32", with_tops=True):
    """Projection-fused time-major entry (``lstm2_pallas_tm_proj``).

    ``x [T, B, D]`` raw inputs, projected by ``w1[:D]`` inside the kernel.
    ``xgc``: ``[B, 4H]`` or ``[1, 4H]`` additive gate block — the projection
    of the input's non-x part plus the layer-1 bias; ``None`` means the bias
    row ``b1`` alone. Returns ``(tops [T, B, H] | None, h2 [B, H])``; with
    ``with_tops=False`` the kernel skips the tops write (the encoders need
    only h2) unless autograd needs tops as a residual.
    """
    return _proj(x.device.type == "cpu", cells, x, xgc, mm_dtype, with_tops)


def lstm2_tm_proj_reference(cells, x, xgc=None, mm_dtype="float32",
                            with_tops=True):
    """Plain version of :func:`lstm2_tm_proj` (backward:
    :func:`lstm2_tm_proj_bwd_reference`)."""
    return _proj(True, cells, x, xgc, mm_dtype, with_tops)


def lstm2_tm(cells, xg1, T=None, mm_dtype="float32", with_tops=True):
    """Precomputed-gate time-major entry (``lstm2_pallas_tm``).

    ``xg1``: ``[T, B, 4H]`` layer-1 gate pre-activations (projection and
    bias applied), or ``[B, 4H]`` with ``T`` given when the input is the same
    at every step — the decoder's const mode, where the kernel reads the one
    block at every step and no ``[T, B, 4H]`` broadcast exists.
    Returns ``(tops [T, B, H] | None, h2 [B, H])``.
    """
    return _tm(xg1.device.type == "cpu", cells, xg1, T, mm_dtype, with_tops)


def lstm2_tm_reference(cells, xg1, T=None, mm_dtype="float32",
                       with_tops=True):
    """Plain version of :func:`lstm2_tm` (backward:
    :func:`lstm2_tm_bwd_reference`)."""
    return _tm(True, cells, xg1, T, mm_dtype, with_tops)


lstm2_tm_proj.launches = 0
lstm2_tm.launches = 0
lstm2_tm_proj_bwd.launches = 0
lstm2_tm_bwd.launches = 0
lstm2_tm_proj.launches_tc = 0
lstm2_tm.launches_tc = 0
lstm2_tm_proj_bwd.launches_tc = 0
lstm2_tm_bwd.launches_tc = 0
