"""The port's two-layer LSTM entries against the JAX recurrence.

On the CPU the port's wrappers run their plain PyTorch versions, and the
JAX side runs ``run_lstm(..., use_pallas="never")`` — the scan path that
tests/test_lstm_pallas.py pins to the Pallas kernels. The bf16 operand mode
(the serving default) is held against the Pallas kernels themselves, run in
interpret mode with ``mm_dtype=bfloat16`` as tests/test_lstm_pallas.py runs
them. Inputs and weights come from a numpy seed.

``lstm2_fwd_passes_reference`` (the forward in the structure of the
tensor-core kernels: the input products of all rows first, then T + 1 phases
with the two layers one step apart, each one stacked product) is held against
the plain entries, the residuals included, and against the Pallas kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.models.fhvae import run_lstm
from pytorch_scalablefhvae_tpu.ops.lstm_pallas import (
    lstm2_pallas_tm,
    lstm2_pallas_tm_proj,
)
from pytorch_scalablefhvae_tpu_torch.ops import lstm_cuda

T, B, D, H, Z = 5, 6, 8, 16, 4
FP32 = dict(atol=1e-5, rtol=1e-5)       # as tests/test_lstm_pallas.py:32
BF16 = dict(atol=0.05, rtol=0.03)       # as tests/test_lstm_pallas.py:164-166
# bf16 operands against the Pallas kernel's bf16 operands: the same
# roundings, so only fp32 sum order differs (~4e-8 measured); fp32 output
# misses this by 1.7e-4 or more at these shapes
BF16_VS_PALLAS = dict(atol=2e-6, rtol=1e-6)


def stack(rng, d_in):
    cells = []
    for d in (d_in, H):
        limit = np.sqrt(6.0 / (d + H + 4 * H))
        w = rng.uniform(-limit, limit, (d + H, 4 * H)).astype(np.float32)
        b = (0.1 * rng.standard_normal(4 * H)).astype(np.float32)
        cells.append((w, b))
    return cells


def jax_params(cells):
    return {"cells": [{"w": jnp.asarray(w), "b": jnp.asarray(b)}
                      for w, b in cells]}


def jax_run(cells, xs_bm):
    seq, last = run_lstm(jax_params(cells), jnp.asarray(xs_bm),
                         use_pallas="never")
    return np.swapaxes(np.asarray(seq), 0, 1), np.asarray(last)


def torch_cells(cells):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in cells]


def check(got, want, tol):
    np.testing.assert_allclose(got[0].numpy(), want[0], **tol)
    np.testing.assert_allclose(got[1].numpy(), want[1], **tol)


@pytest.mark.parametrize("xgc_tile", [False, True], ids=["bias", "xgc_tile"])
def test_tm_proj_matches_jax(xgc_tile):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    if xgc_tile:
        # the z1 encoder: x concatenated with a per-segment z, whose gate
        # block the port computes once and passes as xgc
        cells = stack(rng, D + Z)
        z = rng.standard_normal((B, Z)).astype(np.float32)
        want = jax_run(cells, np.concatenate(
            [x, np.broadcast_to(z[:, None], (B, T, Z))], axis=-1))
        w1, b1 = cells[0]
        xgc = torch.from_numpy(z @ w1[D:D + Z] + b1)
    else:
        cells = stack(rng, D)
        want = jax_run(cells, x)
        xgc = None
    xt = torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 0, 1)))
    got = lstm_cuda.lstm2_tm_proj(torch_cells(cells), xt, xgc)
    check(got, want, FP32)
    assert got[0].shape == (T, B, H)


@pytest.mark.parametrize("const", [False, True], ids=["3d", "const"])
def test_tm_matches_jax(const):
    rng = np.random.default_rng(1)
    d_in = 2 * Z
    cells = stack(rng, d_in)
    w1, b1 = cells[0]
    if const:
        z = rng.standard_normal((B, d_in)).astype(np.float32)
        want = jax_run(cells, np.broadcast_to(z[:, None], (B, T, d_in)))
        got = lstm_cuda.lstm2_tm(torch_cells(cells),
                                 torch.from_numpy(z @ w1[:d_in] + b1), T=T)
    else:
        xs = rng.standard_normal((B, T, d_in)).astype(np.float32)
        want = jax_run(cells, xs)
        xg1 = np.swapaxes(xs @ w1[:d_in] + b1, 0, 1)
        got = lstm_cuda.lstm2_tm(torch_cells(cells),
                                 torch.from_numpy(np.ascontiguousarray(xg1)))
    check(got, want, FP32)


@pytest.mark.parametrize("entry", ["tm_proj", "tm_const"])
def test_bf16_operands_near_fp32(entry):
    """bf16 operand mode rounds weights and h to bf16 with fp32 carries:
    close to fp32, and not equal to it (the rounding is applied)."""
    rng = np.random.default_rng(2)
    cells = torch_cells(stack(rng, D))
    if entry == "tm_proj":
        x = torch.from_numpy(rng.standard_normal((T, B, D)).astype(np.float32))
        f32 = lstm_cuda.lstm2_tm_proj(cells, x, None, "float32")
        b16 = lstm_cuda.lstm2_tm_proj(cells, x, None, "bfloat16")
    else:
        xg = torch.from_numpy(
            rng.standard_normal((B, 4 * H)).astype(np.float32))
        f32 = lstm_cuda.lstm2_tm(cells, xg, T=T, mm_dtype="float32")
        b16 = lstm_cuda.lstm2_tm(cells, xg, T=T, mm_dtype="bfloat16")
    check(b16, (f32[0].numpy(), f32[1].numpy()), BF16)
    assert not torch.equal(b16[1], f32[1])


@pytest.mark.parametrize("form", ["proj", "proj_xgc", "const"])
def test_bf16_matches_jax_pallas_bf16(form):
    """The served default: bf16 operands rounded where ``_make_ref_dot``
    rounds them. The tolerance is tight enough that the port's fp32 output
    fails it, so a skipped or misplaced rounding would fail too."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    if form == "const":
        cells = stack(rng, 2 * Z)
        xg = rng.standard_normal((B, 4 * H)).astype(np.float32)

        def jax_call(mm):
            return lstm2_pallas_tm(jax_params(cells), jnp.asarray(xg), T=T,
                                   interpret=True, mm_dtype=mm)

        def port_call(mm):
            return lstm_cuda.lstm2_tm(torch_cells(cells), torch.from_numpy(xg),
                                      T=T, mm_dtype=mm)
    else:
        cells = stack(rng, D + Z if form == "proj_xgc" else D)
        xgc = None
        if form == "proj_xgc":
            z = rng.standard_normal((B, Z)).astype(np.float32)
            xgc = z @ cells[0][0][D:D + Z] + cells[0][1]

        def jax_call(mm):
            return lstm2_pallas_tm_proj(
                jax_params(cells), jnp.asarray(x),
                None if xgc is None else jnp.asarray(xgc), T=T,
                interpret=True, mm_dtype=mm)

        def port_call(mm):
            return lstm_cuda.lstm2_tm_proj(
                torch_cells(cells), torch.from_numpy(x),
                None if xgc is None else torch.from_numpy(xgc), mm)

    want = [np.asarray(a) for a in jax_call(jnp.bfloat16)]
    got = port_call("bfloat16")
    check(got, want, BF16_VS_PALLAS)
    for a, b in zip(port_call("float32"), want):
        assert not np.allclose(a.numpy(), b, **BF16_VS_PALLAS)


def test_without_tops_and_shape_errors():
    rng = np.random.default_rng(3)
    cells = torch_cells(stack(rng, D))
    x = torch.from_numpy(rng.standard_normal((T, B, D)).astype(np.float32))
    tops, h2 = lstm_cuda.lstm2_tm_proj(cells, x, with_tops=False)
    assert tops is None and h2.shape == (B, H)
    with pytest.raises(ValueError, match="xgc"):
        lstm_cuda.lstm2_tm_proj(cells, x, torch.zeros(B + 1, 4 * H))
    with pytest.raises(ValueError, match="needs T"):
        lstm_cuda.lstm2_tm(cells, torch.zeros(B, 4 * H))
    with pytest.raises(ValueError, match="two-layer"):
        lstm_cuda.lstm2_tm_proj([cells[0], (torch.zeros(H, 4 * H),
                                            cells[1][1])], x)
    # the CPU runs the plain versions: no kernel launch is counted
    assert lstm_cuda.lstm2_tm_proj.launches == 0



# ------------------------------------------- the kernels' pass structure

PB, PD, PH = 37, 24, 32     # a ragged batch; D and H off this file's defaults
# fp32 operands: the stacked product sums a row's terms in another order
PASSES_FP32 = dict(atol=1e-6, rtol=1e-6)
# bf16 operands: that order can flip one bf16 rounding of h (2^-9 relative)
PASSES_BF16 = dict(atol=2e-4, rtol=2e-4)


def passes_case(form, b=PB, seed=5):
    """``(plain call(mm) -> (tops, h2, resid), passes args)`` for one form of
    the two entries at T 5, B ``b``, D 24, H 32."""
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))

    lim = np.sqrt(6.0 / (PD + 5 * PH))
    w1x, w1h, w2x, w2h = (
        torch.from_numpy(rng.uniform(-lim, lim, (k, 4 * PH))
                         .astype(np.float32)) for k in (PD, PH, PH, PH))
    b1, b2 = arr(4 * PH, scale=0.1), arr(4 * PH, scale=0.1)
    if form in ("proj_bias", "proj_xgc"):
        x = arr(T, b, PD)
        xgc = b1.reshape(1, -1) if form == "proj_bias" else arr(b, 4 * PH)

        def plain(mm):
            return lstm_cuda._proj_forward_plain(x, xgc, w1x, w1h, w2x, w2h,
                                                 b2, mm, with_resid=True)

        return plain, (x, xgc, T, w1x, w1h, w2x, w2h, b2)
    xg1 = arr(b, 4 * PH) if form == "tm_const" else arr(T, b, 4 * PH)

    def plain(mm):
        return lstm_cuda._tm_forward_plain(xg1, T, w1h, w2x, w2h, b2, mm,
                                           with_resid=True)

    return plain, (None, xg1, T, None, w1h, w2x, w2h, b2)


@pytest.mark.parametrize("mm,tol", [("float32", PASSES_FP32),
                                    ("bfloat16", PASSES_BF16)])
@pytest.mark.parametrize("form", ["proj_bias", "proj_xgc", "tm_const",
                                  "tm_3d"])
def test_forward_passes_match_plain(form, mm, tol):
    plain, args = passes_case(form)
    want = plain(mm)
    got, streams = lstm_cuda.lstm2_fwd_passes_reference(*args, mm)
    assert got[2].shape == (T, PB, 3 * PH)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **tol)
    if form.startswith("proj"):
        # pass A alone: the layer-1 gates without their recurrent part
        x, xgc, _, w1x = args[:4]
        xp = lstm_cuda._mm(x.reshape(-1, PD), w1x, mm).reshape(T, PB, -1) + xgc
        torch.testing.assert_close(streams["xp"], xp, atol=0, rtol=0)
    else:
        assert streams["xp"] is None
    if mm == "bfloat16":  # the rounding is applied: fp32 misses the limit
        f32 = plain("float32")
        assert not torch.allclose(f32[0], want[0], **tol)


@pytest.mark.parametrize("form", ["proj_bias", "tm_3d"])
def test_forward_passes_rows_do_not_depend_on_the_batch(form):
    """B 32 against 2 x 16 rows: every row the same bits."""
    plain, args = passes_case(form, b=32)
    whole, _ = lstm_cuda.lstm2_fwd_passes_reference(*args, "bfloat16")

    def rows(a, lo):  # x and the gate block carry batch rows
        if a is None or a.shape[-2] != 32:
            return a
        return a[..., lo:lo + 16, :].contiguous()

    halves = [lstm_cuda.lstm2_fwd_passes_reference(
        rows(args[0], lo), rows(args[1], lo), *args[2:], "bfloat16")[0]
        for lo in (0, 16)]
    for w, a, b in zip(whole, *halves):
        assert torch.equal(w, torch.cat([a, b], dim=-2))


@pytest.mark.parametrize("form", ["proj", "proj_xgc", "const"])
def test_forward_passes_match_jax_pallas_bf16(form):
    """The pass structure against the Pallas kernels in interpret mode, bf16
    operands, on the inputs of ``test_bf16_matches_jax_pallas_bf16`` and at
    its tolerance."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    if form == "const":
        cells = stack(rng, 2 * Z)
        xg = rng.standard_normal((B, 4 * H)).astype(np.float32)
        want = lstm2_pallas_tm(jax_params(cells), jnp.asarray(xg), T=T,
                               interpret=True, mm_dtype=jnp.bfloat16)
        (w1, _), (w2, b2) = torch_cells(cells)
        args = (None, torch.from_numpy(xg), T, None, w1[-H:], w2[:H], w2[H:],
                b2)
    else:
        cells = stack(rng, D + Z if form == "proj_xgc" else D)
        xgc = cells[0][1][None]
        if form == "proj_xgc":
            z = rng.standard_normal((B, Z)).astype(np.float32)
            xgc = z @ cells[0][0][D:D + Z] + cells[0][1]
        want = lstm2_pallas_tm_proj(
            jax_params(cells), jnp.asarray(x),
            jnp.asarray(xgc) if form == "proj_xgc" else None, T=T,
            interpret=True, mm_dtype=jnp.bfloat16)
        (w1, _), (w2, b2) = torch_cells(cells)
        args = (torch.from_numpy(x), torch.from_numpy(xgc), T, w1[:D],
                w1[-H:], w2[:H], w2[H:], b2)
    (tops, h2, _), _ = lstm_cuda.lstm2_fwd_passes_reference(*args, "bfloat16")
    check((tops, h2), [np.asarray(a) for a in want], BF16_VS_PALLAS)
