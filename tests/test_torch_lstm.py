"""The port's two-layer LSTM entries against the JAX recurrence.

On the CPU the port's wrappers run their plain PyTorch versions, and the
JAX side runs ``run_lstm(..., use_pallas="never")`` — the scan path that
tests/test_lstm_pallas.py pins to the Pallas kernels. The bf16 operand mode
(the serving default) is held against the Pallas kernels themselves, run in
interpret mode with ``mm_dtype=bfloat16`` as tests/test_lstm_pallas.py runs
them. Inputs and weights come from a numpy seed.
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

