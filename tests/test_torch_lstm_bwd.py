"""The port's LSTM backward against the JAX package's, on the CPU.

On a CPU tensor each forward entry's autograd Function runs the plain
forward and the explicit plain backward (``lstm2_tm_proj_bwd_reference``,
``lstm2_tm_bwd_reference``), the functions the CUDA backward kernels are
held against on the card. They are held here against ``jax.vjp`` of the
Pallas entries (``lstm2_pallas_tm_proj`` / ``lstm2_pallas_tm``, interpret
mode) for the four forms the model runs or the kernels take: the z2
encoder (bias row), the z1 encoder (``xgc`` tile), the decoder (const
gates) and precomputed ``[T, B, 4H]`` gates, with the same numpy inputs and
cotangents, in fp32 and in bf16 operand mode.

Errors are relative Frobenius norms, ``|got - want| / |want|``, per
gradient, the largest over the gradients. In fp32 the limit is 1e-5, sum-order
noise (the port measures ~1e-7). In bf16 two implementations whose fp32 sums
run in different orders can round a gate adjoint to different bf16 values
when it lies on a rounding boundary, and one such flip moves the whole row of
the step before it (up to 4.4e-4 in norm over five seeds), so the bf16 limit
is 1e-3. The JAX Pallas backward in fp32 and in bf16 differ by 2.3e-3 to
5.2e-3, and torch autograd through the plain forward (which rounds the
results of the backward products instead of their operands, and keeps the
gate adjoints fp32) misses the Pallas bf16 backward by 2.9e-3 to 4.2e-3:
the tests assert both above twice the limit, so a backward that rounded in
the wrong place fails it.

``lstm2_bwd_passes_reference`` is the plain backward in the tensor-core
kernels' pass structure (all gates first, the reverse loop without recompute,
then the reductions). It is held against the plain backward per gradient (fp32
at 1e-6: the same products, batched over T instead of per step; bf16 at the
limit above), its intermediate streams against what the forward formed and the
plain backward's dgates, and, put in the Functions' place, against the Pallas
VJP like the plain backward itself.
"""

import jax
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

T, B, D, H, Z = 5, 8, 8, 16, 4
TOL = 1e-5       # fp32
TOL_BF16 = 1e-3  # bf16 operands: rounding flips, see above
FORMS = ("z2 bias row", "z1 xgc tile", "decoder const", "precomputed")


def make_case(form: str, seed: int = 0):
    """Numpy inputs of one form: cells, the primal input(s), cotangents."""
    rng = np.random.default_rng(seed)
    d_in = {"z2 bias row": D, "z1 xgc tile": D + Z}.get(form, 2 * Z)
    cells = []
    for d in (d_in, H):
        cells.append((rng.uniform(-0.4, 0.4, (d + H, 4 * H)).astype(np.float32),
                      (0.1 * rng.standard_normal(4 * H)).astype(np.float32)))
    inputs = {}
    if form in ("z2 bias row", "z1 xgc tile"):
        inputs["x"] = rng.standard_normal((T, B, D)).astype(np.float32)
    if form == "z1 xgc tile":
        inputs["xgc"] = rng.standard_normal((B, 4 * H)).astype(np.float32)
    if form == "decoder const":
        inputs["xg1"] = rng.standard_normal((B, 4 * H)).astype(np.float32)
    if form == "precomputed":
        inputs["xg1"] = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    g_tops = rng.standard_normal((T, B, H)).astype(np.float32)
    g_h2 = rng.standard_normal((B, H)).astype(np.float32)
    return cells, inputs, g_tops, g_h2


def jax_grads(form, cells, inputs, g_tops, g_h2, mm):
    p = {"cells": [{"w": jnp.asarray(w), "b": jnp.asarray(b)}
                   for w, b in cells]}
    names = sorted(inputs)

    def f(p, *args):
        kw = dict(zip(names, args))
        if "x" in kw:
            return lstm2_pallas_tm_proj(p, kw["x"], kw.get("xgc"), T=T,
                                        interpret=True, mm_dtype=mm)
        return lstm2_pallas_tm(p, kw["xg1"], T=T, interpret=True,
                               mm_dtype=mm)

    _, vjp = jax.vjp(f, p, *(jnp.asarray(inputs[n]) for n in names))
    gp, *gin = vjp((jnp.asarray(g_tops), jnp.asarray(g_h2)))
    out = {f"{k}{i + 1}": np.asarray(c[k])
           for i, c in enumerate(gp["cells"]) for k in ("w", "b")}
    out.update({n: np.asarray(g) for n, g in zip(names, gin)})
    return out


def port_grads(form, cells, inputs, g_tops, g_h2, mm, autograd_plain=False):
    """Gradients through the port's entry (its Function, plain on the CPU),
    or with ``autograd_plain`` through torch autograd of the raw plain
    forward."""
    tc = [(torch.tensor(w, requires_grad=True),
           torch.tensor(b, requires_grad=True)) for w, b in cells]
    ti = {n: torch.tensor(v, requires_grad=True) for n, v in inputs.items()}
    (w1, b1), (w2, b2) = tc
    if autograd_plain:
        assert form in ("z2 bias row", "z1 xgc tile")
        xgc = ti.get("xgc", b1.reshape(1, -1))
        tops, h2, _ = lstm_cuda._proj_forward_plain(
            ti["x"], xgc, w1[:D], w1[-H:], w2[:H], w2[H:], b2, mm)
    elif "x" in ti:
        tops, h2 = lstm_cuda.lstm2_tm_proj(tc, ti["x"], ti.get("xgc"), mm)
    else:
        tops, h2 = lstm_cuda.lstm2_tm(tc, ti["xg1"], T, mm)
    names = ["w1", "b1", "w2", "b2", *sorted(ti)]
    leaves = [w1, b1, w2, b2, *(ti[n] for n in sorted(ti))]
    grads = torch.autograd.grad((tops, h2), leaves,
                                (torch.tensor(g_tops), torch.tensor(g_h2)),
                                allow_unused=True)
    return {n: (np.zeros(leaf.shape, np.float32) if g is None else g.numpy())
            for n, g, leaf in zip(names, grads, leaves)}


def rel_err(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(float(np.linalg.norm(got[k] - want[k])
                     / max(np.linalg.norm(want[k]), 1e-30)) for k in want)


@pytest.mark.parametrize("form", FORMS)
def test_fp32_backward_matches_pallas_vjp(form):
    case = make_case(form)
    want = jax_grads(form, *case, None)
    got = port_grads(form, *case, "float32")
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("form", FORMS)
def test_bf16_backward_matches_pallas_vjp(form):
    case = make_case(form)
    want = jax_grads(form, *case, jnp.bfloat16)
    got = port_grads(form, *case, "bfloat16")
    assert rel_err(got, want) <= TOL_BF16
    # the limit is well below what bf16 rounding moves
    gap = rel_err(jax_grads(form, *case, None), want)
    assert gap > 2 * TOL_BF16, gap


@pytest.mark.parametrize("form", ["z2 bias row", "z1 xgc tile"])
def test_autograd_through_plain_forward_fails_the_bf16_limit(form):
    """Autograd through the plain forward is another function at bf16
    operands: it misses the Pallas backward by more than the limit the
    explicit plain backward meets."""
    case = make_case(form)
    want = jax_grads(form, *case, jnp.bfloat16)
    autograd = port_grads(form, *case, "bfloat16", autograd_plain=True)
    assert rel_err(autograd, want) > 2 * TOL_BF16
    # in fp32 the two are the same function
    want32 = jax_grads(form, *case, None)
    assert rel_err(port_grads(form, *case, "float32", autograd_plain=True),
                   want32) <= TOL


@pytest.mark.parametrize("form", ["z2 bias row", "decoder const"])
def test_fp32_backward_matches_scan_path(form):
    """fp32 gradients against ``jax.vjp`` of the JAX scan path
    (``run_lstm``, the wavefront schedule): the z2 encoder on batch-major x,
    and the decoder on its input broadcast over T (gradient w.r.t. z)."""
    cells, inputs, g_tops, g_h2 = make_case(form, seed=2)
    z = np.random.default_rng(3).standard_normal((B, 2 * Z)).astype(np.float32)
    p = {"cells": [{"w": jnp.asarray(w), "b": jnp.asarray(b)}
                   for w, b in cells]}
    if form == "z2 bias row":
        primal = inputs["x"]

        def f(p, a):
            seq, h2 = run_lstm(p, jnp.swapaxes(a, 0, 1), use_pallas="never")
            return jnp.swapaxes(seq, 0, 1), h2
    else:
        primal = z

        def f(p, a):
            seq, h2 = run_lstm(p, jnp.broadcast_to(a[:, None], (B, T, 2 * Z)),
                               use_pallas="never")
            return jnp.swapaxes(seq, 0, 1), h2
    _, vjp = jax.vjp(f, p, jnp.asarray(primal))
    gp, ga = vjp((jnp.asarray(g_tops), jnp.asarray(g_h2)))
    want = {f"{k}{i + 1}": np.asarray(c[k])
            for i, c in enumerate(gp["cells"]) for k in ("w", "b")}
    want["in"] = np.asarray(ga)

    tc = [(torch.tensor(w, requires_grad=True),
           torch.tensor(b, requires_grad=True)) for w, b in cells]
    ta = torch.tensor(primal, requires_grad=True)
    (w1, b1), (w2, b2) = tc
    if form == "z2 bias row":
        tops, h2 = lstm_cuda.lstm2_tm_proj(tc, ta)
    else:
        tops, h2 = lstm_cuda.lstm2_tm(tc, ta @ w1[:2 * Z] + b1, T)
    grads = torch.autograd.grad((tops, h2), [w1, b1, w2, b2, ta],
                                (torch.tensor(g_tops), torch.tensor(g_h2)))
    got = dict(zip(["w1", "b1", "w2", "b2", "in"],
                   (g.numpy() for g in grads)))
    assert rel_err(got, want) <= TOL


def test_backward_entries_on_cpu_run_the_plain_backward():
    """Called directly on CPU tensors, a backward entry is its plain version
    and counts no launch; a cotangent of None counts as zero."""
    cells, inputs, g_tops, _ = make_case("z1 xgc tile")
    (w1, _), (w2, b2) = [(torch.tensor(w), torch.tensor(b)) for w, b in cells]
    x, xgc = torch.tensor(inputs["x"]), torch.tensor(inputs["xgc"])
    args = (x, xgc, w1[:D], w1[-H:], w2[:H], w2[H:], b2)
    tops, _, resid = lstm_cuda._proj_forward_plain(*args, "bfloat16",
                                                   with_resid=True)
    got = lstm_cuda.lstm2_tm_proj_bwd(x, xgc, resid, tops, *args[2:],
                                      torch.tensor(g_tops), None, "bfloat16")
    want = lstm_cuda.lstm2_tm_proj_bwd_reference(
        x, xgc, resid, tops, *args[2:], torch.tensor(g_tops),
        torch.zeros(B, H), "bfloat16")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert lstm_cuda.lstm2_tm_proj_bwd.launches == 0
    assert lstm_cuda.lstm2_tm_bwd.launches == 0


# ------------------------------------------- the pass-structured backward

TOL_PASSES = 1e-6  # fp32: the same products, batched over T


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def passes_case(form, mm):
    """Torch inputs of one form with the plain forward's residuals:
    ``(x | None, xadd, resid, tops, weights, g_tops, g_h2)``."""
    cells, inputs, g_tops, g_h2 = make_case(form, seed=4)
    (w1, b1), (w2, b2) = [(torch.tensor(w), torch.tensor(b)) for w, b in cells]
    weights = (w1[:D] if "x" in inputs else None, w1[-H:], w2[:H], w2[H:], b2)
    if "x" in inputs:
        x = torch.tensor(inputs["x"])
        xadd = (torch.tensor(inputs["xgc"]) if "xgc" in inputs
                else b1.reshape(1, -1))
        tops, _, resid = lstm_cuda._proj_forward_plain(x, xadd, *weights, mm,
                                                       with_resid=True)
    else:
        x, xadd = None, torch.tensor(inputs["xg1"])
        tops, _, resid = lstm_cuda._tm_forward_plain(xadd, T, *weights[1:],
                                                     mm, with_resid=True)
    return x, xadd, resid, tops, weights, torch.tensor(g_tops), \
        torch.tensor(g_h2)


@pytest.mark.parametrize("mm,tol", [("float32", TOL_PASSES),
                                    ("bfloat16", TOL_BF16)])
@pytest.mark.parametrize("form", FORMS)
def test_pass_structured_backward_matches_plain_backward(form, mm, tol):
    x, xadd, resid, tops, weights, g_tops, g_h2 = passes_case(form, mm)
    got, streams = lstm_cuda.lstm2_bwd_passes_reference(
        x, xadd, T, resid, tops, *weights, g_tops, g_h2, mm)
    if x is not None:
        want = lstm_cuda.lstm2_tm_proj_bwd_reference(
            x, xadd, resid, tops, *weights, g_tops, g_h2, mm)
    else:
        dxg1, *rest = lstm_cuda.lstm2_tm_bwd_reference(
            xadd, T, resid, tops, *weights[1:], g_tops, g_h2, mm)
        want = (None, dxg1, None, *rest)
    assert [g is None for g in got] == [w is None for w in want]
    for a, b in zip(got, want):
        if b is not None:
            assert a.shape == b.shape and rel(a, b) <= tol
    # pass A: the gates are the ones the forward formed, so the cell applied
    # to them and the state before gives the saved state back
    h1, c1, c2 = resid.split(H, dim=-1)
    zero = torch.zeros(1, B, H)
    h2_re, c2_re = lstm_cuda._cell(streams["gates2"], torch.cat([zero, c2[:-1]]))
    h1_re, c1_re = lstm_cuda._cell(streams["gates1"], torch.cat([zero, c1[:-1]]))
    for a, b in ((h2_re, tops), (c2_re, c2), (h1_re, h1), (c1_re, c1)):
        assert rel(a, b) <= TOL_PASSES
    # pass B: dgates1 is the plain backward's
    g1_at = ((lambda t: lstm_cuda._mm(x[t], weights[0], mm) + xadd)
             if x is not None else
             (lambda t: xadd[t]) if xadd.dim() == 3 else (lambda t: xadd))
    dg1, _, _, _, db2 = lstm_cuda._bwd_plain(
        g1_at, T, B, resid, tops, *weights[1:], g_tops, g_h2, mm)
    assert rel(streams["dgates1"], dg1) <= tol
    assert rel(streams["dgates2"].sum((0, 1)), db2) <= tol


@pytest.mark.parametrize("mm", [None, jnp.bfloat16])
@pytest.mark.parametrize("form", FORMS)
def test_pass_structured_backward_matches_pallas_vjp(form, mm, monkeypatch):
    """The Functions' backward replaced by the pass-structured one."""
    passes = lstm_cuda.lstm2_bwd_passes_reference

    def proj(x, xgc, resid, tops, w1x, w1h, w2x, w2h, b2, g_tops, g_h2,
             mm_dtype="float32", need_dx=True):
        return passes(x, xgc, x.shape[0], resid, tops, w1x, w1h, w2x, w2h, b2,
                      g_tops, g_h2, mm_dtype, need_dx)[0]

    def tm(xg1, T_, resid, tops, w1h, w2x, w2h, b2, g_tops, g_h2,
           mm_dtype="float32"):
        g = passes(None, xg1, T_, resid, tops, None, w1h, w2x, w2h, b2,
                   g_tops, g_h2, mm_dtype)[0]
        return (g[1], *g[3:])

    monkeypatch.setattr(lstm_cuda, "lstm2_tm_proj_bwd_reference", proj)
    monkeypatch.setattr(lstm_cuda, "lstm2_tm_bwd_reference", tm)
    case = make_case(form)
    want = jax_grads(form, *case, mm)
    got = port_grads(form, *case, "float32" if mm is None else "bfloat16")
    assert rel_err(got, want) <= (TOL if mm is None else TOL_BF16)
