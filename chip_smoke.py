#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs 1 GPU

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. environment: the card's name and power limit, the CUDA and Triton
   versions, nvcc's version; build the kernels from ``csrc/``;
2. every kernel against its plain PyTorch version on the card, at the
   serving shapes of the ``fhvae`` CLI defaults (T = 20, B = 2048, D = 80,
   H = 128; z2 width 16 against tables of 4,620 and 281,241 rows), with max
   abs error, tolerance and the time of each (CUDA events, after warm-up);
3. the slice: synthesize audio, write an fhvae experiment (config, MVN
   stats, a seeded port checkpoint with 4,620 table rows), start the port's
   ``serve`` on piped streams, send a ping, three encode requests, one
   malformed request and a shutdown, check every response, check that the
   three kernel entries were launched during the requests, and hold the
   served latents against the same requests run through the plain versions
   on the card;
2b. the three backward entries against their plain backward at the training
   shapes (B = 1024), in fp32 and bf16 operands, on the same residuals and
   cotangents, two launches compared bitwise; the discriminative backward
   at 4,620 and 281,241 table rows with 7 padded rows, which must get
   exactly zero gradient;
2c. ``windowed_chunk_gather`` against its plain version at the dev MAP
   pass's shape (128 chunks of 16 windows, seg_len 20, stride 8, D 80) on a
   100,000-row store and on a store of TIMIT-train size, whose last chunks
   run into the staged slack: a copy, so equal bit for bit, and two
   launches equal;
4. training: write a preprocessed feature corpus of 4,620 training and 400
   dev sequences; hold the first three train steps through the kernels
   against the same steps through the plain versions on the card, and the
   device-resident tier's first three steps against the host loader's (equal
   bit for bit), and the staged dev pass against itself (bit for bit) and
   the host's; time a step's forward, backward and optimizer (CUDA events)
   and its kernels (torch.profiler), and each tier's data path beside the
   other; then run the port's ``train`` CLI at its defaults (fhvae, batch
   1024, bf16 LSTM operands, ``--data-placement auto``, which stages the
   store and the dev split on the card) for 2 epochs and resume it for a
   third, checking that the data was device-resident, that the loss is
   finite and falls, that the resumed run continues the step count, and
   that all seven kernel entries were launched; last, one epoch with
   ``--data-placement host``, whose train loss must equal the device run's
   epoch 0 and whose dev bound must agree with it.

The bf16 tolerances sit between the kernels' error and the gap between the
plain versions in fp32 and in bf16 operand mode, which each run measures: a
kernel that skipped the bf16 rounding would fail them, and the script raises
if that gap ever falls below a tolerance. It imports only the port, never
the JAX package.

The second-to-last line of stdout is a JSON object with one entry per
kernel entry (``launches`` sums the serve and train runs; ``ms`` and
``plain_ms`` are the bf16-operand times of the entry's heaviest form, and
for ``windowed_chunk_gather`` the device time per call at the dev MAP
shape); the
line before it is nvidia-smi's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import wave
from contextlib import contextmanager, nullcontext, redirect_stdout
from pathlib import Path

import numpy as np
import torch

T, B, D, H, Z = 20, 2048, 80, 128, 16
N_TABLE = 4620          # mu2 rows of the served experiment
N_LARGE = 281_241       # a LibriSpeech-scale table for the discriminative check
TOL_FP32 = 1e-4         # LSTM h2/tops, fp32 operands: only the sum order differs
TOL_BF16 = 6e-4         # LSTM h2/tops, bf16 operands: an fp32 sum-order change
                        # can flip one bf16 rounding of h (2^-9 relative); the
                        # plain fp32 and bf16 modes differ by more (1.2e-3 to
                        # 2.3e-3 at these shapes), checked in every run
TOL_LOG_QY = 1e-3       # log_qy at |logits| ~ 1e2: fp32 sum order over N rows
TOL_SERVED = 6e-4       # served latents, bf16 operand mode; below the plain
                        # fp32-vs-bf16 gap, checked in every run
B_TRAIN = 1024          # the fhvae CLI's training batch
TOL_BWD_FP32 = 1e-4     # LSTM backward, relative Frobenius norm per output:
                        # fp32 sums over T*B = 20,480 rows in another order
TOL_BWD_BF16 = 1e-3     # bf16 operands: a gate adjoint on a bf16 rounding
                        # boundary may round the other way under another
                        # fp32 sum order and move one row of the step before
                        # it; the plain fp32-vs-bf16 backward gap is larger
                        # (~3e-3 at the CPU tests' shapes), checked every run
TOL_LOG_QY_BWD = 1e-4   # dz2/dmu2, max error over max |ref|: fp32 sum order
N_DEV = 400             # dev sequences of the training corpus (TIMIT's dev)
TOL_TRAIN_LOSS = 1e-3   # first train steps, kernels vs plain versions (bf16
                        # operands), relative: a bf16 rounding flip per sum
                        # order moves the loss by far less
TOL_TRAIN_UPDATE = 0.1  # the same, |p_kernels - p_plain| over the norm of
                        # the 3-step update: Adam's first steps move each
                        # element by ~lr * sign(g), so an element whose
                        # gradient is within the kernels' error of zero may
                        # step the other way
TOL_DEV_LB = 1e-5       # dev bound, device vs host tier, relative: the device
                        # MAP table sums in fp32, the host's in fp64
SPB, SEG, SHIFT = 16, 20, 8   # the dev MAP pass's chunks: spb, seg_len, stride
TIMIT_FRAMES = 1_254_584      # frames of the training corpus below
SOURCES = {
    "lstm2_tm_proj": ("pytorch_scalablefhvae_tpu_torch/csrc/lstm2_fwd.cu",
                      "pytorch_scalablefhvae_tpu/ops/lstm_pallas.py:675"),
    "lstm2_tm": ("pytorch_scalablefhvae_tpu_torch/csrc/lstm2_fwd.cu",
                 "pytorch_scalablefhvae_tpu/ops/lstm_pallas.py:741"),
    "discriminative_log_qy": (
        "pytorch_scalablefhvae_tpu_torch/csrc/discriminative_fwd.cu",
        "pytorch_scalablefhvae_tpu/ops/discriminative.py:234"),
    "lstm2_tm_proj_bwd": ("pytorch_scalablefhvae_tpu_torch/csrc/lstm2_bwd.cu",
                          "pytorch_scalablefhvae_tpu/ops/lstm_pallas.py:582"),
    "lstm2_tm_bwd": ("pytorch_scalablefhvae_tpu_torch/csrc/lstm2_bwd.cu",
                     "pytorch_scalablefhvae_tpu/ops/lstm_pallas.py:374"),
    "discriminative_log_qy_bwd": (
        "pytorch_scalablefhvae_tpu_torch/csrc/discriminative_bwd.cu",
        "pytorch_scalablefhvae_tpu/ops/discriminative.py:189"),
    "windowed_chunk_gather": (
        "pytorch_scalablefhvae_tpu_torch/csrc/window_gather.cu",
        "pytorch_scalablefhvae_tpu/ops/window_gather_pallas.py:88"),
}


def log(*parts) -> None:
    print(*parts, flush=True)


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50) -> float:
    """Device time per call: the card's kernel time over ``iters`` calls,
    summed by torch.profiler, so the host's issue time between launches is
    left out (it bounds a call that takes microseconds on the card)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# --------------------------------------------------------------- phase 1


def phase_environment() -> None:
    from pytorch_scalablefhvae_tpu_torch.ops import _build

    log("== phase 1: environment")
    log("gpu:", smi_name_power())
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0),
        "count", torch.cuda.device_count())
    try:
        import triton
        log("triton", triton.__version__)
    except ImportError:
        log("triton: not installed")
    log(subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s -> {lib}")
    report = (lib.parent / "build.log")
    if report.is_file():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas:", line.strip())


# --------------------------------------------------------------- phase 2


def _uniform(g, shape, limit):
    return (torch.rand(shape, generator=g) * 2 - 1) * limit


def _stack(g, d_in):
    """A two-layer stack in the JAX layout, with the model's init scale."""
    cells = []
    for d in (d_in, H):
        w = _uniform(g, (d + H, 4 * H), (6.0 / (d + H + 4 * H)) ** 0.5)
        b = torch.zeros(4 * H)
        b[H:2 * H] = 1.0
        cells.append((w.cuda(), b.cuda()))
    return cells


def phase_kernels() -> dict:
    from pytorch_scalablefhvae_tpu_torch.ops import lstm_cuda
    from pytorch_scalablefhvae_tpu_torch.ops.discriminative import (
        discriminative_log_qy,
        discriminative_log_qy_reference,
    )

    log("== phase 2: kernels against their plain versions "
        f"(T={T} B={B} D={D} H={H})")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((T, B, D), generator=g).cuda()
    z2_stack, z1_stack, dec_stack = (_stack(g, D), _stack(g, D + Z),
                                     _stack(g, 2 * Z))
    z = torch.randn((B, Z), generator=g).cuda()
    xgc = z @ z1_stack[0][0][D:D + Z] + z1_stack[0][1]
    xg_c = torch.randn((B, 2 * Z), generator=g).cuda() @ dec_stack[0][0][:2 * Z] \
        + dec_stack[0][1]

    cases = {
        "lstm2_tm_proj": {
            "z2 encoder": lambda fn, mm: fn(z2_stack, x, None, mm),
            "z1 encoder, xgc tile": lambda fn, mm: fn(z1_stack, x, xgc, mm),
        },
        "lstm2_tm": {
            "decoder, const": lambda fn, mm: fn(dec_stack, xg_c, T, mm),
        },
    }
    results: dict = {}
    for name, forms in cases.items():
        kernel = getattr(lstm_cuda, name)
        plain = getattr(lstm_cuda, name + "_reference")
        for form, call in forms.items():
            refs = {mm: call(plain, mm) for mm in ("float32", "bfloat16")}
            gap = max(max_err(a, b) for a, b in zip(refs["float32"],
                                                    refs["bfloat16"]))
            log(f"{name} [{form}]: plain fp32 vs plain bf16 operands differ "
                f"by {gap:.3e}")
            if not gap > TOL_BF16:
                raise AssertionError(
                    f"{name} [{form}]: the bf16 tolerance {TOL_BF16} would "
                    f"pass a kernel that skipped the bf16 rounding "
                    f"(fp32-vs-bf16 gap {gap})")
            for mm, tol in (("float32", TOL_FP32), ("bfloat16", TOL_BF16)):
                tops_k, h2_k = call(kernel, mm)
                tops_p, h2_p = refs[mm]
                torch.cuda.synchronize()
                err = max(max_err(tops_k, tops_p), max_err(h2_k, h2_p))
                ms = time_ms(lambda: call(kernel, mm))
                plain_ms = time_ms(lambda: call(plain, mm), iters=5)
                log(f"{name} [{form}, {mm}]: max_abs_err {err:.3e} "
                    f"(tol {tol:g}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
                if not err <= tol:
                    raise AssertionError(
                        f"{name} [{form}, {mm}] disagrees with its plain "
                        f"version: {err} > {tol}")
                if mm == "bfloat16":  # the serving mode: keep the heaviest form
                    prev = results.get(name)
                    if prev is None or ms > prev["ms"]:
                        results[name] = {"max_abs_err": max(
                            err, prev["max_abs_err"] if prev else 0.0),
                            "ms": ms, "plain_ms": plain_ms, "form": form}
                    else:
                        prev["max_abs_err"] = max(prev["max_abs_err"], err)

    pz2_logvar = float(np.log(0.5 ** 2))
    for n in (N_TABLE, N_LARGE):
        num_real = n - 7                     # 7 padded rows
        mu2 = torch.randn((n, Z), generator=g)
        seq = torch.randint(0, num_real, (B,), generator=g)
        # z2 near its own sequence's mu2, as a trained encoder puts it
        z2 = (mu2[seq] + 0.5 * torch.randn((B, Z), generator=g)).cuda()
        seq[5] = n + 3                       # an index outside the table
        mu2, seq = mu2.cuda(), seq.cuda()
        k_out = discriminative_log_qy(z2, mu2, seq, pz2_logvar, num_real)
        p_out = discriminative_log_qy_reference(z2, mu2, seq, pz2_logvar,
                                                num_real)
        torch.cuda.synchronize()
        err = max_err(k_out, p_out)
        ms = time_ms(lambda: discriminative_log_qy(z2, mu2, seq, pz2_logvar,
                                                   num_real))
        plain_ms = time_ms(lambda: discriminative_log_qy_reference(
            z2, mu2, seq, pz2_logvar, num_real), iters=5)
        log(f"discriminative_log_qy [N={n}, 7 padded rows, 1 index outside]: "
            f"max_abs_err {err:.3e} (tol {TOL_LOG_QY:g}), kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")
        if not (torch.isfinite(k_out).all() and err <= TOL_LOG_QY):
            raise AssertionError(
                f"discriminative_log_qy at N={n} disagrees with its plain "
                f"version: {err} > {TOL_LOG_QY}")
        if n == N_TABLE:  # the table size the served experiment uses
            results["discriminative_log_qy"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "form": f"N={n}"}
        else:
            results["discriminative_log_qy"]["max_abs_err"] = max(
                results["discriminative_log_qy"]["max_abs_err"], err)
        del mu2, k_out, p_out
        torch.cuda.empty_cache()
    return results


def rel_norm(got, want) -> float:
    """Largest relative Frobenius-norm difference over paired outputs."""
    return max(float((a.float() - b.float()).norm()
                     / b.float().norm().clamp_min(1e-30))
               for a, b in zip(got, want) if b is not None)


def abs_err(got, want) -> float:
    return max(max_err(a, b) for a, b in zip(got, want) if b is not None)


def phase_backward() -> dict:
    """The three backward entries against their plain backward on the card,
    at the training shapes, on the same residuals (from the plain forward)
    and cotangents; two launches compared bitwise."""
    from pytorch_scalablefhvae_tpu_torch.ops import lstm_cuda
    from pytorch_scalablefhvae_tpu_torch.ops.discriminative import (
        _forward_plain,
        discriminative_log_qy_bwd,
        discriminative_log_qy_bwd_reference,
    )

    log(f"== phase 2b: backward kernels against their plain versions "
        f"(T={T} B={B_TRAIN} D={D} H={H})")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((T, B_TRAIN, D), generator=g).cuda()
    z2_stack, z1_stack, dec_stack = (_stack(g, D), _stack(g, D + Z),
                                     _stack(g, 2 * Z))
    xgc = torch.randn((B_TRAIN, Z), generator=g).cuda() \
        @ z1_stack[0][0][D:D + Z] + z1_stack[0][1]
    xg_c = torch.randn((B_TRAIN, 2 * Z), generator=g).cuda() \
        @ dec_stack[0][0][:2 * Z] + dec_stack[0][1]
    g_tops = torch.randn((T, B_TRAIN, H), generator=g).cuda()
    g_h2 = torch.randn((B_TRAIN, H), generator=g).cuda()

    def split(cells):
        (w1, b1), (w2, b2) = cells
        return w1, b1, w1[-H:], w2[:H], w2[H:], b2

    def proj_case(cells, xgc_):
        w1, b1, w1h, w2x, w2h, b2 = split(cells)
        xgc_ = b1.reshape(1, -1) if xgc_ is None else xgc_
        fwd_in = (x, xgc_, w1[:D], w1h, w2x, w2h, b2)

        def run(fn, mm, resid):
            tops, res = resid
            return fn(x, xgc_, res, tops, *fwd_in[2:], g_tops, g_h2, mm)
        return fwd_in, lstm_cuda._proj_forward_plain, run

    def dec_case(cells):
        w1, b1, w1h, w2x, w2h, b2 = split(cells)
        fwd_in = (xg_c, T, w1h, w2x, w2h, b2)

        def run(fn, mm, resid):
            tops, res = resid
            return fn(xg_c, T, res, tops, w1h, w2x, w2h, b2, g_tops, g_h2, mm)
        return fwd_in, lstm_cuda._tm_forward_plain, run

    cases = {
        "lstm2_tm_proj_bwd": {"z2 encoder": proj_case(z2_stack, None),
                              "z1 encoder, xgc tile": proj_case(z1_stack,
                                                                xgc)},
        "lstm2_tm_bwd": {"decoder, const": dec_case(dec_stack)},
    }
    results: dict = {}
    for name, forms in cases.items():
        kernel = getattr(lstm_cuda, name)
        plain = getattr(lstm_cuda, name + "_reference")
        for form, (fwd_in, fwd_plain, run) in forms.items():
            for mm, tol in (("float32", TOL_BWD_FP32),
                            ("bfloat16", TOL_BWD_BF16)):
                tops, _, res = fwd_plain(*fwd_in, mm, with_resid=True)
                resid = (tops, res)
                want = run(plain, mm, resid)
                got = run(kernel, mm, resid)
                again = run(kernel, mm, resid)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)
                           if a is not None):
                    raise AssertionError(f"{name} [{form}, {mm}]: two "
                                         f"launches differ")
                err, aerr = rel_norm(got, want), abs_err(got, want)
                gap = ""
                if mm == "bfloat16":
                    gap32 = rel_norm(run(plain, "float32", resid), want)
                    gap = f"; plain fp32 vs bf16 backward gap {gap32:.3e}"
                    if not gap32 > tol:
                        raise AssertionError(
                            f"{name} [{form}]: the bf16 tolerance {tol} "
                            f"would pass a kernel that rounded elsewhere "
                            f"(gap {gap32})")
                ms = time_ms(lambda: run(kernel, mm, resid))
                plain_ms = time_ms(lambda: run(plain, mm, resid), iters=3,
                                   warmup=1)
                log(f"{name} [{form}, {mm}]: rel-norm err {err:.3e} (tol "
                    f"{tol:g}), max_abs_err {aerr:.3e}{gap}; bitwise repeat "
                    f"ok; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
                if not err <= tol:
                    raise AssertionError(
                        f"{name} [{form}, {mm}] disagrees with its plain "
                        f"backward: {err} > {tol}")
                if mm == "bfloat16":  # the training mode: keep the heaviest
                    prev = results.get(name)
                    if prev is None or ms > prev["ms"]:
                        results[name] = {"max_abs_err": max(
                            aerr, prev["max_abs_err"] if prev else 0.0),
                            "ms": ms, "plain_ms": plain_ms, "form": form}
                    else:
                        prev["max_abs_err"] = max(prev["max_abs_err"], aerr)
            torch.cuda.empty_cache()

    pz2_logvar = float(np.log(0.5 ** 2))
    for n in (N_TABLE, N_LARGE):
        num_real = n - 7                     # 7 padded rows
        mu2 = torch.randn((n, Z), generator=g)
        seq = torch.randint(0, num_real, (B_TRAIN,), generator=g)
        z2 = (mu2[seq] + 0.5 * torch.randn((B_TRAIN, Z), generator=g)).cuda()
        seq[5] = n + 3                       # an index outside the table
        mu2, seq = mu2.cuda(), seq.cuda()
        gq = torch.randn((B_TRAIN,), generator=g).cuda()
        _, lse = _forward_plain(z2, mu2, seq, pz2_logvar, num_real)
        args = (z2, mu2, seq, lse, gq, pz2_logvar, num_real)
        want = discriminative_log_qy_bwd_reference(*args)
        got = discriminative_log_qy_bwd(*args)
        again = discriminative_log_qy_bwd(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"discriminative_log_qy_bwd at N={n}: two "
                                 f"launches differ")
        err = max(max_err(a, b) / float(b.abs().max()) for a, b in
                  zip(got, want))
        aerr = abs_err(got, want)
        padded_zero = bool((got[1][num_real:] == 0).all()
                           and (want[1][num_real:] == 0).all())
        ms = time_ms(lambda: discriminative_log_qy_bwd(*args))
        plain_ms = time_ms(lambda: discriminative_log_qy_bwd_reference(*args),
                           iters=3, warmup=1)
        log(f"discriminative_log_qy_bwd [N={n}, 7 padded rows, 1 index "
            f"outside]: max err / max |ref| {err:.3e} (tol "
            f"{TOL_LOG_QY_BWD:g}), max_abs_err {aerr:.3e}, padded rows "
            f"exactly 0: {padded_zero}; bitwise repeat ok; kernel {ms:.3f} "
            f"ms, plain {plain_ms:.3f} ms")
        if not (err <= TOL_LOG_QY_BWD and padded_zero):
            raise AssertionError(
                f"discriminative_log_qy_bwd at N={n} disagrees with its plain "
                f"backward: {err} > {TOL_LOG_QY_BWD} or padded rows nonzero")
        if n == N_TABLE:
            results["discriminative_log_qy_bwd"] = {
                "max_abs_err": aerr, "ms": ms, "plain_ms": plain_ms,
                "form": f"N={n}"}
        else:
            r = results["discriminative_log_qy_bwd"]
            r["max_abs_err"] = max(r["max_abs_err"], aerr)
        del mu2, want, got, again
        torch.cuda.empty_cache()
    return results


def phase_gather() -> dict:
    """``windowed_chunk_gather`` against its plain version: one dev MAP
    batch (2048 windows in 128 chunks) on two stores; the last two chunks
    are the last sequence's (150 frames), the second of which runs into the
    staged slack and must read zeros there."""
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        STORE_TAIL_SLACK,
    )
    from pytorch_scalablefhvae_tpu_torch.ops.window_gather import (
        windowed_chunk_gather,
        windowed_chunk_gather_reference,
    )

    log(f"== phase 2c: windowed_chunk_gather against its plain version "
        f"(C=128 spb={SPB} seg_len={SEG} stride={SHIFT} D={D})")
    region = (SPB - 1) * SHIFT + SEG
    gen = torch.Generator(device="cuda").manual_seed(2)
    results: dict = {}
    for form, frames in (("100,000-row store", 100_000),
                         ("TIMIT-train-size store", TIMIT_FRAMES)):
        store = torch.zeros((frames + STORE_TAIL_SLACK, D), device="cuda")
        store[:frames] = torch.randn((frames, D), generator=gen,
                                     device="cuda")
        last = frames - 150
        starts = torch.cat([
            torch.randint(0, frames - region, (126,), generator=gen,
                          device="cuda").sort().values,
            torch.tensor([last, last + SPB * SHIFT], device="cuda")])

        def kernel():
            return windowed_chunk_gather(store, starts, SPB, SEG, SHIFT)

        def plain():
            return windowed_chunk_gather_reference(store, starts, SPB, SEG,
                                                   SHIFT)

        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        err = max_err(got, want)
        # windows 3.. of the last chunk start past the frames: all slack
        slack_zero = bool((got[-SPB + 3:] == 0).all())
        if not (torch.equal(got, want) and torch.equal(got, again)
                and slack_zero):
            raise AssertionError(
                f"windowed_chunk_gather [{form}] differs from its plain "
                f"version or between launches (max_abs_err {err}), or read "
                f"nonzero slack ({slack_zero})")
        ms, plain_ms = device_ms(kernel), device_ms(plain)
        call_ms = time_ms(kernel, iters=100, warmup=5)
        plain_call_ms = time_ms(plain, iters=20)
        moved = 128 * (region + SPB * SEG) * D * 4
        log(f"windowed_chunk_gather [{form}]: equal to the plain version and "
            f"between two launches; slack rows read 0; device time per call "
            f"(profiler) kernel {ms:.4f} ms ({moved / ms / 1e6:.1f} GB/s of "
            f"{moved / 1e6:.1f} MB read + written), plain {plain_ms:.4f} ms; "
            f"per call back to back (CUDA events, host issue included) "
            f"kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms")
        if not results:  # the dev MAP shape the report line keeps
            results["windowed_chunk_gather"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "form": f"C=128, {form}"}
        del store, got, again, want
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------- phase 3


@contextmanager
def plain_versions():
    """Route the model through the plain versions (for the reference runs);
    under autograd their Functions run the plain backward."""
    from pytorch_scalablefhvae_tpu_torch.ops import discriminative, lstm_cuda

    saved = (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
             discriminative.discriminative_log_qy)
    lstm_cuda.lstm2_tm_proj = lstm_cuda.lstm2_tm_proj_reference
    lstm_cuda.lstm2_tm = lstm_cuda.lstm2_tm_reference
    discriminative.discriminative_log_qy = \
        discriminative.discriminative_log_qy_reference
    try:
        yield
    finally:
        (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
         discriminative.discriminative_log_qy) = saved


def write_corpus(wav_dir: Path, speakers: int = 40, per_speaker: int = 5,
                 sr: int = 16000, seed: int = 0) -> list[np.ndarray]:
    """Voiced synthetic utterances of 1.0-1.4 s as 16-bit WAVs: a harmonic
    source per speaker (its own f0 and spectral tilt) plus noise. Returns
    the signals as the WAV reader decodes them."""
    rng = np.random.default_rng(seed)
    wav_dir.mkdir(parents=True)
    signals = []
    for s in range(speakers):
        f0, tilt = rng.uniform(85.0, 255.0), rng.uniform(0.5, 0.85)
        for u in range(per_speaker):
            t = np.arange(int(sr * rng.uniform(1.0, 1.4))) / sr
            y = sum(tilt ** h * np.sin(2 * np.pi * f0 * h * t
                                       + rng.uniform(0, 2 * np.pi))
                    for h in range(1, 16))
            y = 0.3 * y / np.abs(y).max() + 0.01 * rng.standard_normal(len(t))
            pcm = np.clip(np.round(y * 32767), -32768, 32767).astype("<i2")
            with wave.open(str(wav_dir / f"s{s:02d}_u{u}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes(pcm.tobytes())
            signals.append(pcm.astype(np.float32) / 32768.0)
    return signals


def make_experiment(root: Path) -> tuple[Path, Path]:
    from pytorch_scalablefhvae_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        ModelConfig,
    )
    from pytorch_scalablefhvae_tpu_torch.eval.encode import _featurize
    from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
    from pytorch_scalablefhvae_tpu_torch.train.checkpoint import save_checkpoint

    wav_dir = root / "wav"
    signals = write_corpus(wav_dir)
    exp = root / "exp"
    exp.mkdir()
    cfg = ExperimentConfig(
        data=DataConfig(dataset="synthetic", mvn_path=str(exp / "mvn.json")),
        model=ModelConfig(model_type="fhvae"))
    cfg.save(exp / "config.json")
    feats = np.concatenate([_featurize(y, 16000, cfg.features)
                            for y in signals])
    (exp / "mvn.json").write_text(json.dumps({
        "mean": [feats.mean(0).tolist()], "std": [feats.std(0).tolist()]}))
    model = FHVAE.from_config(cfg.data.seg_len * cfg.features.n_mels,
                              cfg.model, N_TABLE, feat_dim=cfg.features.n_mels,
                              generator=torch.Generator().manual_seed(0))
    save_checkpoint(exp, model, model_type="fhvae",
                    model_params=model.model_params(), run_info="smoke",
                    epoch=0, best_epoch=0, best_val_lb=0.0, values={},
                    extra_meta={"num_seqs": N_TABLE,
                                "feat_dim": cfg.features.n_mels,
                                "seg_len": cfg.data.seg_len})
    log(f"experiment: {len(signals)} utterances, {len(feats)} frames, "
        f"table {N_TABLE} x {Z}")
    return exp, wav_dir


class Server:
    """The port's ``serve`` loop on a thread, talking over two pipes."""

    def __init__(self, exp: Path):
        from pytorch_scalablefhvae_tpu_torch.eval.serve import serve

        r_in, w_in = os.pipe()
        r_out, w_out = os.pipe()
        self._to = os.fdopen(w_in, "w", buffering=1)
        self._from = os.fdopen(r_out, "r")
        fin, fout = os.fdopen(r_in, "r"), os.fdopen(w_out, "w")
        self.rc: list = []

        def run():
            try:
                self.rc.append(serve(exp, batch_size=B, device="cuda",
                                     stdin=fin, stdout=fout))
            except BaseException as e:  # reported by close()
                self.rc.append(e)
            finally:
                fout.close()
                fin.close()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def read(self) -> dict:
        line = self._from.readline()
        if not line:
            raise RuntimeError(f"server closed its stdout: {self.rc}")
        return json.loads(line)

    def ask(self, text: str) -> tuple[dict, float]:
        t0 = time.perf_counter()
        self._to.write(text + "\n")
        resp = self.read()
        return resp, time.perf_counter() - t0

    def close(self) -> None:
        self._to.close()
        self._thread.join(timeout=60)
        self._from.close()
        if self._thread.is_alive() or self.rc != [0]:
            raise RuntimeError(f"server did not exit cleanly: {self.rc}")


def phase_serve(workdir: Path) -> dict:
    from pytorch_scalablefhvae_tpu_torch.eval.encode import EncodeSession
    from pytorch_scalablefhvae_tpu_torch.ops import discriminative, lstm_cuda

    log("== phase 3: sfhvae serve of the fhvae model on the card")
    exp, wav_dir = make_experiment(workdir)
    t0 = time.perf_counter()
    server = Server(exp)
    ready = server.read()
    log(f"server ready in {time.perf_counter() - t0:.2f} s: {ready}")
    if not (ready.get("ok") and ready.get("model_type") == "fhvae"):
        raise AssertionError(f"bad ready line: {ready}")
    pong, _ = server.ask(json.dumps({"id": "p", "cmd": "ping"}))
    if not (pong.get("ok") and pong.get("batch_size") == B):
        raise AssertionError(f"bad ping response: {pong}")

    entries = (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
               discriminative.discriminative_log_qy)
    for e in entries:
        e.launches = 0
    responses, seconds = [], []
    for i in range(3):
        req = {"id": f"r{i}", "inputs": [str(wav_dir)]}
        if i == 0:
            req["output_dir"] = str(workdir / "served")
        resp, dt = server.ask(json.dumps(req))
        responses.append(resp)
        seconds.append(dt)
    launches = {e.__name__: e.launches for e in entries}
    log(f"launches during the requests: {launches}")

    bad, _ = server.ask("{not json")
    bye, _ = server.ask(json.dumps({"id": "s", "cmd": "shutdown"}))
    server.close()
    if bad.get("ok") is not False or "error" not in bad:
        raise AssertionError(f"malformed request was not refused: {bad}")
    if not bye.get("bye"):
        raise AssertionError(f"bad shutdown response: {bye}")

    n_utts = len(list(wav_dir.glob("*.wav")))
    for i, resp in enumerate(responses):
        if not resp.get("ok"):
            raise AssertionError(f"request r{i} failed: {resp}")
        for key in ("mu2_map", "z1_seq_mean"):
            arr = np.asarray(resp[key], np.float32)
            if arr.shape != (n_utts, Z) or not np.isfinite(arr).all():
                raise AssertionError(
                    f"r{i} {key}: shape {arr.shape}, finite "
                    f"{np.isfinite(arr).all()}")
        if resp["segments"] < B or resp["utterances"] != n_utts:
            raise AssertionError(f"r{i}: {resp['segments']} segments, "
                                 f"{resp['utterances']} utterances")
        for key in ("mu2_map", "z1_seq_mean"):
            if resp[key] != responses[0][key]:
                raise AssertionError(f"r{i} {key} differs from r0")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the requests")

    # the same request through the plain versions on the card, in the
    # served bf16 operand mode and in fp32 (the gap the tolerance must be
    # below)
    session = EncodeSession(exp, batch_size=B, device="cuda")
    with plain_versions():
        ref = session.encode([str(wav_dir)], verbose=False)
        session.model.lstm_mm_dtype = "float32"
        ref32 = session.encode([str(wav_dir)], verbose=False)
    with np.load(workdir / "served" / "latents.npz") as z:
        served = {k: z[k] for k in ("z1_mu", "z2_mu", "mu2_map",
                                    "z1_seq_mean")}
    errs = {k: float(np.abs(served[k] - ref[k]).max()) for k in served}
    gap = max(float(np.abs(ref32[k] - ref[k]).max()) for k in served)
    log(f"served latents vs plain versions on the card: {errs} "
        f"(tol {TOL_SERVED:g}); plain fp32 vs plain bf16 operands differ by "
        f"{gap:.3e}")
    if not gap > TOL_SERVED:
        raise AssertionError(
            f"the served tolerance {TOL_SERVED} would pass a kernel that "
            f"skipped the bf16 rounding (fp32-vs-bf16 gap {gap})")
    if not all(e <= TOL_SERVED for e in errs.values()):
        raise AssertionError(f"served latents disagree: {errs}")

    segs = responses[0]["segments"]
    warm = sorted(seconds[1:])
    p50 = float(np.median(warm))
    log(f"requests: {segs} segments, {n_utts} utterances each; times "
        f"{[round(s, 4) for s in seconds]} s; warm p50 {p50:.4f} s, "
        f"{segs / p50:.1f} segments/s")
    for i, resp in enumerate(responses):
        st = resp["seconds"]
        log(f"r{i} stages (host clock): audio read + features + segmenting "
            f"{st['features']:.4f} s, batches + model + copies "
            f"{st['latents']:.4f} s, summaries {st['summaries']:.4f} s; "
            f"features' share of the request "
            f"{st['features'] / seconds[i]:.3f}")
    return launches


# --------------------------------------------------------------- phase 4


def write_feature_corpus(root: Path, seed: int = 0):
    """A preprocessed synthetic corpus where the port's ``train`` looks for
    one: per-utterance ``.npy`` features (80 mels, 150-350 frames, TIMIT's
    1.5-3.5 s at 100 frames/s) with ``feats.scp`` / ``len.scp``, 4,620
    training and 400 dev sequences (TIMIT's counts). Each sequence has its
    own offset (what z2 should find) over a slowly drifting frame content
    (what z1 should find) and noise. Returns the run's config."""
    from pytorch_scalablefhvae_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        ModelConfig,
    )
    from pytorch_scalablefhvae_tpu_torch.train.driver import split_manifests

    cfg = ExperimentConfig(
        data=DataConfig(dataset="synthetic", mvn_path=str(root / "mvn.json"),
                        training_batch_size=B_TRAIN),
        model=ModelConfig(model_type="fhvae"))
    rng = np.random.default_rng(seed)
    frames = 0
    for split, n in (("train", N_TABLE), ("dev", N_DEV)):
        paths = split_manifests(cfg, root)[split]
        d = paths["feat_pth"].parent
        d.mkdir(parents=True)
        feats, lens = [], []
        for i, n_frames in enumerate(rng.integers(150, 351, n)):
            offset = 2.0 * rng.standard_normal((1, D))
            drift = np.cumsum(0.3 * rng.standard_normal((n_frames, D)), 0)
            x = (offset + drift + 0.5 * rng.standard_normal((n_frames, D))
                 ).astype(np.float32)
            key = f"{split}_{i:05d}"
            np.save(d / f"{key}.npy", x)
            feats.append(f"{key} {d / (key + '.npy')}\n")
            lens.append(f"{key} {n_frames}\n")
            frames += n_frames
        paths["feat_pth"].write_text("".join(feats))
        paths["len_pth"].write_text("".join(lens))
    log(f"feature corpus: {N_TABLE} train + {N_DEV} dev sequences, {frames} "
        f"frames of {D} mels")
    return cfg


def train_entries():
    from pytorch_scalablefhvae_tpu_torch.ops import (
        discriminative,
        lstm_cuda,
        window_gather,
    )

    return (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
            discriminative.discriminative_log_qy, lstm_cuda.lstm2_tm_proj_bwd,
            lstm_cuda.lstm2_tm_bwd, discriminative.discriminative_log_qy_bwd,
            window_gather.windowed_chunk_gather)


def seeded_model(cfg):
    """The model the CLI starts from (seed 0), on the card."""
    from pytorch_scalablefhvae_tpu_torch.models.base import build_model

    return build_model("fhvae", cfg.data.seg_len * D, cfg.model, N_TABLE,
                       feat_dim=D,
                       generator=torch.Generator().manual_seed(0)).cuda()


def first_batches_and_model(cfg, root: Path, n: int):
    """The first ``n`` training batches of epoch 0 on the card, and the
    model the CLI would start from (seed 0)."""
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders
    from pytorch_scalablefhvae_tpu_torch.train.loop import batch_tensors

    dev = torch.device("cuda")
    loader, _ = build_loaders(cfg, root, True)
    loader.set_epoch(0)
    batches = []
    for b in loader:
        batches.append(batch_tensors(b, dev))
        if len(batches) == n:
            break
    return batches, seeded_model(cfg)


def staged_epoch0(cfg, root: Path):
    """The training loader, its store staged on the card, and epoch 0's
    plan there: the device tier's view of the same batches."""
    from pytorch_scalablefhvae_tpu_torch.data.device_store import (
        DeviceDataSource,
    )
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

    loader, _ = build_loaders(cfg, root, True)
    source = DeviceDataSource(loader.dataset.store, torch.device("cuda"))
    loader.set_epoch(0)
    plan, arrays = source.stage_epoch(loader.dataset, loader._order(),
                                      loader.batch_size)
    return loader, source, plan, arrays


def step_breakdown(cfg, root: Path) -> None:
    """Device time of 10 warm train steps, split into forward (to the loss),
    backward and optimizer by CUDA events, and the kernels' share by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_scalablefhvae_tpu_torch.models.base import loss_from_outputs
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
        step_noise,
    )

    dev = torch.device("cuda")
    batches, model = first_batches_and_model(cfg, root, 13)
    state = create_train_state(model)
    opt = make_optimizer(1e-3, 0.95, 0.999)
    stages = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}

    def one_step(batch, timed):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        out = model.apply(*batch[:3], sample=True,
                          noise=step_noise(state, B_TRAIN, dev))
        loss, _ = loss_from_outputs(out, batch[3], 10.0)
        ev[1].record()
        names = list(state.params())
        grads = torch.autograd.grad(loss, list(state.params().values()))
        ev[2].record()
        opt.update(state, dict(zip(names, grads)))
        state.step += 1
        ev[3].record()
        if timed:
            ev[3].synchronize()
            for i, k in enumerate(stages):
                stages[k] += ev[i].elapsed_time(ev[i + 1])

    for b in batches[:3]:
        one_step(b, False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[3:]:
            one_step(b, True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 10
    total = sum(stages.values()) / 10
    log("step breakdown, 10 warm steps at batch 1024 (CUDA events, ms/step): "
        + ", ".join(f"{k} {v / 10:.3f}" for k, v in stages.items())
        + f"; events total {total:.3f}, host wall {wall:.3f}")
    rows = [(e.key, e.device_time_total / 1e3 / 10, e.count // 10)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"profiler: device busy {busy:.3f} ms of {wall:.3f} ms per step "
        f"(idle share {1 - busy / wall:.3f}); by kernel (ms/step, "
        f"launches/step):")
    for key, ms, n in rows[:14]:
        log(f"  {ms:8.3f} {n:4d}  {key[:90]}")


def compare_first_steps(cfg, root: Path) -> None:
    """Three train steps from one initial state and the same noise, through
    the kernels and through the plain versions (whose autograd Functions run
    the plain backward) on the card."""
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
        train_step,
    )

    batches, model = first_batches_and_model(cfg, root, 3)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    runs = {}
    for path in ("kernels", "plain"):
        state = create_train_state(copy.deepcopy(model))
        opt = make_optimizer(1e-3, 0.95, 0.999)
        with plain_versions() if path == "plain" else nullcontext():
            losses = [float(train_step(state, opt, *b, 10.0)["loss"])
                      for b in batches]
        runs[path] = (losses, {n: p.detach() for n, p in
                               state.model.named_parameters()})
    (lk, pk), (lp, pp) = runs["kernels"], runs["plain"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    upd_err = max(float((pk[n] - pp[n]).norm()
                        / (pp[n] - start[n]).norm().clamp_min(1e-30))
                  for n in start)
    log(f"first 3 steps, kernels vs plain on the card: losses {lk} vs {lp} "
        f"(max rel diff {loss_err:.3e}, tol {TOL_TRAIN_LOSS:g}); parameter "
        f"updates differ by {upd_err:.3e} of their norm (tol "
        f"{TOL_TRAIN_UPDATE:g})")
    if not (loss_err <= TOL_TRAIN_LOSS and upd_err <= TOL_TRAIN_UPDATE):
        raise AssertionError("the kernel path's first train steps disagree "
                             "with the plain versions'")


def compare_tiers_first_steps(cfg, root: Path) -> None:
    """Three train steps through the kernels from one initial state and the
    same noise, fed by the host loader and gathered from the staged store:
    the same batches, so the same bits."""
    from pytorch_scalablefhvae_tpu_torch.train.device_step import (
        device_train_step,
    )
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
        train_step,
    )

    batches, model = first_batches_and_model(cfg, root, 3)
    _, source, plan, arrays = staged_epoch0(cfg, root)
    runs = {}
    for tier in ("host", "device"):
        state = create_train_state(copy.deepcopy(model))
        opt = make_optimizer(1e-3, 0.95, 0.999)
        if tier == "host":
            losses = [float(train_step(state, opt, *b, 10.0)["loss"])
                      for b in batches]
        else:
            losses = [float(device_train_step(
                state, opt, source.data, arrays, i * B_TRAIN, plan.n_real,
                10.0, batch_size=B_TRAIN, seg_len=cfg.data.seg_len)["loss"])
                for i in range(3)]
        runs[tier] = (losses, state)
    (lh, sh), (ld, sd) = runs["host"], runs["device"]
    same = lh == ld and all(
        torch.equal(a, b) for a, b in zip(
            [*sh.params().values(), *sh.mu.values(), *sh.nu.values()],
            [*sd.params().values(), *sd.mu.values(), *sd.nu.values()]))
    log(f"first 3 steps, device tier vs host loader on the card (kernels): "
        f"losses {ld} vs {lh}; parameters and Adam moments equal bit for "
        f"bit: {same}")
    if not same:
        raise AssertionError("the device tier's first train steps differ "
                             "from the host loader's")
    del source, arrays
    torch.cuda.empty_cache()


def check_dev_pass(cfg, root: Path) -> None:
    """The staged dev split's pass at the seeded model (the chunked MAP pass
    through ``windowed_chunk_gather``, then the eval pass): two runs give
    the same bits, and it agrees with the host loader's dev pass."""
    from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders
    from pytorch_scalablefhvae_tpu_torch.train.loop import (
        dev_pass,
        device_dev_pass,
        stage_split,
    )

    dev = torch.device("cuda")
    _, dev_loader = build_loaders(cfg, root, True)
    split = stage_split(dev_loader, dev)
    if split.chunked is None:
        raise AssertionError("the dev split's MAP pass is not the chunked one")
    model = seeded_model(cfg)
    runs, seconds = [], []
    for fn in (lambda: device_dev_pass(model, split, 10.0),
               lambda: device_dev_pass(model, split, 10.0),
               lambda: dev_pass(model, dev_loader, 10.0, dev)):
        t0 = time.perf_counter()
        runs.append(fn())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    a, b, host = runs
    err = max(abs(a[k] - host[k]) / abs(host[k]) for k in host)
    log(f"dev pass at the seeded model: staged split (chunked MAP) "
        f"{seconds[0]:.3f} / {seconds[1]:.3f} s, two runs equal bit for bit: "
        f"{a == b}; host loader {seconds[2]:.3f} s; largest relative "
        f"difference of a metric {err:.3e} (tol {TOL_DEV_LB:g}); LB "
        f"{a['lower_bound']!r} vs {host['lower_bound']!r}")
    if a != b or not err <= TOL_DEV_LB:
        raise AssertionError("the staged dev pass does not repeat or "
                             "disagrees with the host dev pass")
    del split
    torch.cuda.empty_cache()


def tier_breakdown(cfg, root: Path) -> None:
    """Each tier's data path and step, as the epoch runners drive them: the
    host loader's pinned copy and a loss sync every step, against the
    on-card gather and a loss check one step late. 10 warm steps each:
    CUDA events per stage, host wall, and the device's busy and idle share
    by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_scalablefhvae_tpu_torch.models.base import loss_from_outputs
    from pytorch_scalablefhvae_tpu_torch.train.device_step import batch_views
    from pytorch_scalablefhvae_tpu_torch.train.loop import batch_tensors
    from pytorch_scalablefhvae_tpu_torch.train.step import (
        create_train_state,
        make_optimizer,
        step_noise,
    )

    dev = torch.device("cuda")
    loader, source, plan, arrays = staged_epoch0(cfg, root)
    model = seeded_model(cfg)
    for tier in ("host", "device"):
        state = create_train_state(copy.deepcopy(model))
        opt = make_optimizer(1e-3, 0.95, 0.999)
        batches = iter(loader)

        def one_step(i):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            if tier == "host":
                feats, seq, nsegs, w = batch_tensors(next(batches), dev)
            else:
                feats, seq, nsegs, w = batch_views(
                    source.data, *arrays, i * B_TRAIN, plan.n_real,
                    batch_size=B_TRAIN, seg_len=cfg.data.seg_len)
            ev[1].record()
            out = state.model.apply(feats, seq, nsegs, sample=True,
                                    noise=step_noise(state, B_TRAIN, dev))
            loss, _ = loss_from_outputs(out, w, 10.0)
            ev[2].record()
            names = list(state.params())
            grads = torch.autograd.grad(loss, list(state.params().values()))
            ev[3].record()
            opt.update(state, dict(zip(names, grads)))
            state.step += 1
            ev[4].record()
            return loss.detach(), ev

        for i in range(3):
            float(one_step(i)[0])
        torch.cuda.synchronize()
        events, pending = [], None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(3, 13):
                loss, ev = one_step(i)
                events.append(ev)
                if tier == "host":
                    float(loss)
                else:
                    if pending is not None:
                        float(pending)
                    pending = loss
            if pending is not None:
                float(pending)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 10
        batches.close()
        stages = {k: sum(ev[j].elapsed_time(ev[j + 1]) for ev in events) / 10
                  for j, k in enumerate(("data", "forward", "backward",
                                         "optimizer"))}
        busy = sum(e.device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) \
            / 1e3 / 10
        log(f"{tier} tier, 10 warm steps at batch 1024 with its data path "
            f"(CUDA events, ms/step): "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
            + f"; host wall {wall:.3f}; profiler: device busy {busy:.3f} ms "
            f"(idle share {1 - busy / wall:.3f}); {B_TRAIN / wall * 1e3:.1f} "
            f"segments/s")
    del source, arrays
    torch.cuda.empty_cache()


class _Tee(io.TextIOBase):
    """Write to every stream given (a run's stdout, kept and shown)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)
        return len(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def run_cli(cli, args) -> str:
    """Run the port's CLI; fails when it exits non-zero. Returns its stdout."""
    out = io.StringIO()
    with redirect_stdout(_Tee(sys.stdout, out)):
        rc = cli(args)
    if rc != 0:
        raise AssertionError(f"train {' '.join(args[-4:])} exited {rc}")
    return out.getvalue()


def phase_train(workdir: Path) -> dict:
    from pytorch_scalablefhvae_tpu_torch.cli.main import main as cli
    from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt

    log("== phase 4: sfhvae train of the fhvae model on the card (CLI "
        "defaults, batch 1024)")
    root = workdir / "data"
    t0 = time.perf_counter()
    cfg = write_feature_corpus(root)
    log(f"corpus written in {time.perf_counter() - t0:.1f} s")
    compare_first_steps(cfg, root)
    compare_tiers_first_steps(cfg, root)
    check_dev_pass(cfg, root)
    step_breakdown(cfg, root)
    tier_breakdown(cfg, root)

    exp_root = workdir / "experiments"
    args = ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(root), "--mvn-path", cfg.data.mvn_path,
            "--exp-root", str(exp_root)]
    entries = train_entries()
    for e in entries:
        e.launches = 0
    t0 = time.perf_counter()
    out = run_cli(cli, args + ["--epochs", "2"])
    exp = exp_root / "synthetic_np_fbank" / "fhvae_e2_p10_a10.0"
    last = exp / "fhvae_synthetic_np_fbank_e1.npz"
    out += run_cli(cli, args + ["--continue-from", str(last),
                                "--resume-override", "epochs=3"])
    seconds = time.perf_counter() - t0
    launches = {e.__name__: e.launches for e in entries}
    log(f"launches during training (2 epochs + 1 resumed, dev passes "
        f"included): {launches}")
    for line in ("Training data device-resident", "Dev split device-resident"):
        if out.count(line) != 2:
            raise AssertionError(f"the default train runs did not log "
                                 f"{line!r} once each")

    recs = [json.loads(line) for line in
            (exp / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss"] for r in recs]
    steps = [ckpt.read_checkpoint_meta(
        exp / f"fhvae_synthetic_np_fbank_e{e}.npz")["step"] for e in range(3)]
    for r in recs:
        log(f"epoch {r['epoch']}: train loss {r['train_loss']:.4f}, "
            f"{r['train_steps']} steps in {r['train_seconds']:.3f} s = "
            f"{r['train_steps'] / r['train_seconds']:.2f} steps/s, "
            f"{r['train_segments_per_sec']:.1f} segments/s, "
            f"{1e3 * r['train_seconds'] / r['train_steps']:.2f} ms/step; dev "
            f"LB {r['val_lower_bound']:.4f}, log_qy {r['val_log_qy']:.4f}")
    log(f"checkpoint steps {steps}; 3 epochs took {seconds:.1f} s "
        f"end to end (loading, dev passes and checkpoints included); card "
        f"{smi_name_power()}")
    if [r["epoch"] for r in recs] != [0, 1, 2]:
        raise AssertionError(f"epochs recorded: {[r['epoch'] for r in recs]}")
    if not (all(np.isfinite(losses)) and losses[1] < losses[0]
            and np.isfinite(recs[-1]["val_lower_bound"])):
        raise AssertionError(f"train losses {losses} are not finite and "
                             f"falling")
    n = recs[0]["train_steps"]
    if steps != [n, 2 * n, 3 * n]:
        raise AssertionError(f"the resumed run did not continue the step "
                             f"count: {steps}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched by training")

    # one epoch from the host loader: the same batches, so the same loss
    host_root = workdir / "experiments_host"
    out = run_cli(cli, args[:-1] + [str(host_root), "--data-placement",
                                    "host", "--epochs", "1"])
    if "device-resident" in out:
        raise AssertionError("--data-placement host staged data on the card")
    host = json.loads((host_root / "synthetic_np_fbank" / "fhvae_e1_p10_a10.0"
                       / "metrics.jsonl").read_text().splitlines()[0])
    lb_err = abs(host["val_lower_bound"] - recs[0]["val_lower_bound"]) \
        / abs(host["val_lower_bound"])
    log(f"epoch 0, device tier vs host loader: train loss "
        f"{recs[0]['train_loss']!r} vs {host['train_loss']!r}; dev LB "
        f"{recs[0]['val_lower_bound']!r} vs {host['val_lower_bound']!r} "
        f"(relative difference {lb_err:.3e}, tol {TOL_DEV_LB:g}); segments/s "
        f"{recs[0]['train_segments_per_sec']:.1f} (device tier) vs "
        f"{host['train_segments_per_sec']:.1f} (host loader), card "
        f"{smi_name_power()}")
    if host["train_loss"] != recs[0]["train_loss"] or not lb_err <= TOL_DEV_LB:
        raise AssertionError("the host loader's epoch 0 disagrees with the "
                             "device tier's")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a GPU", file=sys.stderr)
        return 1
    phase_environment()
    results = phase_kernels()
    results.update(phase_backward())
    results.update(phase_gather())
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        by_path = {"serve": phase_serve(workdir),
                   "train": phase_train(workdir)}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = []
    for name, r in results.items():
        source, replaces = SOURCES[name]
        counts = {path: c[name] for path, c in by_path.items() if name in c}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(counts.values()),
            "launches_by_path": counts, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "form": r["form"]})
    print(smi_name_power())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
