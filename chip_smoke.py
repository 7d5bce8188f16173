#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one GPU and check it.

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
   on the card.

The bf16 tolerances sit between the kernels' error and the gap between the
plain versions in fp32 and in bf16 operand mode, which each run measures: a
kernel that skipped the bf16 rounding would fail them, and the script raises
if that gap ever falls below a tolerance. It imports only the port, never
the JAX package.

The second-to-last line of stdout is a JSON object with one entry per
kernel entry; the line before it is nvidia-smi's name and power limit; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import wave
from contextlib import contextmanager
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
SOURCES = {
    "lstm2_tm_proj": ("pytorch_scalablefhvae_tpu_torch/csrc/lstm2_fwd.cu",
                      "pytorch_scalablefhvae_tpu/ops/lstm_pallas.py:675"),
    "lstm2_tm": ("pytorch_scalablefhvae_tpu_torch/csrc/lstm2_fwd.cu",
                 "pytorch_scalablefhvae_tpu/ops/lstm_pallas.py:741"),
    "discriminative_log_qy": (
        "pytorch_scalablefhvae_tpu_torch/csrc/discriminative_fwd.cu",
        "pytorch_scalablefhvae_tpu/ops/discriminative.py:234"),
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


# --------------------------------------------------------------- phase 3


@contextmanager
def plain_versions():
    """Route the model through the plain versions (for the reference run)."""
    from pytorch_scalablefhvae_tpu_torch.ops import discriminative, lstm_cuda

    saved = (lstm_cuda.lstm2_tm_proj, lstm_cuda.lstm2_tm,
             discriminative.discriminative_log_qy)
    lstm_cuda.lstm2_tm_proj = (
        lambda cells, x, xgc=None, mm_dtype="float32", with_tops=True:
        lstm_cuda.lstm2_tm_proj_reference(cells, x, xgc, mm_dtype))
    lstm_cuda.lstm2_tm = (
        lambda cells, xg1, T=None, mm_dtype="float32", with_tops=True:
        lstm_cuda.lstm2_tm_reference(cells, xg1, T, mm_dtype))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a GPU", file=sys.stderr)
        return 1
    phase_environment()
    results = phase_kernels()
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        launches = phase_serve(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = []
    for name, r in results.items():
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"]})
    print(smi_name_power())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
