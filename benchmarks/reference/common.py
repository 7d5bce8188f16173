"""The plain reference's shared pieces: precision modes, Gaussian layers,
the ELBO, the discriminative term, the loss, the clipped Adam step, the
segment index, the batch order (the loader's, and the streamed tier's
chunks and schedule), the hierarchical round's draw and the MAP table.

Plain PyTorch in float32 with TF32 off, written from the model's published
description (Hsu & Glass, "Scalable Factorized Hierarchical Variational
Autoencoder Training", Interspeech 2018; BurnhamG/PyTorch-ScalableFHVAE) and
from the training path's documented schedules (the loader's permutation, the
streamed tier's chunk partition and visit order, the round's draw, each
step's noise seed). It imports nothing of the measured
program and nothing of JAX: the benchmark hands it the same corpus and the
same initial weights it hands the program.

Parameters are a dict ``name -> tensor`` with the checkpoint layout the
program reads and writes: a dense layer ``x @ w + b`` with ``w [d_in,
d_out]``; an LSTM cell one ``w [d_in + H, 4H]`` with the input rows first and
gate order i, f, g, o.

An operand ``kind`` picks the precision of a matrix product: ``fp32`` is
the reference's; the controls round operands one step below what a
configuration states (``tf32`` for float32 with TF32 off, ``fp8`` for
bfloat16), and ``bf16`` is the configuration's own LSTM operand type.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LOGVAR_BOUND = 9.0
LOG_2PI = math.log(2.0 * math.pi)
FP8_MAX = 448.0


def set_exact_float32() -> None:
    """Float32 matrix products and convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its mantissa rounded to TF32's 10 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_operand(x: torch.Tensor, kind: str) -> torch.Tensor:
    """A matrix product's operand as ``kind`` holds it, back in float32;
    the gradient passes through the rounding unchanged."""
    if kind == "fp32":
        return x
    with torch.no_grad():
        if kind == "tf32":
            q = round_tf32(x)
        elif kind == "bf16":
            q = x.to(torch.bfloat16).float()
        elif kind == "fp8":
            q = x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float()
        else:
            raise ValueError(f"unknown operand precision {kind!r}")
    return x + (q - x).detach()


def matmul(a: torch.Tensor, w: torch.Tensor, kind: str = "fp32"):
    return round_operand(a, kind) @ round_operand(w, kind)


def dense(params: dict, prefix: str, x: torch.Tensor, kind: str = "fp32"):
    return matmul(x, params[prefix + ".w"], kind) + params[prefix + ".b"]


def gauss_head(params: dict, prefix: str, h: torch.Tensor, eps=None,
               kind: str = "fp32"):
    """``(mu, logvar, z)``: logvar bounded to +-9 by a tanh; ``z = mu + eps
    exp(logvar / 2)`` with noise ``eps``, else ``mu``."""
    mu = dense(params, prefix + ".mu", h, kind)
    logvar = LOGVAR_BOUND * torch.tanh(
        dense(params, prefix + ".logvar", h, kind) / LOGVAR_BOUND)
    z = mu if eps is None else mu + eps * torch.exp(0.5 * logvar)
    return mu, logvar, z


def log_gauss(x, mu, logvar):
    return -0.5 * (LOG_2PI + logvar + (x - mu) ** 2 / torch.exp(logvar))


def kld(p_mu, p_logvar, q_mu, q_logvar):
    """KL(N(p_mu, e^p_logvar) || N(q_mu, e^q_logvar)), elementwise."""
    return 0.5 * (q_logvar - p_logvar
                  + (torch.exp(p_logvar) + (p_mu - q_mu) ** 2)
                  / torch.exp(q_logvar) - 1.0)


def elbo_terms(x, x_mu, x_logvar, enc: dict, mu2, nsegs, pz2_std: float):
    """Per-segment ELBO terms over ``x [B, T, F]``: ``log p(x|z) -
    KL(q(z1)||N(0, I)) - KL(q(z2)||N(mu2, pz2_std^2 I)) + log p(mu2) /
    nsegs``."""
    zero = torch.zeros((), device=x.device)
    pz2_logvar = torch.full((), 2.0 * math.log(pz2_std), device=x.device)
    log_px_z = log_gauss(x, x_mu, x_logvar).sum(dim=(1, 2))
    neg_kld_z1 = -kld(enc["z1_mu"], enc["z1_logvar"], zero, zero).sum(-1)
    neg_kld_z2 = -kld(enc["z2_mu"], enc["z2_logvar"], mu2, pz2_logvar).sum(-1)
    log_pmu2 = log_gauss(mu2, zero, zero).sum(-1)
    lower_bound = log_px_z + neg_kld_z1 + neg_kld_z2 + log_pmu2 / nsegs
    return {"lower_bound": lower_bound, "log_px_z": log_px_z,
            "neg_kld_z1": neg_kld_z1, "neg_kld_z2": neg_kld_z2,
            "log_pmu2": log_pmu2}


def log_qy(z2_mu, table, seq_idx, pz2_std: float):
    """The discriminative ``log q(y | z2) = log softmax_n(-|z2 - mu2_n|^2 /
    (2 pz2_std^2))`` at each row's own sequence."""
    d2 = ((z2_mu[:, None, :] - table[None, :, :]) ** 2).sum(-1)
    logits = -d2 / (2.0 * pz2_std ** 2)
    return (logits.gather(1, seq_idx.long()[:, None])[:, 0]
            - torch.logsumexp(logits, dim=-1))


def training_loss(out: dict, weight, alpha: float):
    """``-mean(lower_bound + alpha * log_qy)`` over the rows of weight 1."""
    return -((out["lower_bound"] + alpha * out["log_qy"]) * weight).sum() \
        / weight.sum().clamp(min=1.0)


def step_noise(seed: int, step: int, batch: int, z1_dim: int, z2_dim: int,
               device) -> dict:
    """A step's reparameterization noise: the training path seeds a
    generator on the device with ``(seed mod 2^32) * 2^32 + step`` and draws
    z2's noise, then z1's."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    eps2 = torch.randn((batch, z2_dim), generator=g, device=device)
    eps1 = torch.randn((batch, z1_dim), generator=g, device=device)
    return {"z2": eps2, "z1": eps1}


class Adam:
    """A global-norm clip at ``clip`` (every gradient scaled by ``clip /
    norm`` once the norm reaches it), then Adam with bias-corrected moments,
    all in float32."""

    def __init__(self, params: dict, lr: float, b1: float, b2: float,
                 clip: float, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.clip, self.eps = lr, b1, b2, clip, eps
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> dict:
        """One update in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = 1.0 if float(norm) < self.clip else self.clip / float(norm)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        clipped = {}
        for n, p in params.items():
            g = grads[n] * scale
            clipped[n] = g
            self.mu[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[n].mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            p.sub_(self.lr * (self.mu[n] / c1)
                   / (torch.sqrt(self.nu[n] / c2) + self.eps))
        return clipped


def glorot_limit(name: str, shape: tuple) -> float | None:
    """The bound of a weight's Glorot-uniform draw, ``sqrt(6 / (fan_in +
    fan_out))`` (an LSTM cell's ``w [d_in + H, 4H]`` counts ``d_in + H +
    4H``); ``None`` for a bias or the mu2 table."""
    if not name.endswith(".w"):
        return None
    return math.sqrt(6.0 / (shape[0] + shape[1]))


def bias_init(name: str, shape: tuple) -> torch.Tensor:
    """A bias's initial value: zeros, and 1.0 on an LSTM cell's forget-gate
    slice."""
    b = torch.zeros(shape)
    if ".cells." in name:
        h = shape[0] // 4
        b[h:2 * h] = 1.0
    return b


# ------------------------------------------------------------- the data


def segment_index(lens: np.ndarray, seg_len: int, seg_shift: int):
    """Every window of ``seg_len`` frames at stride ``seg_shift``, sequence
    by sequence: ``(seq_of_window, start_within_sequence, nsegs)``."""
    lens = np.asarray(lens, np.int64)
    nsegs = np.where(lens >= seg_len, (lens - seg_len) // seg_shift + 1, 0)
    seq = np.repeat(np.arange(len(lens)), nsegs)
    first = np.concatenate([[0], np.cumsum(nsegs)[:-1]])
    start = (np.arange(len(seq)) - np.repeat(first, nsegs)) * seg_shift
    return seq, start, nsegs


def epoch_order(n_windows: int, loader_seed: int, epoch: int) -> np.ndarray:
    """The training loader's shuffled order of an epoch."""
    rng = np.random.default_rng(loader_seed + 1_000_003 * epoch)
    return rng.permutation(n_windows)


def stream_chunks(lens: np.ndarray, nsegs: np.ndarray, row_bytes: int,
                  chunk_bytes: int) -> list:
    """The streamed tier's chunks: sequences in store order, a chunk closed
    where the next sequence would take it past ``chunk_bytes`` (rows of
    ``row_bytes``), so each chunk is whole sequences, one run of frames and
    one run of windows. Each chunk is ``(frame_base, n_frames, seg_lo,
    seg_hi)``."""
    lens = np.asarray(lens, np.int64)
    max_rows = max(chunk_bytes // row_bytes, 1)
    frame_at = np.concatenate([[0], np.cumsum(lens)])
    seg_at = np.concatenate([[0], np.cumsum(np.asarray(nsegs, np.int64))])
    chunks, lo = [], 0
    while lo < len(lens):
        hi = lo
        while hi < len(lens) and frame_at[hi + 1] - frame_at[lo] <= max_rows:
            hi += 1
        if hi == lo:
            raise ValueError(f"sequence {lo} has more frames than a chunk "
                             f"holds ({max_rows})")
        chunks.append((int(frame_at[lo]), int(frame_at[hi] - frame_at[lo]),
                       int(seg_at[lo]), int(seg_at[hi])))
        lo = hi
    return chunks


def stream_schedule(chunks: list, loader_seed: int, epoch: int) -> list:
    """The streamed tier's order of an epoch: one generator seeded as the
    loader's shuffle of that epoch draws the chunks' visit order, then,
    chunk by chunk in that order, a permutation of the chunk's windows.
    ``[(chunk, window indices)]`` in the order trained."""
    rng = np.random.default_rng(loader_seed + 1_000_003 * epoch)
    out = []
    for c in rng.permutation(len(chunks)):
        _, _, lo, hi = chunks[c]
        out.append((int(c), lo + rng.permutation(hi - lo)))
    return out


def round_draw(keys: list, k: int, seed: int, e0: int) -> list:
    """The keys of the hierarchical round that starts at epoch ``e0``."""
    rng = np.random.default_rng((seed + 23) * 1_000_003 + e0)
    return list(rng.choice(keys, size=k, replace=False))


def chunk_skip_windows(nsegs: np.ndarray, spb: int, skip: int) -> np.ndarray:
    """Whether each window (sequence-major) is one that a round's MAP init
    reads: window ``j`` of its sequence when ``(j // spb) % skip == 0``."""
    j = np.concatenate([np.arange(n) for n in nsegs]) if len(nsegs) else \
        np.zeros(0, np.int64)
    return (j // spb) % skip == 0


class Split:
    """A split as the reference reads it: the frames of each sequence in
    ``frames [total, F]`` (one host array), their offsets and lengths."""

    def __init__(self, frames: np.ndarray, offsets: np.ndarray,
                 lens: np.ndarray, seg_len: int, seg_shift: int):
        self.frames, self.offsets = frames, np.asarray(offsets, np.int64)
        self.lens = np.asarray(lens, np.int64)
        self.seg_len, self.seg_shift = seg_len, seg_shift
        self.seq, self.start, self.nsegs = segment_index(self.lens, seg_len,
                                                         seg_shift)

    def subset(self, rows: np.ndarray) -> "Split":
        """The sequences ``rows``, in that order (a round's sub-corpus)."""
        rows = np.asarray(rows, np.int64)
        return Split(self.frames, self.offsets[rows], self.lens[rows],
                     self.seg_len, self.seg_shift)

    def windows(self, idx: np.ndarray, device) -> tuple:
        """``(x [n, seg_len, F], seq [n], nsegs [n])`` of windows ``idx``."""
        idx = np.asarray(idx, np.int64)
        seq = self.seq[idx]
        first = self.offsets[seq] + self.start[idx]
        rows = first[:, None] + np.arange(self.seg_len)[None, :]
        x = torch.from_numpy(np.ascontiguousarray(self.frames[rows]))
        return (x.to(device), torch.from_numpy(seq).to(device),
                torch.from_numpy(self.nsegs[seq].astype(np.float32))
                .to(device))


def map_table(encode_z2, split: Split, keep: np.ndarray | None, rows: int,
              pz2_var: float, device, batch: int = 2048) -> torch.Tensor:
    """The MAP estimate of each sequence's mu2, ``sum(z2 means of its
    windows) / (count + pz2_var)`` (prior N(0, I)), over the windows
    ``keep`` selects (all by default), sums in float64; ``rows`` rows."""
    idx = np.arange(len(split.seq)) if keep is None else np.flatnonzero(keep)
    sums = torch.zeros((rows, 0), dtype=torch.float64, device=device)
    counts = torch.zeros(rows, dtype=torch.float64, device=device)
    for at in range(0, len(idx), batch):
        x, seq, _ = split.windows(idx[at:at + batch], device)
        z2 = encode_z2(x).double()
        if sums.shape[1] == 0:
            sums = torch.zeros((rows, z2.shape[1]), dtype=torch.float64,
                               device=device)
        sums.index_add_(0, seq, z2)
        counts.index_add_(0, seq, torch.ones_like(seq, dtype=torch.float64))
    return (sums / (counts + pz2_var)[:, None]).float()


def dev_lower_bound(model, params: dict, split: Split, device,
                    batch: int = 2048, kind: dict | None = None) -> float:
    """The dev lower bound of ``params``: each dev sequence's mu2 is its MAP
    estimate from the z2 encoder's means, then the mean lower bound of every
    window with the posterior means for z1 and z2 (float64 sum)."""
    pz2_var = model.cfg["pz2_std"] ** 2
    with torch.no_grad():
        table = map_table(lambda x: model.encode_z2(params, x, kind), split,
                          None, len(split.lens), pz2_var, device, batch)
        total, count = 0.0, 0
        for at in range(0, len(split.seq), batch):
            idx = np.arange(at, min(at + batch, len(split.seq)))
            x, seq, nsegs = split.windows(idx, device)
            out = model.forward(params, x, seq, nsegs, table, None, kind)
            total += float(out["lower_bound"].double().sum())
            count += len(idx)
    return total / count
