"""Disentanglement probes: counterpart of ``eval/probes.py``.

A multinomial logistic-regression probe over the per-segment posterior
means of ``eval/latents.py``: z2 should predict the speaker, z1 should not
(arXiv 1709.07902 §5). The split and the standardisation are the JAX
package's numpy code; the fit is 300 full-batch AdamW steps in plain torch
on the device given, written out in optax's order (``optax.adamw``:
``p += -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``).
``torch.optim.AdamW`` decays ``p`` before the Adam step, in another
rounding order, so it is not used. ``default_speaker_of`` and ``json_safe``
are this package's copies of the JAX module's host code, which imports jax.
"""

from __future__ import annotations

import numpy as np
import torch


def default_speaker_of(seq_key: str) -> str:
    """Speaker id from an utterance key.

    TIMIT/synthetic keys are ``<spk>_<utt>`` (preprocess_timit.py:56);
    LibriSpeech uids are ``<spk>-<chapter>-<utt>``.
    """
    if "_" in seq_key:
        return seq_key.split("_")[0]
    return seq_key.split("-")[0]


def json_safe(obj):
    """Replace non-finite floats with None, recursively.

    ``json.dumps`` emits the non-standard ``NaN`` token for such floats —
    invalid JSON that jq / JSON.parse / strict parsers reject — so every
    probe/metrics artifact writer passes its payload through this first.
    """
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def probe_split(n: int, train_frac: float, seed: int,
                groups: np.ndarray | None, overlap_gap: int):
    """Train and test indices, as the JAX probe draws them: with ``groups``
    each utterance splits temporally (a train prefix, ``overlap_gap``
    dropped boundary segments, the test tail; too short to split leak-free:
    all train), else a seeded random split."""
    rng = np.random.default_rng(seed)
    if groups is not None and n:
        g = np.asarray(groups)
        tr_list, te_list = [], []
        for gval in np.unique(g):
            idx = np.flatnonzero(g == gval)
            m = len(idx)
            # the test tail first (at least one segment), then the guard gap
            te_start = m - max(int(m * (1.0 - train_frac)), 1)
            tr_end = te_start - overlap_gap
            if tr_end <= 0:
                tr_list.append(idx)
                continue
            tr_list.append(idx[:tr_end])
            te_list.append(idx[te_start:])
        tr = np.concatenate(tr_list) if tr_list else np.zeros(0, np.int64)
        te = np.concatenate(te_list) if te_list else np.zeros(0, np.int64)
        return tr, te
    order = rng.permutation(n)
    n_train = max(int(n * train_frac), 1)
    return order[:n_train], order[n_train:]


def _fit(x: torch.Tensor, y: torch.Tensor, n_classes: int, steps: int,
         lr: float, weight_decay: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    """``steps`` full-batch AdamW steps on the mean softmax cross-entropy
    from zero weights; returns ``(w, b)``. The gradient is written out as
    JAX differentiates ``optax.softmax_cross_entropy_with_integer_labels``:
    ``dlogits = exp(l - max) * (g / sum) - onehot * g`` with ``g = 1 / n``."""
    n, d = x.shape
    w = x.new_zeros((d, n_classes))
    b = x.new_zeros((n_classes,))
    params = [w, b]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    onehot = torch.nn.functional.one_hot(y.long(), n_classes).to(x.dtype)
    one = np.float32(1.0)
    g_mean = float(one / np.float32(max(n, 1)))
    for count in range(1, steps + 1):
        logits = x @ w + b
        e = torch.exp(logits - logits.max(-1, keepdim=True).values)
        dlogits = e * (g_mean / e.sum(-1, keepdim=True)) - onehot * g_mean
        grads = [x.T @ dlogits, dlogits.sum(0)]
        bc1 = float(one - np.float32(b1) ** np.int32(count))
        bc2 = float(one - np.float32(b2) ** np.int32(count))
        for i, (p, g) in enumerate(zip(params, grads)):
            mu[i] = (1 - b1) * g + b1 * mu[i]
            nu[i] = (1 - b2) * (g * g) + b2 * nu[i]
            update = (mu[i] / bc1) / (torch.sqrt(nu[i] / bc2) + eps)
            params[i] = p + (update + weight_decay * p) * -lr
        w, b = params
    return w, b


def linear_probe_accuracy(
    feats: np.ndarray,
    labels: np.ndarray,
    train_frac: float = 0.8,
    seed: int = 0,
    steps: int = 300,
    lr: float = 0.05,
    weight_decay: float = 1e-4,
    groups: np.ndarray | None = None,
    overlap_gap: int = 2,
    device: torch.device | str = "cpu",
) -> dict:
    """Train a multinomial logistic-regression probe on ``device``; report
    accuracies.

    ``groups`` (the owning utterance of each segment, in loader order):
    each utterance splits temporally, so no test frame appears in training
    (segments are overlapping windows; a random segment split would score
    frame memorization). Standardisation uses train-split statistics only.
    """
    n, d = feats.shape
    n_classes = int(labels.max()) + 1 if n else 0
    tr, te = probe_split(n, train_frac, seed, groups, overlap_gap)
    mu = feats[tr].mean(0) if len(tr) else np.zeros(d)
    sd = feats[tr].std(0) if len(tr) else np.ones(d)
    x = torch.from_numpy(np.asarray((feats - mu) / (sd + 1e-6), np.float32)
                         ).to(device)
    y = torch.from_numpy(np.asarray(labels, np.int32)).to(device)
    tr_t = torch.from_numpy(np.asarray(tr, np.int64)).to(device)
    te_t = torch.from_numpy(np.asarray(te, np.int64)).to(device)
    w, b = _fit(x[tr_t], y[tr_t], n_classes, steps, lr, weight_decay)

    def acc(idx):
        logits = x[idx] @ w + b
        hits = int((torch.argmax(logits, -1) == y[idx]).sum())
        # the float32 mean as XLA takes it: the count times 1/n
        return float(np.float32(hits) * (one / np.float32(len(idx))))

    one = np.float32(1.0)

    return {
        "train_acc": acc(tr_t) if len(tr) else float("nan"),
        "test_acc": acc(te_t) if len(te) else float("nan"),
        "n_classes": n_classes,
        "n_examples": int(n),
        "chance": 1.0 / max(n_classes, 1),
    }


def speaker_probes(
    latents: dict,
    seq_keys: list[str],
    speaker_of=default_speaker_of,
    seed: int = 0,
    device: torch.device | str = "cpu",
) -> dict:
    """The speaker probe on both latents, on ``device``.

    ``latents``: dict with ``z1_mu`` [N, d1], ``z2_mu`` [N, d2],
    ``seq_idx`` [N]; ``seq_keys``: index -> utterance key. A disentangled
    model shows high z2 accuracy and near-chance z1 accuracy.
    """
    speakers = [speaker_of(k) for k in seq_keys]
    spk_ids = {s: i for i, s in enumerate(sorted(set(speakers)))}
    labels = np.asarray([spk_ids[speakers[i]] for i in latents["seq_idx"]],
                        np.int64)
    # temporal per-utterance split (see linear_probe_accuracy)
    groups = np.asarray(latents["seq_idx"])
    return {
        "z1_speaker_probe": linear_probe_accuracy(
            latents["z1_mu"], labels, seed=seed, groups=groups, device=device),
        "z2_speaker_probe": linear_probe_accuracy(
            latents["z2_mu"], labels, seed=seed, groups=groups, device=device),
        "num_speakers": len(spk_ids),
    }
