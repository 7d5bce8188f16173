"""Latent extraction and mu2 MAP estimation: counterpart of
``eval/latents.py``.

``extract_latents`` runs the ``SegmentLoader``'s fixed-shape batches
through ``FHVAE.apply(sample=False)``, scoring each segment's lower bound
against a split's MAP table when one is given; ``estimate_mu2`` and
``sequence_mean_z1`` are the JAX package's numpy code.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader


def extract_latents(model, loader: SegmentLoader,
                    table: torch.Tensor | None = None
                    ) -> dict[str, np.ndarray]:
    """Posterior means of every segment of a loader, in loader order.

    Returns ``z1_mu [N, z1]``, ``z2_mu [N, z2]``, ``seq_idx [N]`` and
    ``lower_bound [N]`` for the N real (non-padded) rows. Each batch comes
    back to the host as ONE packed ``[B, z1 + z2 + 1]`` copy.

    ``table``: the mu2 table the lower bound is scored against, on the
    model's device. For a held-out split it must be the split's MAP table:
    the learned table has no rows for its sequences (deviation D6).
    ``None`` scores against the learned table (``encode``, ``serve``).
    """
    dev = model.mu2_table.device
    z1s, z2s, seqs, lbs = [], [], [], []
    with torch.inference_mode():
        for b in loader:
            out = model.apply(torch.from_numpy(b.feats).to(dev),
                              torch.from_numpy(b.seq_idx).to(dev),
                              torch.from_numpy(b.nsegs).to(dev), sample=False,
                              mu2_table=table)
            packed = torch.cat([out.z1_mu, out.z2_mu,
                                out.lower_bound[:, None]], dim=1)
            block = packed.cpu().numpy()[: b.num_real]
            d1 = out.z1_mu.shape[1]
            z1s.append(block[:, :d1])
            z2s.append(block[:, d1:-1])
            lbs.append(block[:, -1])
            seqs.append(b.seq_idx[: b.num_real])
    return {
        "z1_mu": np.concatenate(z1s) if z1s else np.zeros((0, 0)),
        "z2_mu": np.concatenate(z2s) if z2s else np.zeros((0, 0)),
        "lower_bound": np.concatenate(lbs) if lbs else np.zeros(0),
        "seq_idx": np.concatenate(seqs) if seqs else np.zeros(0, np.int32),
    }


def estimate_mu2(
    z2_mu: np.ndarray,
    seq_idx: np.ndarray,
    num_seqs: int,
    pz2_var: float = 0.25,
    pmu2_var: float = 1.0,
) -> np.ndarray:
    """Closed-form MAP estimate of mu2 per sequence:
    ``mu2[y] = sum_{segments of y} z2_mu / (n_y + pz2_var / pmu2_var)``."""
    dim = z2_mu.shape[1] if z2_mu.ndim == 2 else 0
    sums = np.zeros((num_seqs, dim), dtype=np.float64)
    counts = np.zeros(num_seqs, dtype=np.float64)
    np.add.at(sums, seq_idx, z2_mu)
    np.add.at(counts, seq_idx, 1.0)
    r = pz2_var / pmu2_var
    return (sums / (counts + r)[:, None]).astype(np.float32)


def sequence_mean_z1(z1_mu: np.ndarray, seq_idx: np.ndarray,
                     num_seqs: int) -> np.ndarray:
    dim = z1_mu.shape[1] if z1_mu.ndim == 2 else 0
    sums = np.zeros((num_seqs, dim), dtype=np.float64)
    counts = np.zeros(num_seqs, dtype=np.float64)
    np.add.at(sums, seq_idx, z1_mu)
    np.add.at(counts, seq_idx, 1.0)
    counts = np.maximum(counts, 1.0)
    return (sums / counts[:, None]).astype(np.float32)
