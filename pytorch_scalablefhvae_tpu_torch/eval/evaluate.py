"""Experiment evaluation: counterpart of ``eval/evaluate.py``.

Given a trained experiment directory, ``evaluate_experiment``:

1. loads the run config and the best / Nth-epoch checkpoint
   (``load_experiment``);
2. builds the requested split's dataset, optionally filtered to a sequence
   list (``--seqlist``);
3. MAP-estimates the split's mu2 table (held-out sequences have no rows in
   the learned table) and computes the lower bound and every ELBO term over
   the split against it;
4. extracts per-segment z1/z2 posterior means and lower bounds (scored
   against the same table), per-sequence mu2 MAP estimates and mean z1;
5. reconstructs the first batch's first segments and decodes them again
   with each segment's z2 taken from the next one (the factor swap);
6. runs the speaker probes on both latents;
7. writes ``latents.npz``, ``reconstructions.npz``, ``metrics.json`` and
   ``sequences.json`` under ``<exp_dir>/eval/<split>/``, with the JAX
   package's names, keys and dtypes: either package's ``probe`` reads
   either's files.

Every pass runs on ``device``: the CUDA kernels on ``cuda``, their plain
versions on ``cpu``. Each stage ends in a copy to the host, so the stage
times returned (``seconds``) are wall times of finished work.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
from pytorch_scalablefhvae_tpu_torch.data.feature_store import FeatureStore
from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
from pytorch_scalablefhvae_tpu_torch.eval.latents import (
    estimate_mu2,
    extract_latents,
    sequence_mean_z1,
)
from pytorch_scalablefhvae_tpu_torch.eval.probes import (
    json_safe,
    speaker_probes,
)
from pytorch_scalablefhvae_tpu_torch.features.pipeline import split_manifests
from pytorch_scalablefhvae_tpu_torch.models.base import build_model
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train.loop import (
    batch_tensors,
    estimate_split_mu2,
    evaluate_split,
)
from pytorch_scalablefhvae_tpu_torch.utils.device import resolve_device


def load_experiment(exp_dir, step: int = -1,
                    device: torch.device | str = "cpu"):
    """Config + model (with the checkpoint's weights, on ``device``) from an
    experiment directory. ``step=-1`` loads the best checkpoint, otherwise
    the ``step``-th epoch checkpoint. Returns ``(config, model, meta)``;
    the model is in eval mode."""
    exp_dir = Path(exp_dir)
    config = ExperimentConfig.load(exp_dir / "config.json")
    ckpt_file = (ckpt.find_best_checkpoint(exp_dir) if step == -1
                 else ckpt.find_epoch_checkpoint(exp_dir, step))
    meta = ckpt.read_checkpoint_meta(ckpt_file)
    model = build_model(
        config.model.model_type, meta["model_params"][0], config.model,
        meta.get("num_seqs", 1),
        feat_dim=meta.get("feat_dim", config.features.n_mels))
    model.to(device)
    meta = ckpt.load_params(ckpt_file, model)
    return config, model.eval(), meta


@torch.inference_mode()
def reconstructions(model, loader: SegmentLoader, table: torch.Tensor,
                    n_max: int, device: torch.device) -> dict | None:
    """The first batch's first ``n_max`` real segments: input, decoder mean
    and the factor swap, decoding (z1 of a, z2 of the next segment b), which
    keeps a's content with b's sequence identity (arXiv 1709.07902 §5.2)."""
    for b in loader:
        feats, seq_idx, nsegs, _ = batch_tensors(b, device)
        out = model.apply(feats, seq_idx, nsegs, sample=False,
                          mu2_table=table)
        n = min(n_max, int(b.weight.sum()))
        perm = np.roll(np.arange(n), 1)  # pair each segment with the next
        swap_mu, _, _ = model.decode(
            out.z1_mu[:n], out.z2_mu[:n][torch.from_numpy(perm).to(device)],
            num_frames=b.feats.shape[1])
        return {
            "input": np.asarray(b.feats[:n]),
            "recon_mu": out.x_mu[:n].cpu().numpy(),
            "swap_recon_mu": swap_mu.cpu().numpy(),
            "swap_z2_from": np.asarray(b.seq_idx[:n])[perm],
            "seq_idx": np.asarray(b.seq_idx[:n]),
        }
    return None


def evaluate_experiment(
    exp_dir,
    set_name: str = "dev",
    seqlist=None,
    step: int = -1,
    data_root=".",
    output_dir=None,
    num_reconstructions: int = 8,
    verbose: bool = True,
    device: str = "cuda",
) -> dict:
    """Evaluate an experiment on one split and write its four artifacts.
    Returns ``metrics``, ``latents``, ``mu2_map``, ``probes``,
    ``output_dir`` and ``seconds`` (wall time per stage)."""
    dev = resolve_device(device)
    exp_dir = Path(exp_dir)
    seconds = {}
    t0 = time.perf_counter()
    config, model, _ = load_experiment(exp_dir, step=step, device=dev)

    paths = split_manifests(config, root=data_root)[set_name]
    sequence_list = None
    if seqlist is not None:
        lines = Path(seqlist).read_text().splitlines()
        sequence_list = [line.strip() for line in lines if line.strip()]
    min_len = (config.data.min_len if config.data.min_len is not None
               else config.data.seg_len)
    if config.data.mvn_path and not Path(config.data.mvn_path).exists():
        # FeatureStore would silently RECOMPUTE the stats from this eval
        # split (different from the training stats -> skewed metrics and
        # latents) and write the bogus file; refuse like eval/encode.py
        raise FileNotFoundError(
            f"The run was trained with MVN ({config.data.mvn_path}) but the "
            f"stats file is missing; copy it next to the experiment or "
            f"point config.data.mvn_path at it")
    store = FeatureStore(
        paths["feat_pth"], paths["len_pth"], min_len=min_len,
        mvn_path=config.data.mvn_path, sequence_list=sequence_list)
    ds = SegmentDataset(store, seg_len=config.data.seg_len,
                        seg_shift=config.data.seg_shift)
    loader = SegmentLoader(ds, config.data.dev_batch_size, shuffle=False,
                           seed=0)
    seconds["load"] = time.perf_counter() - t0

    # split-level metrics against a MAP-estimated mu2 table for this split
    # (held-out sequences have no rows in the learned table)
    t0 = time.perf_counter()
    pz2_var = config.model.pz2_std ** 2
    split_table = torch.from_numpy(estimate_split_mu2(
        model, loader, store.num_seqs, pz2_var, dev)).to(dev)
    seconds["map_pass"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = evaluate_split(model, loader, config.optim.alpha_dis, dev,
                             table=split_table)
    seconds["scored_pass"] = time.perf_counter() - t0
    if verbose:
        print(f"==== {set_name} metrics ====")
        for k, v in metrics.items():
            print(f"  {k}: {v:.4f}")

    # per-segment lower_bound scored against the SPLIT's MAP table, as the
    # metrics above
    t0 = time.perf_counter()
    lat = extract_latents(model, loader, table=split_table)
    mu2_hat = estimate_mu2(lat["z2_mu"], lat["seq_idx"], store.num_seqs,
                           pz2_var=pz2_var, pmu2_var=1.0)
    z1_seq = sequence_mean_z1(lat["z1_mu"], lat["seq_idx"], store.num_seqs)
    recon = reconstructions(model, loader, split_table, num_reconstructions,
                            dev)
    seconds["latents"] = time.perf_counter() - t0

    # disentanglement probes: z2 should predict the speaker, z1 should not
    t0 = time.perf_counter()
    probes = (speaker_probes(lat, store.seq_keys, device=dev)
              if len(lat["seq_idx"]) else {})
    seconds["probe"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out_dir = Path(output_dir) if output_dir else exp_dir / "eval" / set_name
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / "latents.npz", z1_mu=lat["z1_mu"], z2_mu=lat["z2_mu"],
             seq_idx=lat["seq_idx"], lower_bound=lat["lower_bound"],
             mu2_map=mu2_hat, z1_seq_mean=z1_seq)
    if recon is not None:
        np.savez(out_dir / "reconstructions.npz", **recon)
    (out_dir / "metrics.json").write_text(json.dumps(
        # json_safe: an empty probe split reports NaN accuracies, which
        # json.dumps would emit as the non-standard NaN token
        json_safe({"set_name": set_name,
                   **{k: float(v) for k, v in metrics.items()},
                   "probes": probes}),
        indent=2))
    (out_dir / "sequences.json").write_text(json.dumps(store.seq_keys))
    seconds["write"] = time.perf_counter() - t0
    if verbose:
        if probes:
            z1p = probes["z1_speaker_probe"]
            z2p = probes["z2_speaker_probe"]
            print(f"Speaker probe ({probes['num_speakers']} speakers, "
                  f"chance {z2p['chance']:.3f}): z2 acc "
                  f"{z2p['test_acc']:.3f}, z1 acc {z1p['test_acc']:.3f}")
        print("Stages (s): " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in seconds.items()))
        print(f"Wrote evaluation outputs to {out_dir}")
    return {"metrics": metrics, "latents": lat, "mu2_map": mu2_hat,
            "probes": probes, "output_dir": out_dir, "seconds": seconds}
