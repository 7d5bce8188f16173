"""Reference-API compatibility shims: counterpart of ``compat.py``.

Aliases so code written against the reference's Python surface ports
mechanically, and the import of the reference's ``.tar`` checkpoints:

- ``NumpyDataset`` / ``KaldiDataset`` (reference datasets.py:188-274):
  constructor-compatible dataset classes; ``ds[i]`` returns ``(seq_idx,
  [seg_len, dim] features, nsegs)``. Both are one implementation: the store
  reads ``.npy`` paths and ``ark:offset`` specifiers alike.
- ``AudioUtils`` (reference utils.py:155-300): static DSP methods, in the
  reference's ``(bins, frames)`` orientation.
- ``loss_function`` (reference train_model.py:243-251), with the
  discriminative term's sign corrected.
- ``check_best`` / ``check_terminate`` / ``estimate_mu2_dict``
  (reference utils.py:14-17, train_model.py:254-261, utils.py:45-60).
- ``load_reference_checkpoint`` / ``import_reference_checkpoint``: a
  reference ``.tar`` (utils.py:116-152 schema) as the port's
  ``SimpleFHVAE``, and written as a port checkpoint that ``train
  --continue-from ... --finetune`` resumes.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_scalablefhvae_tpu_torch.data.feature_store import FeatureStore
from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
from pytorch_scalablefhvae_tpu_torch.features import dsp_numpy
from pytorch_scalablefhvae_tpu_torch.train.loop import (  # noqa: F401
    check_best,
    check_terminate,
)


class _ScpDataset(SegmentDataset):
    """Reference-signature dataset (datasets.py:188-211)."""

    def __init__(self, feat_scp, len_scp, min_len: int = 1, mvn_path=None,
                 seg_len: int = 20, seg_shift: int = 8,
                 rand_seg: bool = False, sequence_list=None):
        store = FeatureStore(feat_scp, len_scp, min_len=min_len,
                             mvn_path=mvn_path, sequence_list=sequence_list,
                             verbose=True)
        super().__init__(store, seg_len=seg_len, seg_shift=seg_shift,
                         rand_seg=rand_seg)

    @property
    def seqlist(self):
        return self.store.seq_keys

    def apply_mvn(self, feats):
        return self.store.apply_mvn(feats)

    def undo_mvn(self, feats):
        return self.store.undo_mvn(feats)


# both formats read through the same store; the names exist for call-site
# compatibility with the reference's two classes
NumpyDataset = _ScpDataset
KaldiDataset = _ScpDataset


class AudioUtils:
    """Static-method DSP surface (reference utils.py:155-300), transposed to
    the reference's ``(bins, frames)`` from the extractors' ``(frames,
    bins)``."""

    @staticmethod
    def stft(y, sr, n_fft=400, hop_t=0.010, win_t=0.025, window="hamming",
             preemphasis=0.97):
        # complex, as the reference's librosa.core.stft: phase is kept
        return dsp_numpy.stft_complex(
            np.asarray(y), sr, n_fft, hop_t, win_t, window, preemphasis).T

    @staticmethod
    def rstft(y, sr, n_fft=400, hop_t=0.010, win_t=0.025, window="hamming",
              preemphasis=0.97, log=True, log_floor=-50):
        return dsp_numpy.log_spectrogram(
            np.asarray(y), sr, n_fft, hop_t, win_t, window, preemphasis,
            log=log, log_floor=log_floor).T

    @staticmethod
    def to_melspec(y, sr, n_fft=400, hop_t=0.010, win_t=0.025,
                   window="hamming", preemphasis=0.97, n_mels=80, log=True,
                   norm_mel="slaney", log_floor=-20):
        return dsp_numpy.log_melspec(
            np.asarray(y), sr, n_fft, hop_t, win_t, window, preemphasis,
            n_mels=n_mels, log=log, norm_mel=norm_mel,
            log_floor=log_floor).T

    @staticmethod
    def energy_vad(y, sr, hop_t=0.010, win_t=0.025, th_ratio=1.04 / 2):
        return dsp_numpy.energy_vad(np.asarray(y), sr, hop_t, win_t, th_ratio)


def loss_function(lower_bound, log_qy, alpha=10.0) -> torch.Tensor:
    """Discriminative segment variational lower bound loss
    (train_model.py:243-251; ``log_qy`` enters with its correct sign)."""
    return -1.0 * torch.mean(torch.as_tensor(lower_bound)
                             + alpha * torch.as_tensor(log_qy))


# ---------------------------------------------------------------------------
# Reference .tar checkpoint import
# ---------------------------------------------------------------------------

# reference module attribute -> the port's module (simple_fhvae.py:31-36)
_MLP_MAP = {
    "z2_pre_encoder": "z2_pre",
    "z1_pre_encoder": "z1_pre",
    "pre_decoder": "dec_pre",
}
_GAUSS_MAP = {
    "z2_gauss_layer": "z2_gauss",
    "z1_gauss_layer": "z1_gauss",
    "dec_gauss_layer": "dec_gauss",
}


def _map_reference_key(key: str):
    """Reference ``state_dict`` key -> (the port's parameter name,
    transpose?), or ``(None, False)``.

    Reference naming (simple_fhvae.py:127-244): MLPs are
    ``<module>.fc<N>.linear.{weight,bias}``; Gaussian heads are
    ``<module>.{mulayer,logvar_layer}.{weight,bias}``. torch ``Linear``
    weights are ``[out, in]``; the port's are ``[in, out]``.
    """
    parts = key.split(".")
    mod = parts[0]
    leaf = "w" if parts[-1] == "weight" else "b"
    if mod in _MLP_MAP and len(parts) > 1 and parts[1].startswith("fc"):
        layer = int(parts[1][2:]) - 1
        return f"{_MLP_MAP[mod]}.layers.{layer}.{leaf}", leaf == "w"
    if mod in _GAUSS_MAP and len(parts) > 1 \
            and parts[1] in ("mulayer", "logvar_layer"):
        head = "mu" if parts[1] == "mulayer" else "logvar"
        return f"{_GAUSS_MAP[mod]}.{head}.{leaf}", leaf == "w"
    return None, False


def load_reference_checkpoint(checkpoint_file, num_seqs: int,
                              mu2_init_std: float = 0.0, seed: int = 0):
    """Import a reference ``.tar`` checkpoint (utils.py:116-152 schema) as
    the port's ``SimpleFHVAE``. Returns ``(model, meta)``, ``meta`` the
    reference's epoch/best/history fields.

    The reference never saved a mu2 table, so the imported one is fresh,
    ``mu2_init_std * N(0, 1)`` from a generator seeded by ``seed`` (zeros at
    the default 0) and sized for ``num_seqs``: a resume is a finetune, the
    MLP weights transfer and the table re-estimates. Parameters the
    checkpoint does not name keep the seeded initialisation. An unknown key
    or a shape that does not fit raises. Only ``simple_fhvae`` checkpoints
    exist: the reference's FHVAE is a stub (fhvae.py:14).
    """
    from pytorch_scalablefhvae_tpu_torch.models.simple_fhvae import (
        SimpleFHVAE,
    )

    # tensors, containers and numbers only: no pickled code runs
    ckpt = torch.load(checkpoint_file, map_location="cpu", weights_only=True)
    model_type = ckpt.get("model_type", "simple_fhvae")
    if model_type != "simple_fhvae":
        raise ValueError(
            f"Cannot import model_type {model_type!r}: the reference only "
            "implements simple_fhvae (its FHVAE is a stub, fhvae.py:14)")
    state_dict = ckpt["state_dict"]
    # the saved model_params are (z1_hus, z2_hus, z1_dim, z2_dim, x_hus),
    # without input_size (utils.py:134-141): the z2 encoder's first layer,
    # [h0, input_size] in torch's orientation, gives it
    z1_hus, z2_hus, z1_dim, z2_dim, x_hus = ckpt["model_params"]
    input_size = int(state_dict["z2_pre_encoder.fc1.linear.weight"].shape[1])
    model = SimpleFHVAE(input_size, z1_hus=tuple(z1_hus),
                        z2_hus=tuple(z2_hus), z1_dim=int(z1_dim),
                        z2_dim=int(z2_dim), x_hus=tuple(x_hus),
                        num_seqs=num_seqs,
                        generator=torch.Generator().manual_seed(seed))
    target = model.state_dict()
    loaded, unmapped = {}, []
    for key, tensor in state_dict.items():
        name, transpose = _map_reference_key(key)
        if name is None or name not in target:
            unmapped.append(key)
            continue
        arr = tensor.detach().to(torch.float32)
        if transpose:
            arr = arr.T
        if tuple(arr.shape) != tuple(target[name].shape):
            raise ValueError(
                f"{key}: reference shape {tuple(arr.shape)} does not fit "
                f"{name} {tuple(target[name].shape)}")
        loaded[name] = arr.contiguous()
    if unmapped:
        raise ValueError(f"Unrecognized reference state_dict keys: {unmapped}")
    shape = (num_seqs, int(z2_dim))
    loaded["mu2_table"] = (float(mu2_init_std) * torch.randn(
        shape, generator=torch.Generator().manual_seed(seed))
        if mu2_init_std else torch.zeros(shape))
    model.load_state_dict(loaded, strict=False)
    meta = {
        "model_type": model_type,
        "epoch": int(ckpt.get("epoch", 0)),
        "best_epoch": int(ckpt.get("best_epoch", 0)),
        "best_val_lb": float(ckpt.get("best_val_lb", -np.inf)),
        "values": ckpt.get("values") or {},
    }
    return model, meta


def _convert_reference_values(values) -> dict:
    """Reference metric history -> ``MetricHistory``'s epoch-keyed schema.

    The reference's ``values`` are inconsistent (tensors shadowed by dicts
    of lists); lists become ``{epoch: value}``, mappings keep their numeric
    entries, and every point that does not convert is dropped on its own:
    the history is advisory, and losing it must not block the resume."""
    out: dict = {}
    if not isinstance(values, dict):
        return out

    def per_entry(items) -> dict:
        conv = {}
        for ep, x in items:
            try:
                conv[int(ep)] = float(x)
            except (TypeError, ValueError):
                continue
        return conv

    for k, v in values.items():
        if isinstance(v, dict):
            out[k] = per_entry(v.items())
        elif isinstance(v, (list, tuple)):
            out[k] = per_entry(enumerate(v))
    return out


def import_reference_checkpoint(checkpoint_file, out_dir, num_seqs: int,
                                mu2_init_std: float = 0.0, seed: int = 0):
    """Convert a reference ``.tar`` into a port checkpoint (the imported
    weights, fresh Adam moments), ready for ``--continue-from <out>
    --finetune``. Returns the ``.npz`` path."""
    from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt_mod
    from pytorch_scalablefhvae_tpu_torch.train.step import create_train_state

    model, meta = load_reference_checkpoint(checkpoint_file, num_seqs,
                                            mu2_init_std, seed)
    return ckpt_mod.save_checkpoint(
        out_dir, model, model_type=model.model_type,
        model_params=model.model_params(), run_info="imported",
        epoch=meta["epoch"], best_epoch=meta["best_epoch"],
        best_val_lb=meta["best_val_lb"],
        values=_convert_reference_values(meta.get("values")),
        extra_meta={"imported_from": str(checkpoint_file),
                    "num_seqs": num_seqs},
        train_state=create_train_state(model, seed=seed))


def estimate_mu2_dict(model, loader, pz2_var=None, pmu2_var=1.0) -> dict:
    """mu2 per sequence from the encoder's means (utils.py:45-60 intent).

    The reference's signature is ``(model, loader, num_seqs)``; the sequence
    count comes from the loader here. As in the reference the dict is keyed
    by sequence index and holds only the sequences with a segment."""
    from pytorch_scalablefhvae_tpu_torch.eval.latents import (
        estimate_mu2,
        extract_latents,
    )

    lat = extract_latents(model, loader)
    if pz2_var is None:
        pz2_var = float(np.exp(model.pz2_logvar))
    table = estimate_mu2(lat["z2_mu"], lat["seq_idx"],
                         loader.dataset.num_seqs, pz2_var=pz2_var,
                         pmu2_var=pmu2_var)
    seen = {int(i) for i in lat["seq_idx"]}
    return {i: table[i] for i in sorted(seen)}
