"""Encode raw audio with a trained experiment: counterpart of
``eval/encode.py``.

Decode audio -> features with the run's exact feature config (the host
numpy/Kaldi extractors shared with the JAX package) -> the run's MVN stats
-> fixed-shape segment batches -> ``FHVAE.apply`` on the device -> per-segment
z1/z2 posterior means, per-utterance mu2 MAP estimates and mean z1.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from pytorch_scalablefhvae_tpu.data.feature_store import FeatureStore
from pytorch_scalablefhvae_tpu.data.loader import SegmentLoader
from pytorch_scalablefhvae_tpu.data.segments import SegmentDataset
from pytorch_scalablefhvae_tpu.utils.audio_io import read_audio
from pytorch_scalablefhvae_tpu.utils.manifest import read_scp
from pytorch_scalablefhvae_tpu_torch.eval.latents import (
    estimate_mu2,
    extract_latents,
    sequence_mean_z1,
)
from pytorch_scalablefhvae_tpu_torch.utils.device import resolve_device

AUDIO_EXTS = (".wav", ".flac", ".sph")


def _collect_audio(inputs) -> dict[str, str]:
    """Resolve inputs (files, directories, or a wav.scp) to
    ``{utt_id: path}``.

    File-derived ids key by stem; when stems collide, colliding entries
    re-key as ``<parent>_<stem>`` so nothing is silently dropped. Explicit
    wav.scp ids are authoritative and never re-keyed — a collision involving
    one is an error."""
    out: dict[str, str] = {}
    explicit: set[str] = set()
    collided: set[str] = set()

    def qualified(stem: str, path: str) -> str:
        parent = Path(path).parent.name
        return f"{parent}_{stem}" if parent else stem

    def insert(key: str, path: str, is_explicit: bool) -> None:
        if key in out:
            raise ValueError(
                f"Duplicate utterance id {key!r}: {path} and {out[key]}")
        out[key] = path
        if is_explicit:
            explicit.add(key)

    def add(stem: str, path: str, is_explicit: bool = False) -> None:
        if stem in out and (is_explicit or stem in explicit):
            raise ValueError(
                f"Duplicate utterance id {stem!r}: {path} and {out[stem]}")
        if stem in collided:
            if is_explicit:
                raise ValueError(
                    f"Explicit utterance id {stem!r} collides with "
                    f"directory-derived ids that were re-keyed as "
                    f"<parent>_{stem}; rename the scp id or pass the "
                    f"files individually")
            insert(qualified(stem, path), path, is_explicit)
        elif stem in out:
            # first stem collision: re-key the existing entry by parent too
            collided.add(stem)
            other = out.pop(stem)
            insert(qualified(stem, other), other, False)
            insert(qualified(stem, path), path, False)
        else:
            insert(stem, path, is_explicit)

    for item in inputs:
        p = Path(item)
        if p.is_dir():
            for f in sorted(p.rglob("*")):
                if f.suffix.lower() in AUDIO_EXTS:
                    add(f.stem, str(f))
        elif p.name.endswith(".scp"):
            for k, v in read_scp(p).items():
                add(k, v, is_explicit=True)
        elif p.suffix.lower() in AUDIO_EXTS:
            add(p.stem, str(p))
        else:
            raise ValueError(f"Unsupported encode input {item!r} "
                             f"(expected audio file, directory, or .scp)")
    if not out:
        raise ValueError(f"No audio found in {list(inputs)!r}")
    return out


def _featurize(y: np.ndarray, sr: int, fcfg) -> np.ndarray:
    """One utterance -> ``[T, dim]`` features through the same functions
    the training pipeline uses, so served features cannot drift from the
    trained ones."""
    if fcfg.data_format == "kaldi":
        from pytorch_scalablefhvae_tpu.features.kaldi_fbank import kaldi_fbank

        # the run's parsed fbank conf wins over FeatureConfig defaults
        kw = dict(
            frame_length_ms=fcfg.win_t * 1000.0,
            frame_shift_ms=fcfg.hop_t * 1000.0,
            n_mels=fcfg.n_mels,
            window_type=fcfg.window,
            preemphasis=fcfg.preemphasis,
            remove_dc_offset=fcfg.remove_dc_offset,
        )
        conf_kw = dict(getattr(fcfg, "fbank_conf_kwargs", None) or {})
        conf_sr = conf_kw.pop("sr", None)
        if conf_sr is not None and int(conf_sr) != int(sr):
            raise ValueError(
                f"Sample rate mismatch: the run's fbank conf expects "
                f"{conf_sr} Hz but the audio decodes at {sr} Hz")
        kw.update(conf_kw)
        kw["dither"] = 0.0  # deterministic inference
        return kaldi_fbank(y, sr, **kw)
    from pytorch_scalablefhvae_tpu.features.extract import generate_feat

    return generate_feat(fcfg.feat_type, y, sr, fcfg.win_t, fcfg.hop_t,
                         fcfg.n_mels, window=fcfg.window,
                         preemphasis=fcfg.preemphasis, mel_norm=fcfg.mel_norm,
                         log_floor_mel=fcfg.log_floor_mel,
                         log_floor_spec=fcfg.log_floor_spec)


def encode_audio(exp_dir, inputs, step: int = -1, output_dir=None,
                 batch_size: int = 2048, sample_rate: int | None = None,
                 verbose: bool = True, device: str = "cuda") -> dict:
    """One-shot form of :class:`EncodeSession`: load, encode, return (and
    write to ``output_dir`` when given) the latents."""
    session = EncodeSession(exp_dir, step=step, batch_size=batch_size,
                            device=device)
    return session.encode(inputs, output_dir=output_dir,
                          sample_rate=sample_rate, verbose=verbose)


class EncodeSession:
    """A loaded experiment held on the device for repeated encode requests
    (the serving path, ``serve``): the model and its weights load once."""

    def __init__(self, exp_dir, step: int = -1, batch_size: int = 2048,
                 device: str = "cuda"):
        from pytorch_scalablefhvae_tpu_torch.eval.evaluate import (
            load_experiment,
        )

        self.exp_dir = Path(exp_dir)
        self.device = resolve_device(device)
        self.config, self.model, self.meta = load_experiment(
            self.exp_dir, step=step, device=self.device)
        self.batch_size = batch_size
        self._mvn_params = None
        if self.config.data.mvn_path:
            mvn_file = Path(self.config.data.mvn_path)
            if not mvn_file.exists():
                # un-normalized features against a model trained on
                # normalized ones give numerically valid garbage
                raise FileNotFoundError(
                    f"The run was trained with MVN ({mvn_file}) but the "
                    f"stats file is missing; copy it next to the experiment "
                    f"or point config.data.mvn_path at it")
            self._mvn_params = json.loads(mvn_file.read_text())

    def encode(self, inputs, output_dir=None, sample_rate: int | None = None,
               verbose: bool = True) -> dict:
        return _encode_request(
            self.config, self.model, self._mvn_params, inputs,
            output_dir=output_dir, batch_size=self.batch_size,
            sample_rate=sample_rate, verbose=verbose)


def _encode_request(config, model, mvn_params, inputs, output_dir=None,
                    batch_size: int = 2048, sample_rate: int | None = None,
                    verbose: bool = True) -> dict:
    fcfg = config.features
    if fcfg.extractor == "jax" and fcfg.data_format != "kaldi":
        raise NotImplementedError(
            "extractor 'jax' (the batched on-device log-mel chain and its "
            "fbank kernel, fused_logmel_frames) is not yet ported (ROADMAP.md); "
            "the run's features can be rebuilt with extractor 'numpy'")

    t0 = time.perf_counter()
    audio = _collect_audio(inputs if isinstance(inputs, (list, tuple))
                           else [inputs])
    # an utterance must yield at least one full segment (and honor the
    # run's min_len filter when it is stricter)
    min_frames = max(config.data.min_len or 0, config.data.seg_len)
    if (sample_rate is not None and fcfg.sample_rate is not None
            and sample_rate != fcfg.sample_rate):
        raise ValueError(
            f"This run was trained at {fcfg.sample_rate} Hz; --sample-rate "
            f"{sample_rate} would skew the feature geometry (omit it, or "
            f"resample to the trained rate)")
    resample_to = sample_rate if sample_rate is not None else fcfg.sample_rate
    locked_sr = resample_to
    signals: dict[str, np.ndarray] = {}
    for key, path in audio.items():
        y, sr = read_audio(path, resample_to)
        if locked_sr is None:
            locked_sr = sr
        elif locked_sr != sr:
            raise ValueError(
                f"Inconsistent sample rate for {key}: {sr} vs {locked_sr} "
                f"(pass --sample-rate to resample everything to one rate)")
        signals[key] = y

    feats: dict[str, np.ndarray] = {}
    skipped = []
    for key, y in signals.items():
        f = _featurize(y, locked_sr, fcfg)
        if len(f) < min_frames:
            skipped.append(key)
            continue
        feats[key] = np.asarray(f, np.float32)
    if skipped and verbose:
        print(f"Skipped {len(skipped)} utterances shorter than {min_frames} "
              f"frames: {skipped[:5]}{'...' if len(skipped) > 5 else ''}")
    if not feats:
        raise ValueError("All inputs were shorter than one segment")

    store = FeatureStore.from_arrays(feats, mvn_params=mvn_params,
                                     apply_mvn=mvn_params is not None)
    ds = SegmentDataset(store, seg_len=config.data.seg_len,
                        seg_shift=config.data.seg_shift)
    loader = SegmentLoader(ds, batch_size, shuffle=False, seed=0)

    t1 = time.perf_counter()
    lat = extract_latents(model, loader)  # ends on a device-to-host copy
    t2 = time.perf_counter()
    mu2_hat = estimate_mu2(lat["z2_mu"], lat["seq_idx"], store.num_seqs,
                           pz2_var=config.model.pz2_std ** 2, pmu2_var=1.0)
    z1_seq = sequence_mean_z1(lat["z1_mu"], lat["seq_idx"], store.num_seqs)

    result = {
        "z1_mu": lat["z1_mu"], "z2_mu": lat["z2_mu"],
        "seq_idx": lat["seq_idx"], "mu2_map": mu2_hat,
        "z1_seq_mean": z1_seq, "sequences": store.seq_keys,
        # wall seconds of the request's stages, host clock: audio read,
        # features, MVN and segmenting; batches, model and copies; the
        # per-utterance summaries
        "seconds": {"features": t1 - t0, "latents": t2 - t1,
                    "summaries": time.perf_counter() - t2},
    }
    if output_dir is not None:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        np.savez(out / "latents.npz",
                 **{k: v for k, v in result.items()
                    if k not in ("sequences", "seconds")})
        (out / "sequences.json").write_text(json.dumps(store.seq_keys))
        if verbose:
            print(f"Encoded {store.num_seqs} utterances "
                  f"({len(lat['seq_idx'])} segments) -> {out}")
    return result
