"""Training driver: counterpart of ``train/driver.py``.

config -> (preprocessing) -> feature stores, segment datasets and host
loaders -> the training loop, with the JAX package's resume policy: on
``--continue-from`` the run's saved ``config.json`` defines the experiment,
changed deliberately only through ``--resume-override``, and the run keeps
writing into the checkpoint's directory.

The host data layer (corpus prep, features, the packed ``FeatureStore``,
``SegmentDataset``, ``SegmentLoader``) is this package's own copy of the JAX
package's; ``split_manifests`` says where a preprocessed corpus's
``feats.scp`` / ``len.scp`` live. Without ``--preprocessed`` the features are
extracted first, the ``jax`` extractor's on the run's device.

Every ``train`` setting of the JAX package runs, ``--ckpt-backend orbax``
included (``train/orbax_backend.py``). The data tier (the device-resident
store, the streamed tier or the host loader) is resolved by
``train/loop.py``, which also runs the mesh branch: on a mesh every rank calls
:func:`train_from_config` with its own device (``cli/main.py`` starts the
ranks).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch.distributed as dist

from pytorch_scalablefhvae_tpu_torch.data.feature_store import FeatureStore
from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
from pytorch_scalablefhvae_tpu_torch.features.pipeline import (
    preprocess_data,
    split_manifests,
)
from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
from pytorch_scalablefhvae_tpu_torch.train.loop import TrainResult, run_training


def check_batch_split(config: ExperimentConfig) -> None:
    """Raise the JAX package's ``ValueError`` for a training batch that the
    data axis of ``--mesh`` does not divide: the JAX loop's first step
    cannot shard it. Under ``--legacy`` the batch is 1, so any data axis
    above 1 raises. Checked before the ranks start."""
    d = config.train.mesh_shape[0]
    batch = 1 if config.train.legacy else config.data.training_batch_size
    if batch % d:
        raise ValueError(
            f"the data axis ({d}) must divide the training batch size "
            f"({batch}{', --legacy' if config.train.legacy else ''})")


def build_loaders(config: ExperimentConfig, data_root: str | Path = ".",
                  is_preprocessed: bool = True,
                  fbank_conf: str | Path = "./misc/fbank.conf",
                  device: str = "cuda"
                  ) -> tuple[SegmentLoader, SegmentLoader]:
    """The shuffled training loader and the ordered dev loader; under
    ``--legacy`` both at batch size 1 (JAX ``train/driver.py``)."""
    dcfg = config.data
    min_len = dcfg.min_len if dcfg.min_len is not None else dcfg.seg_len
    if is_preprocessed:
        paths = split_manifests(config, root=data_root)
    else:
        if dcfg.raw_data_dir is None and dcfg.dataset != "synthetic":
            raise ValueError("You must provide a raw data location if the "
                             "data is not preprocessed!")
        paths = preprocess_data(config, root=data_root, fbank_conf=fbank_conf,
                                device=device)

    def make_loader(split: str, batch_size: int, shuffle: bool):
        pack_cache = (None if dcfg.pack_cache_dir is None
                      else Path(dcfg.pack_cache_dir) / f"{split}_pack")
        store = FeatureStore(paths[split]["feat_pth"],
                             paths[split]["len_pth"], min_len=min_len,
                             mvn_path=dcfg.mvn_path, pack_cache=pack_cache)
        ds = SegmentDataset(store, seg_len=dcfg.seg_len,
                            seg_shift=dcfg.seg_shift, rand_seg=dcfg.rand_seg,
                            seed=config.train.seed)
        return SegmentLoader(ds, batch_size, shuffle=shuffle,
                             seed=config.train.seed,
                             transfer_dtype=dcfg.transfer_dtype)

    train_bs, dev_bs = dcfg.training_batch_size, dcfg.dev_batch_size
    if config.train.legacy:
        train_bs = dev_bs = 1
    return (make_loader("train", train_bs, True),
            make_loader("dev", dev_bs, False))


def resolve_run_config(config: ExperimentConfig,
                       continue_from: str | Path | None = None,
                       resume_overrides: dict | None = None,
                       verbose: bool = True) -> ExperimentConfig:
    """The config the run trains with: on a resume the saved ``config.json``
    beside the checkpoint, changed only by ``resume_overrides`` (a resume on
    another mesh: ``mesh_shape=1,2``); checked by
    :func:`check_batch_split`."""
    if continue_from is not None:
        saved = Path(continue_from).parent / "config.json"
        if saved.exists():
            resumed = ExperimentConfig.load(saved)
            if verbose and resumed != config:
                print(f"Using saved run config from {saved}")
            config = resumed
        if resume_overrides:
            config = config.apply_overrides(resume_overrides)
            if verbose:
                print(f"Resume overrides applied: {resume_overrides}")
    elif resume_overrides:
        raise ValueError(
            "--resume-override only applies when resuming (--continue-from); "
            "set the flag directly for a fresh run")
    check_batch_split(config)
    return config


def train_from_config(config: ExperimentConfig, data_root: str | Path = ".",
                      exp_root: str | Path = "./experiments",
                      is_preprocessed: bool = False,
                      continue_from: str | Path | None = None,
                      finetune: bool = False,
                      fbank_conf: str | Path = "./misc/fbank.conf",
                      verbose: bool = True,
                      resume_overrides: dict | None = None,
                      device: str = "cuda",
                      trace_spans: bool = False) -> TrainResult:
    in_group = dist.is_initialized()
    verbose = verbose and (not in_group or dist.get_rank() == 0)
    config = resolve_run_config(config, continue_from, resume_overrides,
                                verbose)
    if (config.features.data_format == "kaldi"
            and config.features.fbank_conf_kwargs is None
            and Path(fbank_conf).exists()):
        # persist the parsed conf in the run's config: encode/serve rebuild
        # features from the config alone
        from pytorch_scalablefhvae_tpu_torch.features.kaldi_fbank import (
            fbank_kwargs_from_conf,
            parse_fbank_conf,
        )

        config = config.replace(features=dataclasses.replace(
            config.features, fbank_conf_kwargs=fbank_kwargs_from_conf(
                parse_fbank_conf(str(fbank_conf)))))

    if continue_from is not None and not finetune:
        # a resume continues the experiment in the checkpoint's directory
        exp_dir = Path(continue_from).parent
    else:
        exp_dir = config.exp_dir(exp_root)
        if finetune and continue_from is not None:
            # a finetune is a new experiment: never write into a directory
            # that already holds checkpoints
            base, n = exp_dir, 0
            while exp_dir.exists() and (any(exp_dir.glob("*_e*.npz"))
                                        or any(exp_dir.glob("*_e*.orbax"))):
                n += 1
                suffix = "_finetune" if n == 1 else f"_finetune{n}"
                exp_dir = base.with_name(base.name + suffix)
    if in_group and not is_preprocessed:
        # one rank extracts the features; the others wait and read them
        if dist.get_rank() == 0:
            build_loaders(config, data_root, False, fbank_conf, device=device)
        dist.barrier()
        is_preprocessed = True
    train_loader, dev_loader = build_loaders(config, data_root,
                                             is_preprocessed, fbank_conf,
                                             device=device)
    return run_training(config, train_loader, dev_loader, exp_dir,
                        continue_from=continue_from, finetune=finetune,
                        device=device, verbose=verbose,
                        trace_spans=trace_spans)
