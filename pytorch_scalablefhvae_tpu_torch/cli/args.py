"""Argparse <-> ExperimentConfig bridge.

Covers every flag of the reference CLI surface (train_model.py:25-238,
preprocess_data.py:76-130, eval_model.py:10-39) with identical defaults and
semantics, mapped onto the typed config sections.

The port's own copy of the JAX package's ``cli/args.py``: the same flags and
the same ``config_from_args``, so one command line means the same run to both
packages. ``--device`` is ``cuda`` or ``cpu`` here and sits with the common
flags, since ``preprocess`` and ``extract`` take it too; flags of code paths
that are not ported are still parsed, and ``train/driver.py`` refuses the
values it cannot honour.
"""

from __future__ import annotations

import argparse

from pytorch_scalablefhvae_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    FeatureConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)


def add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", type=str, default="timit",
                   choices=["timit", "librispeech", "synthetic"], help="Dataset to use")
    p.add_argument("--raw-data-dir", type=str, default=None, help="Location of the raw data")
    p.add_argument("--feat-type", "--feat_type", dest="feat_type", type=str, default="fbank",
                   choices=["fbank", "spec"],
                   help="Feature type to compute (only affects numpy data)")
    p.add_argument("--data-format", type=str, default="numpy", choices=["kaldi", "numpy"],
                   help="Format used to store data")
    p.add_argument("--sample-rate", type=int, default=None,
                   help="Sample rate to use for resampling audio samples")
    p.add_argument("--win-size", type=float, default=0.025,
                   help="Window size for spectrogram in seconds")
    p.add_argument("--hop-size", type=float, default=0.010,
                   help="Window stride for spectrogram in seconds")
    p.add_argument("--mels", type=int, default=80, help="Number of filter banks")
    p.add_argument("--extractor", type=str, default="numpy", choices=["numpy", "jax"],
                   help="Feature extractor backend: host numpy, or jax = "
                        "batched on the CUDA device (the name saved runs "
                        "carry; --device picks the device)")
    p.add_argument("--fbank-pallas", type=str, default="auto",
                   choices=["never", "always", "auto"],
                   help="Fused log-mel kernel in the jax extractor: auto "
                        "and always launch it on --device cuda and run its "
                        "plain version on --device cpu; never is refused "
                        "on cuda")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda runs the CUDA kernels; cpu their plain PyTorch "
                        "versions. The host extractors ignore it")
    p.add_argument("--fbank-conf", type=str, default="./misc/fbank.conf",
                   help="Path to the fbank.conf used by the kaldi-semantics extractor")
    p.add_argument("--kaldi-root", type=str, default="./kaldi/",
                   help="Accepted for reference-CLI parity; extraction is in-process")
    p.add_argument("--dither-seed", type=int, default=0,
                   help="Seed for the deterministic dither stream (kaldi-semantics "
                        "extractor; the reference's dither was unseeded)")
    p.add_argument("--num-workers", type=int, default=0,
                   help=">1 fans per-utterance feature extraction over a "
                        "process pool (outputs identical to sequential)")
    p.add_argument("--synthetic-speakers", type=int, default=4,
                   help="Synthetic corpus: number of generated speakers "
                        "(probe chance = 1/N; the quality harness uses 64)")
    p.add_argument("--synthetic-utts", type=int, default=3,
                   help="Synthetic corpus: utterances per speaker "
                        "(>=3 reserves one dev + one test utt per speaker)")
    p.add_argument("--train-list", type=str, nargs="+", default=None,
                   help="LibriSpeech training subsets (default: train-clean-100)")
    p.add_argument("--dev-list", type=str, nargs="+", default=None,
                   help="LibriSpeech dev subsets (default: dev-clean dev-other)")
    p.add_argument("--test-list", type=str, nargs="+", default=None,
                   help="LibriSpeech test subsets (default: test-clean test-other)")


def add_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model-type", type=str, default="fhvae",
                   choices=["fhvae", "simple_fhvae"], help="Model architecture")
    p.add_argument("--alpha-dis", type=float, default=10.0,
                   help="Discriminative objective weight")
    p.add_argument("--epochs", type=int, default=100, help="Number of maximum training epochs")
    p.add_argument("--patience", type=int, default=10,
                   help="Number of maximum consecutive non-improving epochs")
    p.add_argument("--preprocessed", action="store_true", dest="is_preprocessed",
                   help="Use this flag if the data is already preprocessed")
    p.add_argument("--learning-rate", type=float, default=0.001, help="Learning rate")
    p.add_argument("--beta-one", type=float, default=0.95, help="Beta1 for Adam")
    p.add_argument("--beta-two", type=float, default=0.999, help="Beta2 for Adam")
    p.add_argument("--min-len", type=int, default=None,
                   help="Minimum sequence length; defaults to the segment length")
    p.add_argument("--pack-cache-dir", type=str, default=None,
                   help="Persist+memmap packed feature arrays here (corpus-scale splits)")
    p.add_argument("--transfer-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="Feature-batch dtype shipped host->device; bfloat16 "
                        "halves input-link bytes (model upcasts on entry); "
                        "int8 quantizes the staged store per-column to "
                        "uint8 (Kaldi CompressedMatrix semantics, 4x fewer "
                        "link bytes; device/stream placements only — host "
                        "loaders ship float32)")
    p.add_argument("--data-placement", type=str, default="auto",
                   choices=["host", "device", "stream", "auto"],
                   help="Training-batch source: host loader, device-resident "
                        "packed store (staged in device memory; steps gather on device), "
                        "stream (chunked double-buffered staging for "
                        "corpora larger than the budget), or auto (device "
                        "iff the store fits the budget, else stream)")
    p.add_argument("--device-store-max-bytes", type=int, default=4 << 30,
                   help="auto placement budget for the staged store, bytes")
    p.add_argument("--stream-chunk-bytes", type=int, default=0,
                   help="Bytes per streamed chunk (0 = budget // 4)")
    p.add_argument("--epoch-plan", type=str, default="host",
                   choices=["host", "device"],
                   help="Device-resident epoch schedule: host uploads the "
                        "shuffled index plan (O(segments)/epoch, matches the "
                        "host loader's order exactly), device derives it "
                        "on the device from per-sequence metadata + a PRNG key "
                        "(recurring upload is one key; fixed windowing only)")
    p.add_argument("--shard-device-store", action="store_true",
                   help="Row-shard the staged store over the mesh's model "
                        "axis (m-fold capacity; an all-reduce rebuilds segments)")
    p.add_argument("--mvn-path", type=str, default=None,
                   help="Path to a precomputed mean/variance normalization file")
    p.add_argument("--seg-len", type=int, default=20, help="Segment length to use")
    p.add_argument("--seg-shift", type=int, default=8,
                   help="Segment shift if rand-seg is false; otherwise "
                        "floor(seq_len/seg_shift) segments are extracted per sequence")
    p.add_argument("--rand-seg", type=lambda s: s.lower() in ("true", "1"), default=False,
                   help="If true, segments are randomly extracted")
    p.add_argument("--training-batch-size", type=int, default=None,
                   help="Training batch size (default: 256 for simple_fhvae "
                        "— reference parity, train_model.py:133-138 — and "
                        "1024 for the recurrent fhvae, whose fused "
                        "recurrence is dependent-op latency-bound at small "
                        "batches)")
    p.add_argument("--dev-batch-size", type=int, default=2048, help="Dev-eval batch size")
    p.add_argument("--z1-hus", type=int, default=[128, 128], nargs=2,
                   help="Hidden units for the two z1 encoder layers")
    p.add_argument("--z2-hus", type=int, default=[128, 128], nargs=2,
                   help="Hidden units for the two z2 encoder layers")
    p.add_argument("--z1-dim", type=int, default=16, help="Dimensionality of z1")
    p.add_argument("--z2-dim", type=int, default=16, help="Dimensionality of z2")
    p.add_argument("--x-hus", type=int, default=[128, 128], nargs=2,
                   help="Hidden units per decoder layer")
    p.add_argument("--pz2-std", type=float, default=0.5,
                   help="Std of the z2 prior p(z2|mu2) (simple_fhvae.py:88)")
    p.add_argument("--mu2-init-std", type=float, default=1.0,
                   help="Init std of the learnable mu2 table")
    p.add_argument("--use-pallas", type=str, default="auto",
                   choices=["auto", "never", "always"],
                   help="Streaming discriminative softmax kernel selection")
    p.add_argument("--lstm-pallas", type=str, default="auto",
                   choices=["auto", "never", "always"],
                   help="Fused LSTM recurrence kernel (fhvae); never = step by step")
    p.add_argument("--lstm-mm-dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="Matmul operand dtype inside the fused LSTM "
                        "recurrence (carries/accumulation stay fp32); "
                        "float32 restores bit-parity with the step-by-step path")
    p.add_argument("--scan-unroll", type=int, default=20,
                   help="Unroll of the step-by-step LSTM recurrences")
    p.add_argument("--seed", type=int, default=0, help="PRNG seed")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"], help="Matmul compute dtype")
    p.add_argument("--donate-state", type=lambda s: s.lower() in ("true", "1"),
                   default=True,
                   help="Update the train state in place (disable for "
                        "debugging)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="Capture a profiler trace of one training epoch into this directory")
    p.add_argument("--profile-epoch", type=int, default=1,
                   help="Epoch at which to capture the profiler trace")
    p.add_argument("--tensorboard", action="store_true", help="Enable TensorBoard logging")
    p.add_argument("--visdom", action="store_true",
                   help="Write per-epoch training curves to <exp_dir>/curves.svg "
                        "(the reference Visdom plot, file-based)")
    p.add_argument("--tb-log-dir", default="./visualize/tensorboard",
                   help="Location of tensorboard log")
    p.add_argument("--log-params", action="store_true",
                   help="Log parameter histograms")
    p.add_argument("--continue-from", type=str, default=None,
                   help="Checkpoint for continuing training")
    p.add_argument("--finetune", action="store_true",
                   help="Fine-tune from the checkpoint (weights only)")
    p.add_argument("--resume-override", action="append", default=None,
                   metavar="FIELD=VALUE",
                   help="On resume, override a saved-config field (e.g. "
                        "'epochs=200' or 'train.patience=20'); repeatable. "
                        "The explicit escape hatch from the saved-config-wins "
                        "resume policy")
    p.add_argument("--hierarchical", action="store_true", dest="sample_hierarchical",
                   help="Use hierarchical sampling over sequence subsets")
    p.add_argument("--num-hierarchical-sequences", type=int, default=5000,
                   help="Number of sequences per hierarchical sampling round")
    p.add_argument("--hierarchical-round-epochs", type=int, default=1,
                   help="Epochs trained per sampled subset before "
                        "resampling + MAP re-init (the reference trains ONE "
                        "subset for the whole run; >1 amortizes the round "
                        "turnover)")
    p.add_argument("--map-init-chunk-skip", type=int, default=8,
                   help="Round-turnover MAP init encodes every Nth chunk of "
                        "16 consecutive windows (1 = every window; applies "
                        "to both the device pass and the host loader). The "
                        "init is refined by the round's training "
                        "immediately; dev-eval MAP tables always use every "
                        "window")
    p.add_argument("--legacy", action="store_true",
                   help="Emulate original-paper behavior (step-based epochs)")
    p.add_argument("--steps-per-epoch", type=int, default=5000,
                   help="Training steps per legacy epoch")
    p.add_argument("--log-interval", type=int, default=200,
                   help="Step interval for printing info (legacy)")
    p.add_argument("--exp-root", type=str, default="./experiments",
                   help="Root directory for experiment outputs")
    p.add_argument("--data-root", type=str, default=".",
                   help="Root directory holding preprocessed datasets")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="Bundle K optimizer steps per dispatched device program")
    p.add_argument("--ckpt-backend", type=str, default="npz", choices=["npz", "orbax"],
                   help="Checkpoint backend: portable npz or async sharded orbax")
    p.add_argument("--ckpt-every-steps", type=int, default=0,
                   help="Also checkpoint every N optimizer steps mid-epoch "
                        "(0 = per epoch only); resume continues mid-epoch "
                        "from the saved plan cursor")
    p.add_argument("--max-steps", type=int, default=0,
                   help="Stop after N optimizer steps (global), saving a "
                        "mid-epoch checkpoint at the boundary (0 = run to "
                        "the epoch budget)")
    p.add_argument("--debug-nans", action="store_true",
                   help="Trap the first NaN-producing op")
    p.add_argument("--multihost", action="store_true",
                   help="Initialize the multi-host runtime")
    p.add_argument("--mesh", type=str, default=None,
                   help="Device mesh as 'data,model' (e.g. '8,1'); default: all devices data-parallel")


def _default_batch(args: argparse.Namespace) -> int:
    """Model-aware training-batch default: 256 for simple_fhvae (reference
    parity, train_model.py:133-138); 1024 for the recurrent fhvae — a stub
    in the reference (fhvae.py:14), so its default is ours to set, and the
    fused recurrence is dependent-op latency-bound at small batches."""
    explicit = getattr(args, "training_batch_size", None)
    if explicit is not None:
        return explicit
    model_type = getattr(args, "model_type", "simple_fhvae")
    return 1024 if model_type == "fhvae" else 256


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    mesh_shape = (1, 1)
    if getattr(args, "mesh", None):
        parts = tuple(int(x) for x in args.mesh.split(","))
        mesh_shape = (parts + (1, 1))[:2]
    subset_kw = {}
    for name, field in (("train_list", "train_list"), ("dev_list", "dev_list"),
                        ("test_list", "test_list")):
        v = getattr(args, name, None)
        if v:
            subset_kw[field] = tuple(v)
    return ExperimentConfig(
        features=FeatureConfig(
            feat_type=args.feat_type,
            extractor=getattr(args, "extractor", "numpy"),
            fbank_pallas=getattr(args, "fbank_pallas", "auto"),
            data_format=args.data_format,
            sample_rate=args.sample_rate,
            win_t=args.win_size,
            hop_t=args.hop_size,
            n_mels=args.mels,
            dither_seed=getattr(args, "dither_seed", 0),
            num_workers=getattr(args, "num_workers", 0),
        ),
        data=DataConfig(
            dataset=args.dataset,
            raw_data_dir=args.raw_data_dir,
            min_len=getattr(args, "min_len", None),
            mvn_path=getattr(args, "mvn_path", None),
            seg_len=getattr(args, "seg_len", 20),
            seg_shift=getattr(args, "seg_shift", 8),
            rand_seg=getattr(args, "rand_seg", False),
            training_batch_size=_default_batch(args),
            pack_cache_dir=getattr(args, "pack_cache_dir", None),
            dev_batch_size=getattr(args, "dev_batch_size", 2048),
            transfer_dtype=getattr(args, "transfer_dtype", "float32"),
            data_placement=getattr(args, "data_placement", "auto"),
            device_store_max_bytes=getattr(args, "device_store_max_bytes", 4 << 30),
            stream_chunk_bytes=getattr(args, "stream_chunk_bytes", 0),
            epoch_plan=getattr(args, "epoch_plan", "host"),
            shard_device_store=getattr(args, "shard_device_store", False),
            synthetic_speakers=getattr(args, "synthetic_speakers", 4),
            synthetic_utts=getattr(args, "synthetic_utts", 3),
            **subset_kw,
        ),
        model=ModelConfig(
            model_type=getattr(args, "model_type", "simple_fhvae"),
            z1_hus=tuple(getattr(args, "z1_hus", (128, 128))),
            z2_hus=tuple(getattr(args, "z2_hus", (128, 128))),
            z1_dim=getattr(args, "z1_dim", 16),
            z2_dim=getattr(args, "z2_dim", 16),
            x_hus=tuple(getattr(args, "x_hus", (128, 128))),
            compute_dtype=getattr(args, "compute_dtype", "float32"),
            pz2_std=getattr(args, "pz2_std", 0.5),
            mu2_init_std=getattr(args, "mu2_init_std", 1.0),
            use_pallas=getattr(args, "use_pallas", "auto"),
            lstm_pallas=getattr(args, "lstm_pallas", "auto"),
            lstm_mm_dtype=getattr(args, "lstm_mm_dtype", "bfloat16"),
            scan_unroll=getattr(args, "scan_unroll", 20),
        ),
        optim=OptimConfig(
            learning_rate=getattr(args, "learning_rate", 1e-3),
            beta_one=getattr(args, "beta_one", 0.95),
            beta_two=getattr(args, "beta_two", 0.999),
            alpha_dis=getattr(args, "alpha_dis", 10.0),
        ),
        train=TrainConfig(
            epochs=getattr(args, "epochs", 100),
            profile_dir=getattr(args, "profile_dir", None),
            profile_epoch=getattr(args, "profile_epoch", 1),
            donate_state=getattr(args, "donate_state", True),
            patience=getattr(args, "patience", 10),
            seed=getattr(args, "seed", 0),
            legacy=getattr(args, "legacy", False),
            steps_per_epoch=getattr(args, "steps_per_epoch", 5000),
            log_interval=getattr(args, "log_interval", 200),
            sample_hierarchical=getattr(args, "sample_hierarchical", False),
            ckpt_backend=getattr(args, "ckpt_backend", "npz"),
            ckpt_every_steps=getattr(args, "ckpt_every_steps", 0),
            max_steps=getattr(args, "max_steps", 0),
            steps_per_dispatch=getattr(args, "steps_per_dispatch", 1),
            num_hierarchical_sequences=getattr(args, "num_hierarchical_sequences", 5000),
            hierarchical_round_epochs=getattr(
                args, "hierarchical_round_epochs", 1),
            map_init_chunk_skip=getattr(args, "map_init_chunk_skip", 8),
            tensorboard=getattr(args, "tensorboard", False),
            tb_log_dir=getattr(args, "tb_log_dir", "./visualize/tensorboard"),
            log_params=getattr(args, "log_params", False),
            plot_curves=getattr(args, "visdom", False),
            mesh_shape=mesh_shape,
        ),
    )
