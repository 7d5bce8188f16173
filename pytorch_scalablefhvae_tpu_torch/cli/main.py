"""Command line of the PyTorch/CUDA port: counterpart of ``cli/main.py``.

    python -m pytorch_scalablefhvae_tpu_torch.cli.main preprocess --dataset ...
    python -m pytorch_scalablefhvae_tpu_torch.cli.main extract DATASET_DIR ...
    python -m pytorch_scalablefhvae_tpu_torch.cli.main train --preprocessed ...
    python -m pytorch_scalablefhvae_tpu_torch.cli.main encode EXP_DIR AUDIO...
    python -m pytorch_scalablefhvae_tpu_torch.cli.main serve EXP_DIR

``preprocess``, ``extract`` and ``train`` take the JAX CLI's flags (this
package's copy of ``cli/args.py``); ``--device`` is ``cuda`` (the default)
or ``cpu`` everywhere, and cuda fails where no GPU is present. Of the feature
extractors only ``--extractor jax`` (batched on the CUDA device) uses the
device; the host extractors ignore it. ``train`` raises for the settings
whose code paths are not yet ported (``train/driver.py`` ``check_ported``).
``encode`` and ``serve`` take the JAX CLI's flags plus ``--device``.
``prep-timit`` and ``prep-librispeech`` write the corpus manifests. ``eval``,
``probe`` and ``import-checkpoint`` exist here only to say that they are not
yet ported. Exit codes as the JAX CLI's: 0, or 2 when training diverged.
"""

from __future__ import annotations

import argparse
import sys

NOT_YET_PORTED = ("eval", "probe", "import-checkpoint")


def _cmd_preprocess(args) -> int:
    from pytorch_scalablefhvae_tpu_torch.cli.args import config_from_args
    from pytorch_scalablefhvae_tpu_torch.features.pipeline import (
        preprocess_data,
    )

    paths = preprocess_data(config_from_args(args), root=args.data_root,
                            fbank_conf=args.fbank_conf, device=args.device)
    for split, d in paths.items():
        print(split, {k: str(v) for k, v in d.items()})
    return 0


def _cmd_extract(args) -> int:
    from pytorch_scalablefhvae_tpu_torch.features.extract import (
        prepare_jax,
        prepare_kaldi,
        prepare_numpy,
    )

    sets = [args.set_name] if args.set_name else ["train", "dev", "test"]
    for s in sets:
        if args.data_format == "kaldi":
            prepare_kaldi(args.dataset_dir, s, args.fbank_conf,
                          sample_rate=args.sample_rate)
        elif args.extractor == "jax":
            prepare_jax(args.dataset, s, args.dataset_dir, ftype=args.feat_type,
                        sample_rate=args.sample_rate, win_t=args.win_size,
                        hop_t=args.hop_size, n_mels=args.mels,
                        device=args.device)
        else:
            prepare_numpy(args.dataset, s, args.dataset_dir, ftype=args.feat_type,
                          sample_rate=args.sample_rate, win_t=args.win_size,
                          hop_t=args.hop_size, n_mels=args.mels)
    return 0


def _cmd_prep_timit(args) -> int:
    from pytorch_scalablefhvae_tpu_torch.corpus.timit import process_timit

    process_timit(args.raw_data_dir, args.output_dir, args.dev_spk, args.test_spk)
    return 0


def _cmd_prep_librispeech(args) -> int:
    from pytorch_scalablefhvae_tpu_torch.corpus.librispeech import (
        process_librispeech,
    )

    process_librispeech(
        args.raw_data_dir, args.output_dir, args.data_format,
        args.train_list, args.dev_list, args.test_list,
    )
    return 0


def _cmd_train(args) -> int:
    from pytorch_scalablefhvae_tpu_torch.cli.args import config_from_args
    from pytorch_scalablefhvae_tpu_torch.train.driver import train_from_config

    for flag, value in (("--use-pallas", args.use_pallas),
                        ("--lstm-pallas", args.lstm_pallas)):
        if value != "auto":
            raise NotImplementedError(
                f"{flag} {value}: the port always runs its CUDA kernels on "
                f"--device cuda and their plain versions on --device cpu")
    overrides = {}
    for item in args.resume_override or []:
        if "=" not in item:
            raise SystemExit(
                f"--resume-override expects FIELD=VALUE, got {item!r}")
        k, _, v = item.partition("=")
        overrides[k.strip()] = v.strip()
    result = train_from_config(
        config_from_args(args), data_root=args.data_root,
        exp_root=args.exp_root, is_preprocessed=args.is_preprocessed,
        continue_from=args.continue_from, finetune=args.finetune,
        fbank_conf=args.fbank_conf, resume_overrides=overrides or None,
        device=args.device)
    return 2 if result.diverged else 0


def _cmd_encode(args) -> int:
    from pytorch_scalablefhvae_tpu_torch.eval.encode import encode_audio

    encode_audio(args.exp_dir, args.audio, step=args.step,
                 output_dir=args.output_dir, batch_size=args.batch_size,
                 sample_rate=args.sample_rate, device=args.device)
    return 0


def _cmd_serve(args) -> int:
    from pytorch_scalablefhvae_tpu_torch.eval.serve import serve

    return serve(args.exp_dir, step=args.step, batch_size=args.batch_size,
                 device=args.device)


def _cmd_not_ported(args) -> int:
    print(f"sfhvae {args.command}: not yet ported to PyTorch (ROADMAP.md); "
          f"run it with python -m pytorch_scalablefhvae_tpu.cli.main",
          file=sys.stderr)
    return 2


def _add_run_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("exp_dir", type=str, help="Experiment directory")
    p.add_argument("--step", type=int, default=-1,
                   help="Epoch checkpoint to load; -1 loads the best checkpoint")
    p.add_argument("--batch-size", type=int, default=2048,
                   help="Segment batch size for the encoder passes")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda runs the CUDA kernels; cpu their plain "
                        "PyTorch versions")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sfhvae-torch",
        description="ScalableFHVAE on PyTorch/CUDA",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    from pytorch_scalablefhvae_tpu_torch.cli.args import (
        add_common_flags,
        add_train_flags,
    )

    p = sub.add_parser("preprocess", help="Prepare corpus + extract features",
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_flags(p)
    p.add_argument("--data-root", type=str, default=".",
                   help="Output root for datasets")
    p.set_defaults(fn=_cmd_preprocess)

    p = sub.add_parser("train", help="Train a model",
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_flags(p)
    add_train_flags(p)
    p.set_defaults(fn=_cmd_train)

    p = sub.add_parser(
        "extract",
        help="Feature extraction for existing wav.scp manifests "
             "(prepare_numpy_data.py / prepare_kaldi_data.py parity)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("dataset_dir", type=str,
                   help="Directory containing <set>/wav.scp manifests")
    p.add_argument("--set-name", "--set_name", dest="set_name", type=str,
                   default=None,
                   help="Set {train, dev, test} to operate on; all three if "
                        "omitted")
    add_common_flags(p)
    p.set_defaults(fn=_cmd_extract)

    p = sub.add_parser(
        "encode",
        help="Encode raw audio with a trained experiment: features (the "
             "run's exact config + MVN) -> segments -> z1/z2 latents + "
             "per-utterance mu2 MAP, written as npz",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _add_run_flags(p)
    p.add_argument("audio", type=str, nargs="+",
                   help="Audio files, directories, or wav.scp manifests")
    p.add_argument("--output-dir", type=str, default="./encoded",
                   help="Where to write latents.npz + sequences.json")
    p.add_argument("--sample-rate", type=int, default=None,
                   help="Resample all inputs to this rate. Must match the "
                        "run's configured rate when one is set")
    p.set_defaults(fn=_cmd_encode)

    p = sub.add_parser(
        "serve",
        help="Persistent encode server: load the experiment once, then "
             "answer JSONL encode requests on stdin (see eval/serve.py)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _add_run_flags(p)
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser("prep-timit", help="Generate TIMIT wav.scp manifests",
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("raw_data_dir", type=str, help="TIMIT raw data directory")
    p.add_argument("output_dir", type=str, help="Directory for data output")
    p.add_argument("--dev_spk", type=str, default="./misc/timit_dev_spk.list")
    p.add_argument("--test_spk", type=str, default="./misc/timit_test_spk.list")
    p.set_defaults(fn=_cmd_prep_timit)

    p = sub.add_parser("prep-librispeech",
                       help="Generate LibriSpeech wav.scp manifests",
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("raw_data_dir", type=str,
                   help="LibriSpeech raw data directory")
    p.add_argument("output_dir", type=str, help="Directory for data output")
    p.add_argument("--data-format", type=str, default="numpy",
                   choices=["numpy", "kaldi"])
    p.add_argument("--train_list", type=str, nargs="*",
                   default=["train-clean-100"])
    p.add_argument("--dev_list", type=str, nargs="*",
                   default=["dev-clean", "dev-other"])
    p.add_argument("--test_list", type=str, nargs="*",
                   default=["test-clean", "test-other"])
    p.set_defaults(fn=_cmd_prep_librispeech)

    for name in NOT_YET_PORTED:
        p = sub.add_parser(name, help="not yet ported", add_help=False)
        p.set_defaults(fn=_cmd_not_ported)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if extra and args.fn is not _cmd_not_ported:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
