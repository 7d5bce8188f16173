"""Command line of the PyTorch/CUDA port: counterpart of ``cli/main.py``.

    python -m pytorch_scalablefhvae_tpu_torch.cli.main train --preprocessed ...
    python -m pytorch_scalablefhvae_tpu_torch.cli.main encode EXP_DIR AUDIO...
    python -m pytorch_scalablefhvae_tpu_torch.cli.main serve EXP_DIR

``train`` takes the JAX CLI's flags (the shared ``cli/args.py``); its
``--device`` is ``cuda`` (the default) or ``cpu`` here, and the settings
whose code paths are not yet ported raise (``train/driver.py``
``check_ported``). ``encode`` and ``serve`` take the JAX CLI's flags plus
``--device cuda|cpu`` (cuda fails where no GPU is present). The JAX CLI's
other subcommands exist here only to say that they are not yet ported.
Exit codes as the JAX CLI's: 0, or 2 when training diverged.
"""

from __future__ import annotations

import argparse
import sys

NOT_YET_PORTED = ("preprocess", "eval", "probe", "extract",
                  "import-checkpoint", "prep-timit", "prep-librispeech")


def _cmd_train(args) -> int:
    from pytorch_scalablefhvae_tpu.cli.args import config_from_args
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

    from pytorch_scalablefhvae_tpu.cli.args import (
        add_common_flags,
        add_train_flags,
    )

    p = sub.add_parser("train", help="Train a model",
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add_common_flags(p)
    add_train_flags(p)
    # the shared flags' --device defaults to tpu; here it is cuda or cpu
    (device,) = (a for a in p._actions if a.dest == "device")
    device.choices = ["cuda", "cpu"]
    device.help = "cuda runs the CUDA kernels; cpu their plain PyTorch versions"
    p.set_defaults(fn=_cmd_train, device="cuda")

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
