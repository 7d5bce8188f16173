"""Command line of the PyTorch/CUDA port: counterpart of ``cli/main.py``.

    python -m pytorch_scalablefhvae_tpu_torch.cli.main encode EXP_DIR AUDIO...
    python -m pytorch_scalablefhvae_tpu_torch.cli.main serve EXP_DIR

``encode`` and ``serve`` take the JAX CLI's flags plus ``--device cuda|cpu``
(default cuda; cuda fails where no GPU is present). The JAX CLI's other
subcommands exist here only to say that they are not yet ported.
"""

from __future__ import annotations

import argparse
import sys

NOT_YET_PORTED = ("preprocess", "train", "eval", "probe", "extract",
                  "import-checkpoint", "prep-timit", "prep-librispeech")


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
