"""Command line of the PyTorch/CUDA port: counterpart of ``cli/main.py``.

    python -m pytorch_scalablefhvae_tpu_torch.cli.main preprocess --dataset ...
    python -m pytorch_scalablefhvae_tpu_torch.cli.main extract DATASET_DIR ...
    python -m pytorch_scalablefhvae_tpu_torch.cli.main train --preprocessed ...
    python -m pytorch_scalablefhvae_tpu_torch.cli.main encode EXP_DIR AUDIO...
    python -m pytorch_scalablefhvae_tpu_torch.cli.main serve EXP_DIR
    python -m pytorch_scalablefhvae_tpu_torch.cli.main eval EXP_DIR ...
    python -m pytorch_scalablefhvae_tpu_torch.cli.main probe EXP_DIR ...
    python -m pytorch_scalablefhvae_tpu_torch.cli.main import-checkpoint ...

``preprocess``, ``extract`` and ``train`` take the JAX CLI's flags (this
package's copy of ``cli/args.py``); ``--device`` is ``cuda`` (the default)
or ``cpu`` everywhere, and cuda fails where no GPU is present. Of the feature
extractors only ``--extractor jax`` (batched on the CUDA device) uses the
device; the host extractors ignore it. ``train`` runs every setting of the
JAX CLI's, ``--ckpt-backend orbax`` (``train/orbax_backend.py``) included.
``encode``, ``serve``, ``eval`` and ``probe`` take the JAX CLI's flags
plus ``--device``; ``probe`` runs ``eval`` first when the split has no
``latents.npz`` yet.
``train --mesh d,m`` trains on ``d * m`` ranks, one process each: batch
rows split over the ``d`` data ranks, the mu2 table row-sharded over the
``m`` model ranks (``parallel/``). On one machine the command starts its
ranks itself; under a launcher that set ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` every rank runs the
command with ``--distributed``. ``--dist-backend nccl`` (the default) gives
every rank a card of its own; ``gloo`` lets ranks share a card and is what
``--device cpu`` needs.
``prep-timit`` and ``prep-librispeech`` write the corpus manifests.
``import-checkpoint`` converts a reference ``.tar`` checkpoint into a port
checkpoint for ``train --continue-from ... --finetune`` (``compat.py``).
Exit codes as the JAX CLI's: 0, or 2 when training diverged.
"""

from __future__ import annotations

import argparse
import sys


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


def _resume_overrides(args) -> dict | None:
    overrides = {}
    for item in args.resume_override or []:
        if "=" not in item:
            raise SystemExit(
                f"--resume-override expects FIELD=VALUE, got {item!r}")
        k, _, v = item.partition("=")
        overrides[k.strip()] = v.strip()
    return overrides or None


def _train(args, device: str) -> int:
    """One process's training run on ``device``: the whole run, or one rank
    of a mesh whose process group is up."""
    from pytorch_scalablefhvae_tpu_torch.cli.args import config_from_args
    from pytorch_scalablefhvae_tpu_torch.train.driver import train_from_config

    result = train_from_config(
        config_from_args(args), data_root=args.data_root,
        exp_root=args.exp_root, is_preprocessed=args.is_preprocessed,
        continue_from=args.continue_from, finetune=args.finetune,
        fbank_conf=args.fbank_conf, resume_overrides=_resume_overrides(args),
        device=device, trace_spans=args.trace_spans)
    return 2 if result.diverged else 0


def _train_rank(args) -> int:
    """A rank of a mesh: join the launcher's process group (or keep the one
    this process is in), take the rank's device, train."""
    from pytorch_scalablefhvae_tpu_torch.parallel.launch import init_from_env

    return _train(args, init_from_env(args.dist_backend, args.device,
                                      args.dist_timeout))


def _cmd_train(args) -> int:
    import os

    from pytorch_scalablefhvae_tpu_torch.cli.args import config_from_args
    from pytorch_scalablefhvae_tpu_torch.parallel.launch import run_ranks
    from pytorch_scalablefhvae_tpu_torch.parallel.mesh import (
        validate_multihost_mesh,
    )
    from pytorch_scalablefhvae_tpu_torch.train.driver import resolve_run_config

    for flag, value in (("--use-pallas", args.use_pallas),
                        ("--lstm-pallas", args.lstm_pallas)):
        if value != "auto":
            raise NotImplementedError(
                f"{flag} {value}: the port always runs its CUDA kernels on "
                f"--device cuda and their plain versions on --device cpu")
    # the mesh that trains: on a resume the saved config's, unless overridden
    config = resolve_run_config(config_from_args(args), args.continue_from,
                                _resume_overrides(args), verbose=False)
    d, m = config.train.mesh_shape
    if args.distributed:
        world = int(os.environ.get("WORLD_SIZE", 1))
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if world > local:
            validate_multihost_mesh((d, m), world // local, local)
        return _train_rank(args)
    if d * m == 1:
        return _train(args, args.device)
    if args.device == "cuda":
        # once, before the ranks start: they would each run nvcc otherwise
        from pytorch_scalablefhvae_tpu_torch.ops import _build

        _build.build()
    codes = run_ranks(_train_rank, d * m, (args,), backend=args.dist_backend,
                      device=args.device, timeout_s=args.dist_timeout)
    if len(set(codes)) != 1 or codes[0] not in (0, 2):
        print(f"sfhvae train --mesh {d},{m}: the ranks exited with {codes}",
              file=sys.stderr)
        return 1
    return codes[0]


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


def _cmd_eval(args) -> int:
    from pytorch_scalablefhvae_tpu_torch.eval.evaluate import (
        evaluate_experiment,
    )

    result = evaluate_experiment(
        exp_dir=args.exp_dir, set_name=args.set_name, seqlist=args.seqlist,
        step=args.step, data_root=args.data_root, output_dir=args.output_dir,
        num_reconstructions=args.num_reconstructions, device=args.device)
    if args.tensorboard:
        try:
            from torch.utils.tensorboard import SummaryWriter

            w = SummaryWriter(args.tb_log_dir)
            for k, v in result["metrics"].items():
                w.add_scalar(f"eval/{args.set_name}/{k}", float(v), 0)
            w.close()
        except Exception as e:
            print(f"TensorBoard unavailable ({e})")
    return 0


def _cmd_probe(args) -> int:
    import json
    from pathlib import Path

    import numpy as np

    from pytorch_scalablefhvae_tpu_torch.eval.probes import (
        json_safe,
        speaker_probes,
    )
    from pytorch_scalablefhvae_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    lat_dir = Path(args.exp_dir) / "eval" / args.set_name
    if not (lat_dir / "latents.npz").exists():
        from pytorch_scalablefhvae_tpu_torch.eval.evaluate import (
            evaluate_experiment,
        )

        evaluate_experiment(args.exp_dir, set_name=args.set_name,
                            data_root=args.data_root, verbose=False,
                            device=args.device)
    with np.load(lat_dir / "latents.npz") as z:
        lat = {k: z[k] for k in ("z1_mu", "z2_mu", "seq_idx")}
    seq_keys = json.loads((lat_dir / "sequences.json").read_text())
    res = speaker_probes(lat, seq_keys, seed=args.seed, device=device)
    print(json.dumps(json_safe(res), indent=2))
    return 0


def _cmd_import_checkpoint(args) -> int:
    from pytorch_scalablefhvae_tpu_torch.compat import (
        import_reference_checkpoint,
    )

    path = import_reference_checkpoint(args.checkpoint, args.out_dir,
                                       args.num_seqs,
                                       mu2_init_std=args.mu2_init_std)
    print(f"Wrote {path}")
    return 0


def _add_run_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("exp_dir", type=str, help="Experiment directory")
    p.add_argument("--step", type=int, default=-1,
                   help="Epoch checkpoint to load; -1 loads the best checkpoint")
    p.add_argument("--batch-size", type=int, default=2048,
                   help="Segment batch size for the encoder passes")
    _add_device_flag(p)


def _add_device_flag(p: argparse.ArgumentParser) -> None:
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
    p.add_argument("--distributed", action="store_true",
                   help="This process is one rank of a --mesh run that a "
                        "launcher started: join the process group named by "
                        "RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and "
                        "MASTER_PORT. Without it, --mesh d,m starts its d*m "
                        "ranks on this machine itself")
    p.add_argument("--dist-backend", type=str, default="nccl",
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend of a --mesh run: nccl "
                        "gives every rank a card of its own; gloo lets ranks "
                        "share a card (rank %% device count) and is the one "
                        "for --device cpu")
    p.add_argument("--dist-timeout", type=float, default=600.0,
                   help="Seconds a rank waits in a collective before the "
                        "run fails")
    p.add_argument("--trace-spans", action="store_true",
                   help="Record the training loop's spans and counters "
                        "(turnover stages, steps, dispatch load and launch, "
                        "loss reads, dev pass, save) and add their sums to "
                        "each epoch's metrics.jsonl record as 'spans' and "
                        "'counters'; under a profiler each span is also an "
                        "'sfhvae.<name>' range")
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

    p = sub.add_parser("eval", help="Evaluate a trained experiment",
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("exp_dir", type=str, help="Experiment directory")
    p.add_argument("--set-name", type=str, default="dev",
                   choices=["train", "dev", "test"],
                   help="Dataset partition to evaluate")
    p.add_argument("--seqlist", type=str, default=None,
                   help="File listing a subset of sequences to evaluate")
    p.add_argument("--step", type=int, default=-1,
                   help="Epoch checkpoint to load; -1 loads the best checkpoint")
    p.add_argument("--data-root", type=str, default=".",
                   help="Root directory holding preprocessed datasets")
    p.add_argument("--output-dir", type=str, default=None,
                   help="Where to write latents/reconstructions (default: "
                        "exp_dir/eval/<set-name>)")
    p.add_argument("--num-reconstructions", type=int, default=8,
                   help="Number of example segment reconstructions to dump")
    p.add_argument("--tensorboard", action="store_true",
                   help="Also write eval metrics as TensorBoard scalars")
    p.add_argument("--visdom", action="store_true",
                   help="Accepted for reference-CLI parity; metrics go to "
                        "JSON/TensorBoard")
    p.add_argument("--tb-log-dir", default="./visualize/tensorboard",
                   help="Location of tensorboard log")
    _add_device_flag(p)
    p.set_defaults(fn=_cmd_eval)

    p = sub.add_parser("probe", help="Speaker-probe disentanglement "
                       "diagnostic over extracted latents",
                       formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("exp_dir", type=str, help="Experiment directory")
    p.add_argument("--set-name", type=str, default="dev",
                   choices=["train", "dev", "test"])
    p.add_argument("--data-root", type=str, default=".")
    p.add_argument("--seed", type=int, default=0)
    _add_device_flag(p)
    p.set_defaults(fn=_cmd_probe)

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

    p = sub.add_parser(
        "import-checkpoint",
        help="Convert a reference PyTorch .tar checkpoint (utils.py:116-152 "
             "schema) to this framework's npz format for --continue-from "
             "--finetune (the reference never persisted a mu2 table, so the "
             "imported table is fresh and resume is finetune-like)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("checkpoint", type=str, help="Reference .tar checkpoint")
    p.add_argument("out_dir", type=str, help="Output directory for the npz")
    p.add_argument("--num-seqs", type=int, required=True,
                   help="mu2 table rows (training-corpus sequence count)")
    p.add_argument("--mu2-init-std", type=float, default=0.0,
                   help="stddev of the fresh mu2 table (0 = zeros)")
    p.set_defaults(fn=_cmd_import_checkpoint)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
