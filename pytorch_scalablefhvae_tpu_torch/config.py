"""Typed experiment configuration: the port's own copy of ``config.py``.

The field names, defaults and JSON layout are the JAX package's, so one
``config.json`` means the same run to both packages and an experiment
trained by either loads in the other. Fields that select something this
package has not ported keep their place; ``train/driver.py`` refuses the
values it cannot honour.

Covers the full flag surface of the reference CLI (reference:
train_model.py:25-238, preprocess_data.py:76-130, eval_model.py:10-39) as
dataclasses, serialized as JSON alongside checkpoints (the reference pickled
argparse namespaces, reference utils.py:105-113 — see SURVEY.md B14 for why
JSON is used here instead).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass(frozen=True)
class FeatureConfig:
    """Feature-extraction settings.

    Defaults mirror the reference (train_model.py:86-104 and
    misc/fbank.conf:1-9): 16 kHz audio, 25 ms window, 10 ms hop, 80 mel bins,
    hamming window, pre-emphasis 0.97.
    """

    feat_type: str = "fbank"  # "fbank" | "spec"
    data_format: str = "numpy"  # "numpy" | "kaldi"
    extractor: str = "numpy"  # "numpy" (host) | "jax" (batched, on the CUDA device)
    sample_rate: int | None = None  # resample target; None = native rate
    win_t: float = 0.025
    hop_t: float = 0.010
    n_mels: int = 80
    window: str = "hamming"
    preemphasis: float = 0.97
    # librosa-semantics path (numpy/jax backends)
    mel_norm: str = "slaney"
    log_floor_spec: float = -50.0
    log_floor_mel: float = -20.0
    # fused log-mel kernel in the "jax" extractor (ops/fbank_cuda.py):
    # "never" | "always" | "auto". Here "auto" and "always" both launch the
    # kernel on a CUDA device and run its plain version on the CPU; "never"
    # is refused on a CUDA device (features/dsp_torch.py)
    fbank_pallas: str = "auto"
    # kaldi-semantics path (native backend; misc/fbank.conf parity)
    dither: float = 1.0
    remove_dc_offset: bool = True
    use_energy: bool = False
    htk_compat: bool = True
    dither_seed: int = 0  # reference dither is unseeded; ours is deterministic
    # >1 fans per-utterance extraction over a process pool (reference
    # Pool(3)/Pool(8) capability); outputs are identical to sequential.
    # Default sequential: on single-core hosts a pool only adds overhead.
    num_workers: int = 0
    # kaldi format: the PARSED --fbank-conf kwargs, persisted into the run's
    # config at train time (train/driver.py) so encode/serve rebuild
    # features with the run's exact conf — without this, a custom conf
    # (e.g. --window-type=povey) would extract training features one way
    # and serving features another, silently (shapes still match)
    fbank_conf_kwargs: dict | None = None

    @property
    def n_fft(self) -> int:
        """librosa path: n_fft == win_length (prepare_numpy_data.py:38,47)."""
        sr = self.sample_rate or 16000
        return int(sr * self.win_t)


@dataclass(frozen=True)
class DataConfig:
    """Segment-dataset settings (reference datasets.py:50-98)."""

    dataset: str = "timit"  # "timit" | "librispeech" | "synthetic"
    raw_data_dir: str | None = None
    min_len: int | None = None  # None -> seg_len (train_model.py:269-270)
    mvn_path: str | None = None
    seg_len: int = 20
    seg_shift: int = 8
    rand_seg: bool = False
    training_batch_size: int = 256
    dev_batch_size: int = 2048
    # persist + memmap the packed feature arrays (corpus-scale splits)
    pack_cache_dir: str | None = None
    # dtype of feature batches shipped host->device ("float32" | "bfloat16"
    # | "int8"); bfloat16 halves input-link bytes (and the staged store's
    # device memory), the model upcasts on entry. int8 quantizes the staged store
    # per-column to affine uint8 (data/quantize.py — Kaldi CompressedMatrix
    # semantics): 4x fewer link bytes / 4x staging capacity, dequantized
    # on the device after the gather; applies to device/stream placements (host
    # loaders ship float32)
    transfer_dtype: str = "float32"
    # where training batches come from: "host" (loader ships every batch),
    # "device" (packed store staged in device memory once; steps gather on device),
    # "stream" (chunked double-buffered staging for corpora larger than the
    # budget; link carries each frame once per epoch, windows materialize
    # on device — data/stream_store.py), or "auto" (device iff the store
    # fits device_store_max_bytes, else stream; legacy and hierarchical
    # runs fall back to host).
    data_placement: str = "auto"
    device_store_max_bytes: int = 4 << 30
    # bytes per streamed chunk (0 = device_store_max_bytes // 4: two staged
    # chunks plus a draining dispatch's references stay within budget, with
    # a quarter left for the staged dev split)
    stream_chunk_bytes: int = 0
    # how the per-epoch segment schedule is produced on the device-resident
    # path: "host" uploads the shuffled index plan (O(segments) int32 per
    # epoch/round; bit-identical to the host loader's order, which the
    # host/device equivalence guarantee relies on) or "device" derives it
    # on the device from O(S) per-sequence metadata + a PRNG key —
    # recurring upload drops
    # to one key; requires deterministic windowing (not rand_seg)
    epoch_plan: str = "host"
    # row-shard the staged store over the mesh's "model" axis (m-fold
    # capacity; segments rebuilt with an all-reduce per step)
    shard_device_store: bool = False
    # synthetic-corpus shape (corpus/synthetic.py): speaker count drives the
    # difficulty of the discriminative task and the probes (chance = 1/N);
    # the quality harness (misc/repro_quality.sh) runs 64 x 5
    synthetic_speakers: int = 4
    synthetic_utts: int = 3
    # librispeech subset lists (preprocess_librispeech.py:98-103; B17 fixed:
    # test list is test-clean + test-other)
    train_list: tuple[str, ...] = ("train-clean-100",)
    dev_list: tuple[str, ...] = ("dev-clean", "dev-other")
    test_list: tuple[str, ...] = ("test-clean", "test-other")


@dataclass(frozen=True)
class ModelConfig:
    """Model architecture (reference simple_fhvae.py:8-37, fhvae.py:5-14)."""

    model_type: str = "simple_fhvae"  # "simple_fhvae" | "fhvae"
    z1_hus: tuple[int, ...] = (128, 128)
    z2_hus: tuple[int, ...] = (128, 128)
    z1_dim: int = 16
    z2_dim: int = 16
    x_hus: tuple[int, ...] = (128, 128)
    # priors (simple_fhvae.py:22-23,88): pz1 = N(0,1); pmu2 = N(0,1);
    # pz2 = N(mu2, pz2_std^2)
    pz2_std: float = 0.5
    mu2_init_std: float = 1.0
    # numerics: params fp32; matmuls optionally bf16. The reference
    # trained in fp64 (train_model.py:438); fp32 parameters are a documented
    # deviation (SURVEY.md B15).
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    # streaming discriminative softmax kernel: "auto" | "never" | "always"
    use_pallas: str = "auto"
    # fused LSTM recurrence kernel (ops/lstm_cuda.py), fhvae only; "never"
    # names the step-by-step path, which a CUDA device refuses
    lstm_pallas: str = "auto"
    # matmul operand dtype inside the fused recurrence (weights + hidden
    # states; gates/carries/accumulation stay fp32); "float32" restores
    # bit-parity with the step-by-step path
    lstm_mm_dtype: str = "bfloat16"
    # unroll of the step-by-step LSTM recurrences (fhvae only); kept for
    # config compatibility, unused by the fused kernels
    scan_unroll: int = 20


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer settings (train_model.py:71-79,409-411)."""

    learning_rate: float = 1e-3
    beta_one: float = 0.95
    beta_two: float = 0.999
    alpha_dis: float = 10.0


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop settings (train_model.py:54-68,192-237)."""

    epochs: int = 100
    patience: int = 10
    seed: int = 0
    # legacy per-step epoch emulation (train_model.py:216-237)
    legacy: bool = False
    steps_per_epoch: int = 5000
    log_interval: int = 200
    # hierarchical sampling (train_model.py:203-214,424-436)
    sample_hierarchical: bool = False
    num_hierarchical_sequences: int = 5000
    # epochs trained per sampled subset before resampling + MAP re-init.
    # The reference keeps ONE subset for the whole run
    # (train_model.py:424-436); 1 resamples every epoch (freshest), larger
    # values amortize the round turnover (bench.py hier_round_*)
    hierarchical_round_epochs: int = 1
    # MAP-init subsampling for round turnover: encode every Nth chunk of
    # 16 consecutive windows — applied by BOTH the device pass
    # (device_step.device_map_pass_chunked) and the host-loader
    # fallback (data.segments.chunk_skip_indices feeding the est loader,
    # where it also cuts host->device feature shipping by the factor).
    # The init is immediately refined by the round's Adam steps and z2 is
    # a sequence-level factor carried by every segment, so an 8x burst
    # subsample (still >= 2 chunks = 32 windows of a 1 s utterance)
    # changes the starting table negligibly while cutting the turnover
    # encode 8x.
    # Dev-eval MAP tables always use every window; random windowing
    # (rand_seg) never skips — its windows are already a per-epoch sample.
    map_init_chunk_skip: int = 8
    # observability
    profile_dir: str | None = None  # capture a profiler trace here
    profile_epoch: int = 1  # epoch at which to capture the trace
    tensorboard: bool = False
    tb_log_dir: str = "./visualize/tensorboard"
    log_params: bool = False
    # per-epoch curves.svg in the experiment dir (the reference --visdom
    # flag's counterpart; see train/plots.py)
    plot_curves: bool = False
    # bundle K optimizer steps into one dispatched device program;
    # amortizes per-dispatch overhead, which dominates sub-ms steps. Forced
    # to 1 in legacy mode to keep exact step-boundary semantics. Note: the
    # divergence check is pipelined (it reads the PREVIOUS dispatch's loss so
    # the fetch never stalls the step stream), so a NaN can run up to ~2K
    # optimizer steps before the abort fires — with donate_state the pre-NaN
    # state is unrecoverable by then; epoch-end checkpoints still bound the
    # loss to one epoch.
    steps_per_dispatch: int = 1
    # checkpointing: "npz" (portable single-file) | "orbax" (async sharded)
    ckpt_backend: str = "npz"
    # mid-epoch checkpoint cadence: save every N optimizer steps (0 = per
    # epoch only, the reference's cadence, utils.py:116-152). At corpus
    # scale an epoch is hours; the cadence bounds preemption loss. The
    # sidecar records the epoch-plan cursor (epoch + batches done), so a
    # resume re-derives the same deterministic schedule and continues
    # mid-epoch with the identical trajectory — including hierarchical
    # rounds (subset draws key on the round's boundary epoch). Not
    # supported with legacy step-epochs (their schedule is not a pure
    # function of (seed, epoch)).
    ckpt_every_steps: int = 0
    # stop after this many optimizer steps (global counter), saving a
    # mid-epoch checkpoint at the boundary; 0 = run to the epoch budget
    max_steps: int = 0
    # parallelism: data-parallel and mu2-table (model) mesh axes
    mesh_shape: tuple[int, ...] = (1, 1)  # (data, model)
    donate_state: bool = True


@dataclass(frozen=True)
class ExperimentConfig:
    features: FeatureConfig = field(default_factory=FeatureConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    # ---- experiment naming (reference utils.py:20-42) ----

    def base_string(self) -> str:
        ds = self.data.dataset
        ds += "_np" if self.features.data_format.lower() == "numpy" else "_kd"
        feat = "fbank" if self.features.data_format == "kaldi" else self.features.feat_type
        return f"{ds}_{feat}"

    def exp_string(self) -> str:
        t = self.train
        if t.legacy:
            return (
                f"{self.model.model_type}_e{t.epochs}_s{t.steps_per_epoch}"
                f"_p{t.patience}_a{self.optim.alpha_dis}_legacy"
            )
        return f"{self.model.model_type}_e{t.epochs}_p{t.patience}_a{self.optim.alpha_dis}"

    def run_id(self) -> str:
        return f"{self.base_string()}_{self.exp_string()}"

    def exp_dir(self, exp_root: str | Path = "./experiments") -> Path:
        return Path(exp_root) / self.base_string() / self.exp_string()

    # ---- (de)serialization ----

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ExperimentConfig":
        def build(tp, sub):
            kw = {}
            for f in dataclasses.fields(tp):
                if f.name in sub:
                    v = sub[f.name]
                    if isinstance(v, list):
                        v = tuple(v)
                    kw[f.name] = v
            return tp(**kw)

        return cls(
            features=build(FeatureConfig, d.get("features", {})),
            data=build(DataConfig, d.get("data", {})),
            model=build(ModelConfig, d.get("model", {})),
            optim=build(OptimConfig, d.get("optim", {})),
            train=build(TrainConfig, d.get("train", {})),
        )

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path: str | Path) -> "ExperimentConfig":
        return cls.from_json(Path(path).read_text())

    def replace(self, **sections: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **sections)

    def apply_overrides(self, overrides: dict[str, Any]) -> "ExperimentConfig":
        """Explicit resume-override policy (the fix for reference B14: the
        reference silently replaced ALL live flags with the pickled ones,
        making it impossible to, e.g., extend ``--epochs`` on resume).

        ``overrides`` maps ``"section.field"`` (or a bare field name when it
        is unique across sections) to a new value. String values are parsed
        (ints/floats/bools/None/JSON/comma-tuples). Unknown fields raise.
        """
        section_names = [f.name for f in dataclasses.fields(self)]
        sections = {s: getattr(self, s) for s in section_names}
        for key, raw in overrides.items():
            if "." in key:
                sec_name, fname = key.split(".", 1)
                if sec_name not in sections:
                    raise ValueError(f"Unknown config section {sec_name!r}")
                if fname not in {f.name for f in dataclasses.fields(sections[sec_name])}:
                    raise ValueError(f"Unknown config field {key!r}")
            else:
                fname = key
                homes = [
                    s for s in section_names
                    if fname in {f.name for f in dataclasses.fields(sections[s])}
                ]
                if not homes:
                    raise ValueError(f"Unknown config field {key!r}")
                if len(homes) > 1:
                    raise ValueError(
                        f"Ambiguous override {key!r}: qualify as one of "
                        f"{[f'{h}.{fname}' for h in homes]}"
                    )
                sec_name = homes[0]
            val = _parse_override_value(raw)
            # tuple-typed fields (mesh_shape, subset lists, layer widths):
            # a single value parses as a scalar — wrap it so downstream
            # tuple(...)/iteration semantics hold
            cur = getattr(sections[sec_name], fname)
            if isinstance(cur, tuple) and val is not None and not isinstance(val, tuple):
                val = (val,)
            sections[sec_name] = dataclasses.replace(sections[sec_name], **{fname: val})
        return dataclasses.replace(self, **sections)


def _parse_override_value(raw: Any) -> Any:
    if not isinstance(raw, str):
        return tuple(raw) if isinstance(raw, list) else raw
    low = raw.strip().lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        v = json.loads(raw)
        return tuple(v) if isinstance(v, list) else v
    except (ValueError, json.JSONDecodeError):
        pass
    if "," in raw:
        return tuple(_parse_override_value(p) for p in raw.split(","))
    return raw
