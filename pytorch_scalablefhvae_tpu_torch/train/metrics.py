"""Metric recording: counterpart of ``train/metrics.py``.

``MetricHistory`` is the per-epoch history a checkpoint carries (the
reference's ``values`` dict); ``MetricWriter`` appends one JSON record per
epoch to ``<exp_dir>/metrics.jsonl`` and, with ``--tensorboard``, writes the
JAX package's TensorBoard series: each scalar as ``<run_id>/<key>`` at step
``epoch + 1``, and with ``--log-params`` a histogram of every parameter and
of its gradient (``grads/``) under the tag the JAX writer derives from its
params tree (:func:`histogram_tag`), so that a run resumed from a JAX
checkpoint continues the same series. ``torch.utils.tensorboard`` is
imported lazily; where it is missing the writer says so and writes the
JSONL alone, as the JAX writer does. The curves plot is ``train/plots.py``.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Mapping

# metric-history keys, reference train_model.py:505-510 parity
HISTORY_KEYS = (
    "train_loss_results",
    "val_loss_results",
    "lower_bound_results",
    "discrim_loss_results",
)


class MetricHistory:
    """Per-epoch metric history: one JSON-serializable, epoch-keyed dict
    per key of ``HISTORY_KEYS``."""

    def __init__(self, values: Mapping[str, Mapping] | None = None):
        self.values: dict[str, dict[int, float]] = {k: {} for k in HISTORY_KEYS}
        if values:
            for k in HISTORY_KEYS:
                for ep, v in values.get(k, {}).items():
                    self.values[k][int(ep)] = float(v)

    def record(self, epoch: int, train_loss: float, val_loss: float,
               lower_bound: float, discrim_loss: float) -> None:
        self.values["train_loss_results"][epoch] = float(train_loss)
        self.values["val_loss_results"][epoch] = float(val_loss)
        self.values["lower_bound_results"][epoch] = float(lower_bound)
        self.values["discrim_loss_results"][epoch] = float(discrim_loss)

    def to_json_dict(self) -> dict:
        return {k: {str(ep): v for ep, v in d.items()}
                for k, d in self.values.items()}


# keys of the port's JSONL records for its step cadence and, with
# --trace-spans, its spans and counters (``train/trace.py``), which the JAX
# writer's records (and so its TensorBoard series) do not have
JSONL_ONLY = ("train_steps", "train_seconds", "step", "spans", "counters")


def histogram_tag(name: str, prefix: str = "") -> str:
    """The JAX writer's tag of a parameter: its ``tree_flatten_with_path``
    path, quotes removed (``[z2_lstm]/[cells]/[0]/[w]``), from the port's
    dotted name (``z2_lstm.cells.0.w``; ``train/checkpoint.py``)."""
    return prefix + "/".join(f"[{part}]" for part in name.split("."))


class MetricWriter:
    """Writes one JSON record per epoch to ``<exp_dir>/metrics.jsonl`` and,
    with ``tensorboard``, the epoch's scalars (and with ``log_params`` the
    histograms) to an event file in ``tb_log_dir``."""

    def __init__(self, exp_dir: str | Path, run_id: str,
                 tensorboard: bool = False,
                 tb_log_dir: str | Path = "./visualize/tensorboard",
                 log_params: bool = False):
        self.exp_dir = Path(exp_dir)
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = self.exp_dir / "metrics.jsonl"
        self.run_id = run_id
        self.log_params = log_params
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                Path(tb_log_dir).mkdir(parents=True, exist_ok=True)
                self._tb = SummaryWriter(str(tb_log_dir))
            except ImportError as e:
                print(f"TensorBoard unavailable ({e}); falling back to "
                      f"JSONL only")

    def write_epoch(self, epoch: int, scalars: Mapping[str, float],
                    params: Mapping | None = None,
                    grads: Mapping | None = None) -> None:
        """The epoch's record; ``params`` and ``grads`` (name -> tensor, the
        table whole on a mesh) go to histograms under ``--log-params``. A
        mapping among ``scalars`` (``spans``, ``counters``) goes to the
        record as it is."""
        rec = {"epoch": epoch, "run_id": self.run_id}
        # non-finite values serialize as null: json.dumps' default NaN
        # token is invalid JSON for strict consumers (jq, JSON.parse)
        rec.update({k: v if isinstance(v, Mapping) else
                    float(v) if math.isfinite(float(v)) else None
                    for k, v in scalars.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is None:
            return
        for k, v in scalars.items():
            if k not in JSONL_ONLY:
                self._tb.add_scalar(f"{self.run_id}/{k}", float(v), epoch + 1)
        if self.log_params and params is not None:
            self._write_histograms("", params, epoch)
        if self.log_params and grads is not None:
            self._write_histograms("grads/", grads, epoch)
        self._tb.flush()

    def _write_histograms(self, prefix: str, named: Mapping, epoch: int):
        for name, t in named.items():
            self._tb.add_histogram(
                histogram_tag(name, prefix),
                t.detach().float().cpu().numpy().ravel(), epoch + 1)

    # history key -> the per-epoch scalar it records, so that a resumed
    # run's curves continue the same TensorBoard series
    _HISTORY_TO_SCALAR = {
        "train_loss_results": "train_loss",
        "val_loss_results": "val_loss",
        "lower_bound_results": "val_lower_bound",
        "discrim_loss_results": "val_log_qy",
    }

    def replay_history(self, history: MetricHistory, up_to_epoch: int) -> None:
        """Write the epochs before ``up_to_epoch`` of a resumed run's history
        to TensorBoard again."""
        if self._tb is None:
            return
        for ep in range(up_to_epoch):
            for key, tag in self._HISTORY_TO_SCALAR.items():
                if ep in history.values[key]:
                    self._tb.add_scalar(f"{self.run_id}/{tag}",
                                        float(history.values[key][ep]),
                                        ep + 1)
        self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
