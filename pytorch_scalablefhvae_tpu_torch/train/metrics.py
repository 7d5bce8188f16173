"""Metric recording: counterpart of ``train/metrics.py``.

``MetricHistory`` is the per-epoch history a checkpoint carries (the
reference's ``values`` dict); ``MetricWriter`` appends one JSON record per
epoch to ``<exp_dir>/metrics.jsonl``. TensorBoard and the curves plot are
not yet ported (ROADMAP.md).
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


class MetricWriter:
    """Appends one JSON record per epoch to ``<exp_dir>/metrics.jsonl``."""

    def __init__(self, exp_dir: str | Path, run_id: str):
        self.exp_dir = Path(exp_dir)
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = self.exp_dir / "metrics.jsonl"
        self.run_id = run_id

    def write_epoch(self, epoch: int, scalars: Mapping[str, float]) -> None:
        rec = {"epoch": epoch, "run_id": self.run_id}
        # non-finite values serialize as null: json.dumps' default NaN
        # token is invalid JSON for strict consumers (jq, JSON.parse)
        rec.update({k: (float(v) if math.isfinite(float(v)) else None)
                    for k, v in scalars.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
