"""The yardstick of the kernels and the model step: the card's published
peaks (``peaks.json``) and, one module per kernel group or model, the
operations and bytes their work needs, computed from shapes."""

import json
from pathlib import Path

PEAKS = {k: float(v) for k, v in json.loads(
    (Path(__file__).resolve().parent / "peaks.json").read_text()).items()
    if k != "source"}


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor among ``objs`` (tuples and lists opened;
    anything else counts nothing): each input read once, each output written
    once."""
    total = 0
    for o in objs:
        if isinstance(o, (tuple, list)):
            total += tensor_bytes(*o)
        elif hasattr(o, "element_size") and hasattr(o, "numel"):
            total += o.element_size() * o.numel()
    return total
