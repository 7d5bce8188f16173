"""Kaldi-style two-column manifest (.scp) I/O.

On-disk format parity with the reference (`wav.scp`, `feats.scp`, `len.scp`
two-column files; reference datasets.py:13-32, prepare_numpy_data.py:118-119)
so datasets prepared by either framework interoperate.
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Callable, Iterable, Mapping


def read_scp(
    path: str | Path,
    dtype: Callable = str,
    keep_keys: Iterable[str] | None = None,
) -> "OrderedDict[str, object]":
    """Read an scp file into an ordered key->value dict.

    Mirrors reference ``scp2dict`` (datasets.py:13-32): value is everything
    after the first whitespace; ``keep_keys`` filters to a subset.
    """
    keep = None if keep_keys is None else set(keep_keys)
    out: "OrderedDict[str, object]" = OrderedDict()
    with open(path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            parts = line.split(None, 1)
            if len(parts) != 2:
                raise ValueError(f"Malformed scp line in {path!s}: {line!r}")
            k, v = parts
            if keep is None or k in keep:
                out[k] = dtype(v)
    return out


def write_scp(path: str | Path, entries: Mapping[str, object]) -> Path:
    """Write a key->value mapping as a two-column scp file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for k, v in entries.items():
            f.write(f"{k} {v}\n")
    return path
