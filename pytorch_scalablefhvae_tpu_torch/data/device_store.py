"""Device-resident training data: the packed store staged on the device.

Counterpart of ``pytorch_scalablefhvae_tpu/data/device_store.py``. The
packed ``[frames, D]`` float32 store is copied to the device once per run,
with ``STORE_TAIL_SLACK`` zero rows after it (the chunked window gather
reads whole regions that may run past the last sequence); each epoch then
uploads only its index plan, and every step gathers its segments on the
device (``train/device_step.py``).

The host-side pieces are the JAX package's own, shared by import (numpy
only): ``EpochPlan``, ``build_epoch_plan``, ``STORE_TAIL_SLACK``,
``resolve_data_placement`` and ``resolve_data_mode``.
:func:`resolve_tier` picks the run's tier from them. Not ported yet
(``ROADMAP.md``): the streamed tier, bfloat16/int8 staging, the in-graph
epoch plan (``make_device_epoch_plan``) and a store sharded over a mesh.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from pytorch_scalablefhvae_tpu.data.device_store import (  # noqa: F401
    STORE_TAIL_SLACK,
    EpochPlan,
    build_epoch_plan,
    resolve_data_placement,
)
from pytorch_scalablefhvae_tpu.data.segments import SegmentDataset
from pytorch_scalablefhvae_tpu.data.stream_store import resolve_data_mode


def resolve_tier(placement: str, store, max_bytes: int) -> str:
    """The run's data tier, ``"device"`` or ``"host"``, as the JAX package's
    ``resolve_data_mode`` decides it on one device: ``host`` is the loader;
    ``device`` stages the store or raises the shared ``ValueError`` when it
    is over ``max_bytes``; ``auto`` stages it when it fits. Where ``auto``
    would stream (over budget), the streamed tier is not ported, so the run
    keeps the host loader and says so. The store stages as float32."""
    mode = resolve_data_mode(placement, store, max_bytes=max_bytes)
    if mode == "stream":
        if placement != "auto":
            raise NotImplementedError(
                f"--data-placement {placement} is not yet ported to PyTorch "
                f"(ROADMAP.md, item 7)")
        print(f"data placement auto: the packed store "
              f"({store.data.nbytes / 1e6:.0f} MB) "
              f"is over the device-store budget ({max_bytes / 1e6:.0f} MB) "
              f"and the streamed tier is not yet ported (ROADMAP.md, item "
              f"7); training from the host loader")
        return "host"
    return mode


class DeviceDataSource:
    """The packed store on ``device``, plus per-epoch plan uploads."""

    def __init__(self, store, device: torch.device,
                 store_dtype: str = "float32"):
        if store_dtype != "float32":
            raise NotImplementedError(
                f"{store_dtype} staging of the device store is not yet ported "
                f"to PyTorch (ROADMAP.md, item 7)")
        data = np.asarray(store.data, dtype=np.float32)
        rows, dim = data.shape
        # one allocation and one copy; the slack rows stay zero
        self.data = torch.zeros((rows + STORE_TAIL_SLACK, dim),
                                dtype=torch.float32, device=device)
        with warnings.catch_warnings():
            # a memory-mapped store is read-only; it is only read from here
            warnings.simplefilter("ignore", UserWarning)
            self.data[:rows].copy_(torch.from_numpy(data))
        self.device = torch.device(device)

    def upload(self, arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device,
                                                             dtype)

    def stage_epoch(self, dataset: SegmentDataset, order: np.ndarray,
                    batch_size: int):
        """Upload one epoch's plan: ``(plan, (seq_idx [Npad] int64,
        abs_starts [Npad] int64, nsegs_tab [S] float32))`` on the device."""
        plan = build_epoch_plan(dataset, order, batch_size)
        return plan, (self.upload(plan.seq_idx, torch.long),
                      self.upload(plan.abs_starts, torch.long),
                      self.upload(dataset.nsegs, torch.float32))
