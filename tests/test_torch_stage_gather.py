"""A hierarchical round's rows gathered from the host store into the staged
buffer (``ops/stage_gather.py``, ``data/device_store.py`` ``RoundLayout``,
``gather_runs``, ``DeviceDataSource.hold_host`` / ``restage_runs``), on the
CPU, where the gather is its plain version.

The gathered buffer holds the bits that the host sub-pack
(``FeatureStore.subset(keys, materialize=True)``) restaged gives, in float32
and bfloat16, for drawn key orders, keys adjacent in the store (merged
runs, cut into pieces), a smaller round after a larger one (the zero tail
up to the ceiling) and a row-sharded mesh rank's window. A round turned over
by ``Rounds`` gathers from the held store, and int8 staging copies the host
sub-pack, counting ``stage_gathers`` and ``stage_fallbacks``; a store that
cannot be held raises, and a memory-mapped one is held as a copy in memory;
the layout has no host rows.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    TrainConfig,
)
from pytorch_scalablefhvae_tpu_torch.data import device_store
from pytorch_scalablefhvae_tpu_torch.data.device_store import (
    DeviceDataSource,
    RoundLayout,
    gather_runs,
)
from pytorch_scalablefhvae_tpu_torch.data.feature_store import FeatureStore
from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
from pytorch_scalablefhvae_tpu_torch.ops.stage_gather import (
    NotMapped,
    host_store,
    lockable,
    stage_gather,
    stage_gather_reference,
)
from pytorch_scalablefhvae_tpu_torch.parallel.mesh import model_shard
from pytorch_scalablefhvae_tpu_torch.train import rounds, trace

CPU = torch.device("cpu")
DIM = 6


@pytest.fixture(scope="module")
def store():
    rng = np.random.default_rng(11)
    return FeatureStore.from_arrays({
        f"s{i:02d}": (rng.standard_normal((n, DIM)) * 3).astype(np.float32)
        for i, n in enumerate(rng.integers(20, 90, 40))})


def ceiling_of(store, k: int) -> int:
    return int(np.sort(store.lens)[-k:].sum()) + device_store.STORE_TAIL_SLACK


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else \
        t.view(torch.int32)


def empty_source(store, dtype: str, rows: int, mesh=None):
    return DeviceDataSource(store.subset([], materialize=True), CPU, dtype,
                            pad_to_rows=rows, mesh=mesh,
                            shard_store=mesh is not None)


def fake_mesh(j: int):
    """Rank ``(0, j)`` of a ``(1, 2)`` mesh, as the row shard needs it."""
    mesh = SimpleNamespace(shape=(1, 2), model_index=j)
    mesh.store_rows = lambda rows: model_shard(mesh, rows, "store rows")
    return mesh


def draws(store, k: int = 12):
    rng = np.random.default_rng(3)
    keys = store.seq_keys
    return [list(rng.choice(keys, size=k, replace=False)),
            list(rng.choice(keys, size=k - 5, replace=False)),
            keys[7:7 + k],          # adjacent in the store: one run
            keys[30:34] + keys[2:9]]  # two runs, drawn out of order


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("j", [None, 0, 1])
def test_gathered_rounds_equal_the_host_sub_pack(store, dtype, j):
    """Every draw in turn into one buffer: the layout's offsets are the
    sub-pack's, and the buffer (on a mesh, rank ``j``'s window) the bits of
    the sub-pack restaged, zeros up to the ceiling."""
    rows = ceiling_of(store, 12)
    mesh = None if j is None else fake_mesh(j)
    gathered = empty_source(store, dtype, rows, mesh)
    gathered.hold_host(store.data)
    copied = empty_source(store, dtype, rows, mesh)
    for keys in draws(store):
        layout = RoundLayout(store, keys)
        sub = store.subset(keys, materialize=True)
        np.testing.assert_array_equal(layout.seq_starts, sub.seq_starts)
        np.testing.assert_array_equal(layout.lens, sub.lens)
        assert layout.rows == sub.data.shape[0]
        gathered.restage_runs(layout, gathered.upload_runs(layout))
        copied.restage(sub)
        assert torch.equal(bits(gathered.rows), bits(copied.rows))
        lo = gathered.window.start
        held = max(min(gathered.window.stop, layout.rows) - lo, 0)
        assert not gathered.rows[held:].any()
        if held:
            want = torch.from_numpy(sub.data[lo:lo + held]).to(
                gathered.rows.dtype)
            assert torch.equal(bits(gathered.rows[:held]), bits(want))


def test_runs_merge_adjacent_sequences_and_cut_long_ones(store):
    keys = store.seq_keys[7:19]  # one run in the store
    layout = RoundLayout(store, keys)
    whole = [[int(store.seq_starts[7]), 0, layout.rows]]
    assert gather_runs(layout).tolist() == whole
    assert gather_runs(layout, piece=layout.rows).tolist() == whole
    cut = gather_runs(layout, piece=37)
    assert (cut[:, 2] <= 37).all() and cut[:, 2].sum() == layout.rows
    assert len(cut) == -(-layout.rows // 37)
    np.testing.assert_array_equal(cut[1:, :2] - cut[:-1, :2], 37)
    # drawn out of order: a run a sequence, clipped to a window
    keys = [store.seq_keys[i] for i in (5, 1, 3, 4, 20)]
    layout = RoundLayout(store, keys)
    lo, hi = 30, layout.rows - 10
    runs = gather_runs(layout, lo, hi)
    assert runs[0, 1] == 0 and runs[:, 2].sum() == hi - lo
    np.testing.assert_array_equal(runs[1:, 1], np.cumsum(runs[:-1, 2]))
    # 3 and 4 are adjacent in the store and in the draw: merged
    assert len(runs) == 4
    sub = store.subset(keys, materialize=True)
    out = torch.full((hi - lo, DIM), 7.0)
    stage_gather(host_store(store.data, CPU), torch.from_numpy(runs), out)
    assert torch.equal(out, torch.from_numpy(sub.data[lo:hi]))


def test_plain_gather_checks_its_arguments(store):
    host = host_store(store.data, CPU)
    out = torch.zeros((10, DIM))
    runs = torch.tensor([[0, 0, 10]])
    stage_gather_reference(host, runs, out)
    assert torch.equal(out, torch.from_numpy(store.data[:10]))
    for bad_runs, bad_out in ((runs.int(), out), (runs[:, :2], out),
                              (runs, torch.zeros((10, DIM + 1))),
                              (runs, torch.zeros((10, DIM),
                                                 dtype=torch.half))):
        with pytest.raises(ValueError):
            stage_gather(host, bad_runs, bad_out)
    # a layout of another, longer store reaches past the held one
    source = empty_source(store, "float32", ceiling_of(store, 12))
    source.hold_host(np.ascontiguousarray(store.data[:500]))
    with pytest.raises(ValueError, match="reach past"):
        source.upload_runs(RoundLayout(store, store.seq_keys[-3:]))
    with pytest.raises(NotMapped):
        host_store(np.asfortranarray(store.data), CPU)
    with pytest.raises(NotMapped):
        host_store(store.data.astype(np.float64), CPU)


def turnover(store, dtype: str):
    """Round 0 turned over by ``Rounds`` on the round tier, recorded: the
    round's loader, the source and the counters."""
    loader = SegmentLoader(SegmentDataset(store, seg_len=10, seg_shift=4), 8,
                           shuffle=True, seed=0, prefetch=0)
    cfg = ExperimentConfig(data=DataConfig(transfer_dtype=dtype),
                           train=TrainConfig(seed=2))
    k, rows = rounds.round_ceiling("stream", store, 12, 1 << 30, dtype,
                                   verbose=False)
    source = empty_source(store, dtype, rows)
    r = rounds.Rounds(cfg, loader, "round", source, k, CPU)
    trace.take()
    with trace.recording():
        sub = r.loader_for(0, None, resumed=True, verbose=False)
    return sub, source, trace.take()[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rounds_gather_where_the_store_is_held(store, dtype):
    sub, source, counters = turnover(store, dtype)
    assert source.host is not None
    assert counters["stage_gathers"] == 1
    assert counters["stage_fallbacks"] == 0
    assert isinstance(sub.dataset.store, RoundLayout)
    with pytest.raises(RuntimeError, match="no rows on the host"):
        sub.dataset.store.data
    # the windows are the sub-pack's: the staged tiers read them there
    keys = sub.dataset.store.seq_keys
    want = SegmentDataset(store.subset(keys, materialize=True), seg_len=10,
                          seg_shift=4)
    for name in ("seq_idx", "starts", "nsegs"):
        np.testing.assert_array_equal(getattr(sub.dataset, name),
                                      getattr(want, name))


@pytest.mark.parametrize("dtype", ["int8"])
def test_rounds_fall_back_to_the_host_sub_pack(store, dtype):
    """int8 staging quantizes over the whole sub-pack: its rounds turn over
    through the host sub-pack, count ``stage_fallbacks``, and hold no host
    store."""
    sub, source, counters = turnover(store, dtype)
    assert source.host is None
    assert counters["stage_fallbacks"] == 1
    assert counters["stage_gathers"] == 0
    assert sub.dataset.store.data.shape[0] == sub.dataset.store.lens.sum()
    held = empty_source(store, dtype, source.rows.shape[0])
    held.restage(store.subset(sub.dataset.store.seq_keys, materialize=True))
    assert torch.equal(source.rows, held.rows)


@pytest.mark.parametrize("case", ["fortran", "float64"])
def test_a_store_that_cannot_be_held_raises(store, case):
    """The round tier gathers from the held store: one that cannot be held
    stops the run, naming the host loader's placement."""
    data = (np.asfortranarray(store.data) if case == "fortran"
            else store.data.astype(np.float64))
    source = empty_source(store, "float32", ceiling_of(store, 12))
    with pytest.raises(RuntimeError, match="--data-placement host"):
        source.hold_host(data)
    assert source.host is None


def test_a_memory_mapped_store_is_held_as_a_copy(store, tmp_path):
    """A memory-mapped pack (``--pack-cache-dir``), whose file pages CUDA
    may refuse to page-lock, is held as a copy in host memory; a store in
    memory is held as it is."""
    assert lockable(store.data) is store.data
    path = tmp_path / "pack.bin"
    store.data.tofile(path)
    mapped = np.memmap(path, np.float32, "r", shape=store.data.shape)
    rows = lockable(mapped)
    assert not isinstance(rows, np.memmap) and rows.flags.writeable
    assert rows.flags.c_contiguous and np.array_equal(rows, store.data)
    # on the CPU the plain gather reads the mapped rows themselves
    host = host_store(mapped, CPU)
    assert host.ptr == 0 and torch.equal(host.rows,
                                         torch.from_numpy(store.data))
