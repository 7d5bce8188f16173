"""The streamed cell's yardstick: the reference's chunks and schedule
against the program's, the chunk-wait reader, and the switch's number
against itself and under the stale-chunk fault."""

from __future__ import annotations

import json

import numpy as np
import pytest

from fhbench import spec
from reference import common
from reference import train as ref_train


@pytest.mark.parametrize("chunk_bytes", [100_000, 1_000_000])
@pytest.mark.parametrize("seed", [0, 2**31 + 5, 3_300_000_025])
def test_stream_chunks_and_schedule_follow_the_program(seed, chunk_bytes):
    from pytorch_scalablefhvae_tpu_torch.data.segments import make_segments
    from pytorch_scalablefhvae_tpu_torch.data.stream_store import (
        StreamingDeviceSource,
        partition_chunks,
    )

    lens = np.random.default_rng([seed, 1]).integers(40, 300, 400)
    _, _, nsegs = common.segment_index(lens, 20, 8)
    want = partition_chunks(lens, make_segments(lens, 20, 8)[2], 80, 4,
                            chunk_bytes)
    got = common.stream_chunks(lens, nsegs, 320, chunk_bytes)
    assert got == [(c.frame_base, c.n_frames, c.seg_lo, c.seg_hi)
                   for c in want]
    assert len(got) > 2
    source = object.__new__(StreamingDeviceSource)
    source.chunks = want
    for epoch in (0, 3):
        # the training loop seeds an epoch's schedule as the loader's
        # shuffle: loader seed + 1,000,003 x epoch
        program = source.epoch_schedule(seed + 1_000_003 * epoch)
        ref = common.stream_schedule(got, seed, epoch)
        assert [want.index(c) for c, _ in program] == [c for c, _ in ref]
        for (_, a), (_, b) in zip(program, ref):
            np.testing.assert_array_equal(a, b)
        batches = ref_train.stream_batches(ref, 32)
        assert sum(len(b) for b in batches) == len(np.concatenate(
            [o for _, o in ref]))


def test_chunk_wait_reader():
    read = spec.reader("chunk_wait_s.stream")
    assert read(type("R", (), {"chunk_waits": [0.25, 0.75]})()) == 0.5
    assert read(type("R", (), {"chunk_waits": []})()) is None
    assert read(type("R", (), {})()) is None


def test_readings_fail_the_switch_under_a_stale_chunk(small_root, capsys):
    """``--readings``: the program's switch passes; the stale-chunk fault
    (the switch's first batch gathered from the chunk before's rows) reads
    over ten times the limit, and the control and half batch fail too."""
    import run as run_py

    rc = run_py.main(["--workload", "small_fhvae.stream", "--seed", "99",
                      "--seconds", "1", "--readings", "1"], device="cpu",
                     root=small_root)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limit = json.loads((small_root / "benchmarks" / "limits" /
                        "small_fhvae.stream.json").read_text())
    limit = limit["switch_loss_gap"]["limit"]
    assert line["correct"]["program"], line["program"]
    assert line["program"]["switch_loss_gap"] <= limit
    assert line["stale_chunk"]["switch_loss_gap"] > 10 * limit
    assert not line["correct"]["stale_chunk"]
    assert not line["correct"]["control"]
    assert not line["correct"]["half_batch"]


def test_switch_loss_repeats(small_root, tmp_path):
    """The reference's side of the switch gives the same bits twice, so
    the reference in the program's place reads 0."""
    import run as run_py

    cell = spec.cell(spec.load(small_root), "small_fhvae.stream", small_root,
                     small_root / "benchmarks")
    run = run_py.run_class(cell)(cell, 2**31 + 9, 1.0, False, "cpu",
                                 tmp_path)
    try:
        run.setup()
        run.window()
        assert run.switch_loss() == run.switch_loss()
        assert run.switch_numbers()["switch_loss_gap"] < 1e-3
    finally:
        run.close()
