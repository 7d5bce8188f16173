"""Small cells through ``run.py`` on the CPU: the result line, the traced
run's readings, the control and planted faults of the timed path, each
of which must make ``correct`` false."""

from __future__ import annotations

import json

import pytest

from bench_small import run_small

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", ["small_fhvae.k2", "small_simple.k2",
                                  "small_fhvae.rounds", "small_fhvae.stream"])
def test_sound_run_is_correct(small_root, capsys, cell):
    line = run_small(small_root, cell, capsys)
    assert line["correct"], line["checks"]
    assert list(line) == KEYS
    assert "setup_s" in line["metrics"]
    assert line["attempted"] > 0 and line["failed"] == 0
    for check in line["checks"].values():
        assert check["value"] <= check["limit"]


def test_traced_run_reports_per_layer_metrics(small_root, capsys):
    line = run_small(small_root, "small_fhvae.rounds", capsys, "--trace", "1")
    assert line["correct"], line["checks"]
    got = set(line["metrics"])
    # the CPU has no device trace: the readings that need it are left out
    assert {"step_ms.hier", "outside_steps_share.hier", "mfu.hier",
            "turnover_s.hier"} <= got
    assert "idle_share.hier" not in got
    assert line["device"]["window_s"] > 0


def test_traced_stream_run_reports_its_chunk_waits(small_root, capsys):
    line = run_small(small_root, "small_fhvae.stream", capsys, "--trace",
                     "1")
    assert line["correct"], line["checks"]
    got = set(line["metrics"])
    assert {"step_ms.stream", "outside_steps_share.stream", "mfu.stream",
            "chunk_wait_s.stream"} <= got
    assert "idle_share.stream" not in got
    assert line["metrics"]["chunk_wait_s.stream"]["value"] > 0


@pytest.mark.parametrize("cell", ["small_fhvae.k2", "small_simple.k2"])
def test_control_and_planted_faults_are_not_correct(small_root, capsys,
                                                    cell):
    """The readings of the control (fp8 LSTM operands and TF32 products;
    TF32 products in the MLP) and of half of each batch left out, both in
    the program's place."""
    import run as run_py

    rc = run_py.main(["--workload", cell, "--seed", "99",
                      "--seconds", "1", "--readings", "1"], device="cpu",
                     root=small_root)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not line["correct"]["control"], line["control"]
    assert not line["correct"]["half_batch"], line["half_batch"]


def _state_unchanged(monkeypatch):
    from pytorch_scalablefhvae_tpu_torch.train import step

    monkeypatch.setattr(step.Optimizer, "update",
                        lambda self, state, grads, mesh=None, bc=None: None)


def _half_batch(monkeypatch):
    from pytorch_scalablefhvae_tpu_torch.train import step

    real = step.loss_from_outputs

    def half(out, weight, alpha, mesh=None):
        weight = weight.clone()
        weight[weight.shape[0] // 2:] = 0.0
        return real(out, weight, alpha, mesh)

    monkeypatch.setattr(step, "loss_from_outputs", half)


def _dev_bound_altered(monkeypatch):
    from pytorch_scalablefhvae_tpu_torch.train import loop

    real = loop.device_dev_pass

    def altered(*args, **kw):
        val = real(*args, **kw)
        return {**val, "lower_bound": val["lower_bound"] * 1.01}

    monkeypatch.setattr(loop, "device_dev_pass", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _dev_bound_altered])
@pytest.mark.parametrize("cell", ["small_fhvae.k2", "small_simple.k2",
                                  "small_fhvae.rounds", "small_fhvae.stream"])
def test_fault_is_not_correct(small_root, capsys, monkeypatch, fault, cell):
    fault(monkeypatch)
    line = run_small(small_root, cell, capsys)
    assert not line["correct"], line["checks"]


def _window_map_init_skipped(monkeypatch):
    """Every round after the first keeps the table the last one trained."""
    from pytorch_scalablefhvae_tpu_torch.train import rounds

    real, calls = rounds.Rounds.map_init, []

    def first_only(self, state, ds):
        calls.append(1)
        if len(calls) == 1:
            real(self, state, ds)

    monkeypatch.setattr(rounds.Rounds, "map_init", first_only)


def _window_draw_altered(monkeypatch):
    """The rounds after epoch 0 draw another epoch's sequences."""
    from pytorch_scalablefhvae_tpu_torch.train import rounds

    real = rounds.round_keys

    def altered(seq_keys, k, seed, e0):
        return real(seq_keys, k, seed, e0 + 1000 if e0 else e0)

    monkeypatch.setattr(rounds, "round_keys", altered)


@pytest.mark.parametrize("fault", [_window_map_init_skipped,
                                   _window_draw_altered])
def test_window_round_fault_is_not_correct(small_root, capsys, monkeypatch,
                                           fault):
    """Faults in the window's turnovers alone, which only the check of the
    window's last round sees."""
    fault(monkeypatch)
    line = run_small(small_root, "small_fhvae.rounds", capsys)
    assert not line["correct"], line["checks"]
    checks = line["checks"]
    assert checks["table_gap"]["value"] <= checks["table_gap"]["limit"]
    assert (checks["window_draw_gap"]["value"]
            > checks["window_draw_gap"]["limit"]
            or checks["window_table_gap"]["value"]
            > checks["window_table_gap"]["limit"])


def _stale_chunk(monkeypatch):
    """Every chunk a source fills after its first gets the first one's
    rows: each chunk's plan after a switch trains on the chunk before."""
    from pytorch_scalablefhvae_tpu_torch.data import stream_store

    real = stream_store.StreamingDeviceSource._fill

    def stale(self, spec, slot):
        real(self, self.__dict__.setdefault("_first_spec", spec), slot)

    monkeypatch.setattr(stream_store.StreamingDeviceSource, "_fill", stale)


def test_stale_chunk_is_not_correct(small_root, capsys, monkeypatch):
    """A switch that leaves the next chunk's slot holding the chunk before:
    the check of the step after the switch sees it."""
    _stale_chunk(monkeypatch)
    line = run_small(small_root, "small_fhvae.stream", capsys)
    assert not line["correct"], line["checks"]
    check = line["checks"]["switch_loss_gap"]
    assert check["value"] > check["limit"]
