"""The port's ``--ckpt-backend orbax`` (``train/orbax_backend.py``, on
``torch.distributed.checkpoint``) against the JAX package's orbax backend,
on the CPU.

The counterpart of each case of the JAX ``tests/test_orbax.py`` (which is
marked slow): a roundtrip and a resume bit for bit, finetune, the best
pointer, epoch listing, mu2 row adaptation with and without the sidecar's
hint, an interrupted save's self-heal and its limits. The discovery cases
run the JAX package's ``find_best_checkpoint`` / ``find_epoch_checkpoint``
/ ``cleanup_mid_epoch`` on the same directory and must pick what the
port's pick. A JAX ``save_checkpoint_orbax`` of a small ``SimpleFHVAE``
state gives the port's sidecar keys and values (but ``format``), and the
port refuses its directory. Also what is the port's own: a save staged at
step n and written after later steps loads step n's bits; a failed write
raises at the flush and at the next save; the CLI's orbax run equals its
npz run in every tensor, and its eval from the best pointer gives the npz
eval's numbers. Tiny widths (H 16, z 4), one torch thread.
"""

import json
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.config import DataConfig, ExperimentConfig
from pytorch_scalablefhvae_tpu.features.pipeline import preprocess_data
from pytorch_scalablefhvae_tpu.models.simple_fhvae import (
    SimpleFHVAE as JaxSimpleFHVAE,
)
from pytorch_scalablefhvae_tpu.train import checkpoint as jax_ckpt
from pytorch_scalablefhvae_tpu.train import orbax_backend as jax_orbax
from pytorch_scalablefhvae_tpu.train import step as jax_step
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.models.simple_fhvae import SimpleFHVAE
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train import orbax_backend as ob
from pytorch_scalablefhvae_tpu_torch.train.step import (
    create_train_state,
    make_optimizer,
    train_step,
)

B, T, F, NUM_SEQS = 8, 20, 8, 6
DIMS = dict(z1_hus=(16, 16), z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4,
            z2_dim=4)
META = {"best_epoch": 0, "best_val_lb": -1.0, "values": {},
        "model_type": "simple_fhvae", "model_params": [T * F]}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def fresh_state(seed=0, rows=NUM_SEQS):
    """A port training state; ``rows`` > ``NUM_SEQS`` pads the table as a
    mesh's model axis does."""
    model = SimpleFHVAE(T * F, num_seqs=NUM_SEQS, feat_dim=F,
                        generator=torch.Generator().manual_seed(seed), **DIMS)
    if rows != NUM_SEQS:
        table = torch.zeros((rows, DIMS["z2_dim"]))
        table[:NUM_SEQS] = model.mu2_table.data
        table[NUM_SEQS:] = 5.0  # padding rows hold no real sequence
        model.mu2_table = torch.nn.Parameter(table)
        model.num_seqs_padded = rows
    return create_train_state(model, seed=seed)


def step(state, seed):
    rng = np.random.default_rng(seed)
    train_step(
        state, make_optimizer(1e-3, 0.95, 0.999),
        torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, NUM_SEQS, B)),
        torch.full((B,), 5.0), torch.ones(B), alpha=10.0)
    return state


def arrays(state) -> dict:
    return {k: v.detach().clone() for k, v in ob.state_tensors(state).items()}


def assert_states_equal(got, want: dict):
    got = ob.state_tensors(got) if not isinstance(got, dict) else got
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def save(tmp_path, state, run, epoch, meta=None, **kw):
    return ob.save_checkpoint_orbax(
        tmp_path, state, model_type="simple_fhvae", run_info=run,
        epoch=epoch, meta=dict(META, **(meta or {})), **kw)


def test_roundtrip_bit_identical(tmp_path):
    state = step(fresh_state(), 1)
    path = save(tmp_path, state, "t", 0)
    ob.wait_for_saves()
    assert path == (tmp_path / "simple_fhvae_t_e0.orbax").resolve()
    assert not list(tmp_path.glob(".*.tmp"))  # committed by rename
    loaded = fresh_state(seed=3)
    meta = ckpt.load_train_state(path, loaded)
    assert_states_equal(loaded, arrays(state))
    assert meta["start_epoch"] == 1 and meta["backend"] == "orbax"
    assert meta["format"] == ob.DCP_FORMAT


def test_resume_continues_identically(tmp_path):
    """Two steps straight through == one, a save, a load, one more (the
    load flushes the save itself)."""
    direct = step(step(fresh_state(), 1), 2)
    mid = step(fresh_state(), 1)
    path = save(tmp_path, mid, "r", 0)
    resumed = fresh_state(seed=7)
    ckpt.load_train_state(path, resumed)
    assert_states_equal(step(resumed, 2), arrays(direct))


def test_staged_save_holds_its_step_while_training_goes_on(tmp_path):
    """The save returns once staged; its write runs after three more steps
    have updated the state in place (the writer held back until then),
    and the flushed checkpoint holds step 1's bits."""
    state = step(fresh_state(), 1)
    at_save = arrays(state)
    gate = threading.Event()
    ob._saver()._pool.submit(gate.wait, 30)  # the writer's next job waits
    path = save(tmp_path, state, "a", 0)
    for seed in (2, 3, 4):
        step(state, seed)
    assert not path.exists()  # not written yet
    gate.set()
    ob.wait_for_saves()
    assert int(ob.state_tensors(state)["step"]) == 4
    loaded = fresh_state()
    ckpt.load_train_state(path, loaded)
    assert_states_equal(loaded, at_save)


def test_failed_write_raises_at_the_flush_and_the_next_save(tmp_path,
                                                           monkeypatch):
    state = fresh_state()

    def broken(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ob._dcp(), "save", broken)
    save(tmp_path, state, "f", 0)
    with pytest.raises(OSError, match="disk full"):
        ob.wait_for_saves()
    save(tmp_path, state, "f", 1)
    ob._saver()._pending[-1].exception(timeout=30)  # the write failed
    with pytest.raises(OSError, match="disk full"):
        save(tmp_path, state, "f", 2)  # raised before it stages
    ob.wait_for_saves()  # each failure is raised once
    assert not list(tmp_path.glob("*.orbax"))  # nothing committed


def test_finetune_resets_optimizer_and_history(tmp_path):
    trained = step(fresh_state(), 1)
    path = save(tmp_path, trained, "f", 3, {"best_epoch": 3,
                                          "values": {"train_loss": [1.0]}})
    loaded = fresh_state(seed=5)
    fresh = arrays(loaded)
    meta = ckpt.load_train_state(path, loaded, finetune=True,
                                 expected_num_seqs=NUM_SEQS + 1)
    got, want = ob.state_tensors(loaded), arrays(trained)
    for k in loaded.model.state_dict():
        assert torch.equal(got[k], want[k]), k  # the weights
    for k in got:
        if k.startswith("adam_") or k == "step":
            assert torch.equal(got[k], fresh[k]), k  # a fresh optimizer
    assert meta["start_epoch"] == 0 and meta["values"] == {}


def test_best_pointer_resolution(tmp_path):
    save(tmp_path, fresh_state(), "b", 2, {"best_epoch": 2})
    save(tmp_path, fresh_state(), "b", 2, {"best_epoch": 2}, suffix="s9")
    ob.wait_for_saves()
    best = ckpt.find_best_checkpoint(tmp_path)
    assert best == (tmp_path / "simple_fhvae_b_e2.orbax").resolve()
    assert best == jax_ckpt.find_best_checkpoint(tmp_path)
    pointer = json.loads((tmp_path / "best_model_pointer.json").read_text())
    assert pointer == {"path": str(best), "epoch": 2}  # not the step save's


def test_epoch_checkpoint_listing(tmp_path):
    state = fresh_state()
    for e in (0, 1, 2):
        save(tmp_path, state, "l", e)
    save(tmp_path, state, "l", 3, suffix="s4")  # a step checkpoint
    ob.wait_for_saves()
    for i in (-1, 0):
        got = ckpt.find_epoch_checkpoint(tmp_path, i)
        assert got == jax_ckpt.find_epoch_checkpoint(tmp_path, i)
    assert ckpt.find_epoch_checkpoint(tmp_path, -1).name.endswith("_e2.orbax")
    assert ckpt.find_epoch_checkpoint(tmp_path, 0).name.endswith("_e0.orbax")
    # never a best_model_ entry among the .orbax epochs
    (tmp_path / "best_model_simple_fhvae_l_e9.orbax").mkdir()
    assert ckpt.find_epoch_checkpoint(tmp_path, -1).name.endswith("_e2.orbax")


@pytest.mark.parametrize("hint", ["sidecar", "no sidecar hint"])
def test_mu2_row_padding_adapts(tmp_path, hint):
    """A table padded to 8 rows (a mesh's model axis) loads into the
    6-row model and back; without the sidecar's ``table_rows`` the row
    count comes from DCP's metadata."""
    padded = step(fresh_state(rows=8), 1)
    path = save(tmp_path, padded, "p", 0, {"num_seqs": NUM_SEQS})
    sidecar = tmp_path / "simple_fhvae_p_e0.json"
    assert json.loads(sidecar.read_text())["table_rows"] == 8
    if hint == "no sidecar hint":
        meta = json.loads(sidecar.read_text())
        del meta["table_rows"]
        sidecar.write_text(json.dumps(meta))
    ob.wait_for_saves()
    assert ob.saved_mu2_rows(path) == 8
    assert ckpt.saved_table_rows(path, padded.model) == 8
    loaded = fresh_state()
    ckpt.load_train_state(path, loaded)
    want = arrays(padded)
    for k in ("mu2_table", "adam_mu.mu2_table", "adam_nu.mu2_table"):
        got = ob.state_tensors(loaded)[k]
        assert got.shape == (NUM_SEQS, DIMS["z2_dim"])
        assert torch.equal(got, want[k][:NUM_SEQS]), k
    # and back: the unpadded checkpoint into the padded model
    back = save(tmp_path, loaded, "q", 0)
    into = fresh_state(rows=8)
    ckpt.load_train_state(back, into)
    table = into.model.mu2_table.detach()
    assert table.shape == (8, DIMS["z2_dim"])
    assert torch.equal(table[:NUM_SEQS], want["mu2_table"][:NUM_SEQS])
    assert (table[NUM_SEQS:] == 0).all()


def test_other_shape_mismatch_raises(tmp_path):
    path = save(tmp_path, fresh_state(), "w", 0)
    wide = SimpleFHVAE(T * F, num_seqs=NUM_SEQS, feat_dim=F,
                       **{**DIMS, "x_hus": (32, 32)})
    with pytest.raises(ValueError, match="dec_"):
        ckpt.load_params(path, wide)


def dangle(tmp_path, run, epoch, best=None):
    """A save interrupted before its commit: the sidecar and the pointer
    without the directory."""
    path = (tmp_path / f"simple_fhvae_{run}_e{epoch}.orbax").resolve()
    (tmp_path / f"simple_fhvae_{run}_e{epoch}.json").write_text(json.dumps(
        {"best_epoch": epoch if best is None else best, "epoch": epoch,
         "backend": "orbax"}))
    (tmp_path / "best_model_pointer.json").write_text(json.dumps(
        {"path": str(path), "epoch": epoch}))
    return path


def test_interrupted_save_self_heals(tmp_path):
    trained = step(fresh_state(), 1)
    save(tmp_path, trained, "h", 0)
    ob.wait_for_saves()
    dangling = dangle(tmp_path, "h", 1)
    with pytest.warns(UserWarning, match="never committed"):
        best = ckpt.find_best_checkpoint(tmp_path)
    with pytest.warns(UserWarning, match="never committed"):
        assert best == jax_ckpt.find_best_checkpoint(tmp_path)
    assert best.name == "simple_fhvae_h_e0.orbax"
    loaded = fresh_state(seed=2)
    with pytest.warns(UserWarning, match="falling back"):
        meta = ckpt.load_train_state(dangling, loaded)
    assert_states_equal(loaded, arrays(trained))
    assert meta["epoch"] == 0 and meta["start_epoch"] == 1


def test_self_heal_prefers_best_committed_not_latest(tmp_path):
    state = fresh_state()
    for epoch in (0, 1):  # e1 commits, e0 stays the best
        save(tmp_path, state, "p", epoch, {"best_epoch": 0})
    ob.wait_for_saves()
    dangle(tmp_path, "p", 2)
    with pytest.warns(UserWarning, match="best committed"):
        best = ckpt.find_best_checkpoint(tmp_path)
    with pytest.warns(UserWarning, match="best committed"):
        assert best == jax_ckpt.find_best_checkpoint(tmp_path)
    assert best.name == "simple_fhvae_p_e0.orbax"


@pytest.mark.parametrize("ext", ["npz", "orbax"])
def test_find_epoch_checkpoint_rejects_mixed_runs(tmp_path, ext):
    for name in ("m_runA_e0", "m_runA_e1", "m_runB_e1"):
        p = tmp_path / f"{name}.{ext}"
        p.mkdir() if ext == "orbax" else p.write_text("x")
    for mod in (ckpt, jax_ckpt):
        with pytest.raises(ValueError, match="different runs"):
            mod.find_epoch_checkpoint(tmp_path, -1)


def test_interrupted_save_no_fallback_raises(tmp_path):
    dangling = dangle(tmp_path, "x", 0)
    with pytest.raises(FileNotFoundError, match="no earlier committed"):
        ckpt.load_train_state(dangling, fresh_state())


def test_self_heal_never_crosses_runs(tmp_path):
    save(tmp_path, fresh_state(), "runB", 3, {"best_epoch": 3})
    ob.wait_for_saves()
    dangling = dangle(tmp_path, "runA", 5)
    with pytest.raises(FileNotFoundError, match="no earlier committed"):
        ckpt.load_train_state(dangling, fresh_state())
    for mod in (ckpt, jax_ckpt):
        with pytest.raises(FileNotFoundError, match="No best-model"):
            mod.find_best_checkpoint(tmp_path)


def test_cleanup_mid_epoch_as_the_jax_package(tmp_path):
    """Step directories and their sidecars of epochs up to the one given
    go; epoch checkpoints, the pointer, another run's and a later epoch's
    stay, in both packages alike."""
    state = fresh_state()
    left = {}
    for pkg, mod in (("jax", jax_ckpt), ("port", ckpt)):
        d = tmp_path / pkg
        for epoch, suffix, run in ((0, "s2", "c"), (0, "", "c"),
                                   (1, "s3", "c"), (2, "s1", "c"),
                                   (0, "s2", "other")):
            save(d, state, run, epoch, suffix=suffix)
        ob.wait_for_saves()
        mod.cleanup_mid_epoch(d, "simple_fhvae", "c", upto_epoch=1)
        left[pkg] = sorted(p.name for p in d.iterdir())
    assert left["port"] == left["jax"]
    assert "simple_fhvae_c_e2s1.orbax" in left["port"]
    assert "simple_fhvae_c_e1s3.orbax" not in left["port"]


def test_jax_written_sidecar_and_refusal(tmp_path):
    """The same weights saved by the JAX package's orbax backend and by the
    port's give the same sidecar, ``format`` apart; the JAX directory has
    no DCP metadata and the port refuses it, naming ROADMAP.md."""
    jm = JaxSimpleFHVAE(input_size=T * F, num_seqs=NUM_SEQS,
                        use_pallas="never", **DIMS)
    jstate = jax_step.create_train_state(
        jm, jax_step.make_optimizer(1e-3, 0.95, 0.999), seed=0)
    meta = dict(META, best_epoch=1, num_seqs=NUM_SEQS, feat_dim=F,
                seg_len=T, corpus_fingerprint="f" * 32,
                summary_vals={"train_loss": 1.5})
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jpath = jax_orbax.save_checkpoint_orbax(
        jdir, jstate, model_type="simple_fhvae", run_info="s", epoch=1,
        meta=meta)
    jax_orbax.wait_for_saves()
    state = fresh_state()
    state.model.load_state_dict(ckpt.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params)))
    ppath = ob.save_checkpoint_orbax(pdir, state, model_type="simple_fhvae",
                                     run_info="s", epoch=1, meta=meta)
    ob.wait_for_saves()
    jside = json.loads((jdir / "simple_fhvae_s_e1.json").read_text())
    pside = json.loads((pdir / "simple_fhvae_s_e1.json").read_text())
    assert pside.pop("format") == ob.DCP_FORMAT
    assert pside == jside
    for d, p in ((jdir, jpath), (pdir, ppath)):
        pointer = json.loads((d / "best_model_pointer.json").read_text())
        assert pointer == {"path": str(p), "epoch": 1}
    loaded = fresh_state(seed=4)
    ckpt.load_params(ppath, loaded.model)
    for k, v in ckpt.params_from_jax(jax.tree_util.tree_map(
            np.asarray, jstate.params)).items():
        assert torch.equal(loaded.model.state_dict()[k], v), k
    for load in (lambda: ckpt.load_params(jpath, loaded.model),
                 lambda: ckpt.load_train_state(jpath, loaded)):
        with pytest.raises(NotImplementedError,
                           match="(?s)orbax package.*ROADMAP.md"):
            load()


# ---------------------------------------------------------------- the CLI

WIDTHS = ["--z1-hus", "16", "16", "--z2-hus", "16", "16", "--x-hus", "16",
          "16", "--z1-dim", "4", "--z2-dim", "4"]
RUN = "synthetic_np_fbank"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    preprocess_data(ExperimentConfig(data=DataConfig(dataset="synthetic")),
                    root=root)
    return root


def cli_train(corpus, exp_root, *extra):
    return main(["train", "--dataset", "synthetic", "--preprocessed",
                 "--data-root", str(corpus), "--mvn-path",
                 str(corpus / "mvn.json"), "--model-type", "simple_fhvae",
                 "--training-batch-size", "32", "--dev-batch-size", "64",
                 "--exp-root", str(exp_root), "--device", "cpu",
                 *WIDTHS, *extra])


def test_cli_orbax_run_equals_npz_run_and_resumes(corpus, tmp_path):
    """``train --ckpt-backend orbax`` (the JAX ``test_loop_end_to_end_with
    _orbax_backend``): every tensor of each epoch checkpoint equals the npz
    run's bit for bit, so do the metrics; a resume from the last directory
    extends the run in place; ``eval`` from the best pointer gives the npz
    eval's metrics."""
    runs = {}
    for backend in ("npz", "orbax"):
        assert cli_train(corpus, tmp_path / backend, "--epochs", "2",
                         "--ckpt-backend", backend) == 0
        runs[backend] = tmp_path / backend / RUN / "simple_fhvae_e2_p10_a10.0"
    npz, orb = runs["npz"], runs["orbax"]
    assert metrics(orb) == metrics(npz)
    for epoch in (0, 1):
        with np.load(npz / f"simple_fhvae_{RUN}_e{epoch}.npz") as z:
            want = {k: z[k] for k in z.files}
        got = ob.state_tensors(_loaded_state(orb, epoch))
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert ckpt.find_epoch_checkpoint(orb, -1).name.endswith("_e1.orbax")
    for d in (npz, orb):
        assert main(["eval", str(d), "--set-name", "dev", "--data-root",
                     str(corpus), "--device", "cpu"]) == 0
    assert json.loads((orb / "eval/dev/metrics.json").read_text()) == \
        json.loads((npz / "eval/dev/metrics.json").read_text())
    last = ckpt.find_epoch_checkpoint(orb, -1)
    assert main(["train", "--dataset", "synthetic", "--preprocessed",
                 "--data-root", str(corpus), "--device", "cpu",
                 "--continue-from", str(last), "--resume-override",
                 "epochs=3"]) == 0
    assert ckpt.find_epoch_checkpoint(orb, -1).name.endswith("_e2.orbax")
    assert [r["epoch"] for r in metrics(orb)] == [0, 1, 2]


def metrics(exp: Path) -> list[dict]:
    """``metrics.jsonl`` without its wall-clock fields."""
    return [{k: v for k, v in json.loads(line).items()
             if k not in ("train_seconds", "train_segments_per_sec")}
            for line in (exp / "metrics.jsonl").read_text().splitlines()]


def _loaded_state(exp: Path, epoch: int):
    """The training state of ``exp``'s epoch ``epoch`` orbax checkpoint,
    loaded into a model built from its sidecar."""
    from pytorch_scalablefhvae_tpu_torch.config import (
        ExperimentConfig as PortConfig,
    )
    from pytorch_scalablefhvae_tpu_torch.models.base import build_model

    path = exp / f"simple_fhvae_{RUN}_e{epoch}.orbax"
    meta = ckpt.read_checkpoint_meta(path)
    config = PortConfig.load(exp / "config.json")
    state = create_train_state(build_model(
        "simple_fhvae", meta["model_params"][0], config.model,
        meta["num_seqs"], feat_dim=meta["feat_dim"]))
    ckpt.load_train_state(path, state)
    return state
