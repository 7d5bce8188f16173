"""The port's hierarchical rounds (``train --hierarchical``), on the CPU.

Each round trains against K sequences drawn from the corpus, with its mu2
table MAP-initialised from the encoder at the round's turnover and its Adam
moments reset (``train/rounds.py``). Three tiers, as the JAX loop gives a
hierarchical run: the device tier (each round's subset a view of the staged
store), per-round sub-pack staging (a store over the budget), and the host
loader. Tiny widths (H 16, z 4, batch 8) on 36 synthetic utterances of 6
speakers, K = 6; the plain kernel versions.

Limits and their reasons:
- the round draw, a round's windows and its loader's order against the
  JAX loop's expressions: equal;
- a turnover against the JAX package (both resume the JAX run's epoch-0
  checkpoint, the JAX noise handed to the port's steps): the new round's
  MAP table at ``rtol 1e-5`` (the host estimate sums in fp64 in both), then
  parameters, Adam moments and the epoch's metrics at ``rtol 1e-4, atol
  1e-5``, the JAX package's own limits for its tiers
  (``tests/test_round_staging.py``);
- the staged tiers against the host tier: parameters and the epochs'
  metrics at the same limits, as the JAX package's tier test holds them
  (their MAP init sums in fp32 on the device, the host's in fp64: the
  tables differ by 3e-8, which 9 Adam steps grow to 7e-5 in the first
  moments, so those are not held there); the round-staged tier against
  the device tier (views): bit for bit, the same windows summed in the
  same order;
- K = 3 against K = 1, and a run killed inside a round and resumed against
  the run never killed: bit for bit (the folded train loss to 1e-12).
"""

import dataclasses
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.config import DataConfig as JaxDataConfig
from pytorch_scalablefhvae_tpu.config import (
    ExperimentConfig as JaxExperimentConfig,
)
from pytorch_scalablefhvae_tpu.config import ModelConfig as JaxModelConfig
from pytorch_scalablefhvae_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_scalablefhvae_tpu.data.loader import (
    SegmentLoader as JaxSegmentLoader,
)
from pytorch_scalablefhvae_tpu.data.segments import (
    SegmentDataset as JaxSegmentDataset,
)
from pytorch_scalablefhvae_tpu.features.pipeline import preprocess_data
from pytorch_scalablefhvae_tpu.train import loop as jax_loop
from pytorch_scalablefhvae_tpu.train.driver import (
    build_loaders as jax_build_loaders,
)
from pytorch_scalablefhvae_tpu.train.driver import (
    train_from_config as jax_train_from_config,
)
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_scalablefhvae_tpu_torch.data.device_store import (
    STORE_TAIL_SLACK,
    DeviceDataSource,
)
from pytorch_scalablefhvae_tpu_torch.models.base import build_model
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train import rounds, step
from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders
from pytorch_scalablefhvae_tpu_torch.train.loop import run_training

CPU = torch.device("cpu")
K = 6
RUN = "synthetic_np_fbank"
STEM = f"fhvae_{RUN}"
WIDTHS = ["--z1-hus", "16", "16", "--z2-hus", "16", "16", "--x-hus", "16",
          "16", "--z1-dim", "4", "--z2-dim", "4"]
RTOL, ATOL = 1e-4, 1e-5       # tests/test_round_staging.py's limits
RTOL_TABLE = 1e-5             # a MAP table from fp64 host sums, both sides
STAGED = "stage their subset device-resident"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    preprocess_data(JaxExperimentConfig(data=JaxDataConfig(
        dataset="synthetic", synthetic_speakers=6, synthetic_utts=8)),
        root=root)
    return root


@pytest.fixture(scope="module")
def pack_bytes(corpus):
    lens = (corpus / RUN / "train" / "len.scp").read_text().split()[1::2]
    return sum(int(n) for n in lens) * 80 * 4


def train_args(corpus, exp_root, *extra, epochs: int = 2):
    return ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(corpus), "--mvn-path", str(corpus / "mvn.json"),
            "--training-batch-size", "8", "--dev-batch-size", "64",
            "--exp-root", str(exp_root), "--device", "cpu", "--epochs",
            str(epochs), "--hierarchical", "--num-hierarchical-sequences",
            str(K), *WIDTHS, *extra]


def run_dir(exp_root, epochs: int = 2) -> Path:
    return Path(exp_root) / RUN / f"fhvae_e{epochs}_p10_a10.0"


def metrics(d):
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


def arrays(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_close_runs(got: Path, want: Path, epoch: int = 1):
    """The parameters of the two runs' epoch checkpoints and every metric
    of their epochs within ``RTOL``, ``ATOL``."""
    a = arrays(got / f"{STEM}_e{epoch}.npz")
    b = arrays(want / f"{STEM}_e{epoch}.npz")
    assert set(a) == set(b)
    for k in a:
        if not k.startswith(("adam_", "step", "count")):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    for g, w in zip(metrics(got), metrics(want), strict=True):
        for k in ("train_loss", "val_loss", "val_lower_bound", "val_log_qy"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def assert_same_runs(got: Path, want: Path, epoch: int = 1,
                     dev_rtol: float = 0.0):
    """The epoch checkpoints bit for bit, the dev metrics equal (to
    ``dev_rtol`` where one run's dev split is staged and the other's is
    not), the train loss to 1e-12 (a resumed epoch adds its pre-kill
    partials)."""
    a = arrays(got / f"{STEM}_e{epoch}.npz")
    b = arrays(want / f"{STEM}_e{epoch}.npz")
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for g, w in zip(metrics(got), metrics(want), strict=True):
        for k in ("train_steps", "step"):
            assert g[k] == w[k], (g["epoch"], k)
        for k in ("val_loss", "val_lower_bound", "val_log_qy"):
            np.testing.assert_allclose(g[k], w[k], rtol=dev_rtol, atol=0,
                                       err_msg=k)
        np.testing.assert_allclose(g["train_loss"], w["train_loss"],
                                   rtol=1e-12, atol=0)


# ------------------------------------------------------------ the draw


@pytest.mark.parametrize("rand_seg", [False, True], ids=["windows", "random"])
@pytest.mark.parametrize("every,epoch", [(1, 0), (1, 1), (1, 3), (2, 0),
                                         (2, 1), (2, 3)])
def test_round_draw_matches_jax(corpus, every, epoch, rand_seg):
    """The keys of ``epoch``'s round, its dataset's windows and its
    loader's order, against the JAX loop's expressions for them
    (``train/loop.py:962-1010``), on the JAX package's own store."""
    seed = 3
    jcfg = JaxExperimentConfig(data=JaxDataConfig(
        dataset="synthetic", mvn_path=str(corpus / "mvn.json"),
        training_batch_size=8, rand_seg=rand_seg))
    jds = jax_build_loaders(jcfg, data_root=corpus)[0].dataset
    cfg = ExperimentConfig(data=DataConfig(
        dataset="synthetic", mvn_path=str(corpus / "mvn.json"),
        training_batch_size=8, rand_seg=rand_seg))
    full = build_loaders(cfg, corpus, True)[0].dataset

    e0 = epoch - epoch % every
    want_keys = list(np.random.default_rng((seed + 23) * 1_000_003 + e0)
                     .choice(jds.store.seq_keys, size=K, replace=False))
    jsub = JaxSegmentDataset(jds.store.subset(want_keys),
                             seg_len=jds.seg_len, seg_shift=jds.seg_shift,
                             rand_seg=jds.rand_seg, seed=seed + e0)
    jloader = JaxSegmentLoader(jsub, 8, shuffle=True, seed=seed + 31 * e0)
    jloader.set_epoch(epoch)

    keys = rounds.round_keys(full.store.seq_keys, K, seed, e0)
    assert keys == want_keys
    for materialize in (False, True):
        loader = rounds.round_loader(
            full, full.store.subset(keys, materialize=materialize), 8, seed,
            e0)
        loader.set_epoch(epoch)
        ds = loader.dataset
        for name in ("seq_idx", "starts", "nsegs"):
            np.testing.assert_array_equal(getattr(ds, name),
                                          getattr(jsub, name), err_msg=name)
        np.testing.assert_array_equal(loader._order(), jloader._order())
        for i in range(K):
            np.testing.assert_array_equal(ds.store.sequence(i),
                                          jsub.store.sequence(i))


# ------------------------------------------------- a turnover against JAX


def jax_config(corpus, epochs: int = 1):
    return JaxExperimentConfig(
        data=JaxDataConfig(dataset="synthetic",
                           mvn_path=str(corpus / "mvn.json"),
                           training_batch_size=8, dev_batch_size=64,
                           data_placement="host"),
        model=JaxModelConfig(model_type="fhvae", z1_hus=(16, 16),
                             z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4,
                             z2_dim=4, use_pallas="never",
                             lstm_pallas="never", lstm_mm_dtype="float32"),
        train=JaxTrainConfig(epochs=epochs, sample_hierarchical=True,
                             num_hierarchical_sequences=K))


@pytest.fixture(scope="module")
def jax_epoch0(corpus, tmp_path_factory):
    """The JAX package's hierarchical epoch 0 (host loader, K = 6): its
    run directory."""
    root = tmp_path_factory.mktemp("jax0")
    cfg = jax_config(corpus)
    jax_train_from_config(cfg, corpus, root, is_preprocessed=True,
                          verbose=False)
    return cfg.exp_dir(root)


def jax_noise(rng, step_no, model, rows):
    """The noise ``FHVAE.apply`` draws inside JAX's step number ``step_no``."""
    k_enc, _ = jax.random.split(jax.random.fold_in(rng, step_no))
    k2, k1 = jax.random.split(k_enc)
    return {"z2": torch.tensor(np.asarray(jax.random.normal(
                k2, (rows, model.z2_dim), jnp.float32))),
            "z1": torch.tensor(np.asarray(jax.random.normal(
                k1, (rows, model.z1_dim), jnp.float32)))}


@pytest.mark.parametrize("every", [1, 2])
def test_turnover_matches_jax(corpus, tmp_path, jax_epoch0, monkeypatch,
                              every):
    """Both packages resume the JAX run's ``e0.npz`` for epoch 1. With one
    epoch a round, epoch 1 is a new round: a new draw, the chunk-skip MAP
    init over the host loader and the moment reset, whose table is held to
    JAX's first, then the epoch. With two, the resume lands inside the
    round, and neither package re-initialises the table."""
    tables = {"jax": [], "port": []}
    real_jax = jax_loop._replace_mu2_table

    def jax_replace(state, table):
        tables["jax"].append(np.asarray(table))
        return real_jax(state, table)

    real_port = rounds.replace_mu2_table

    def port_replace(state, table):
        tables["port"].append(table.numpy().copy())
        return real_port(state, table)

    monkeypatch.setattr(jax_loop, "_replace_mu2_table", jax_replace)
    monkeypatch.setattr(rounds, "replace_mu2_table", port_replace)
    k_state = jax.random.split(jax.random.PRNGKey(0))[1]
    monkeypatch.setattr(step, "step_noise", lambda st, rows, device, mesh:
                        jax_noise(k_state, st.step, st.model, rows))

    dirs = {}
    for pkg in ("jax", "port"):
        dirs[pkg] = tmp_path / pkg / jax_epoch0.name
        shutil.copytree(jax_epoch0, dirs[pkg])
    e0 = f"{STEM}_e0.npz"
    overrides = {"epochs": "2", "hierarchical_round_epochs": str(every)}
    jax_train_from_config(jax_config(corpus), corpus, tmp_path / "jax",
                          is_preprocessed=True, verbose=False,
                          continue_from=dirs["jax"] / e0,
                          resume_overrides=overrides)
    assert main(["train", "--dataset", "synthetic", "--preprocessed",
                 "--data-root", str(corpus), "--device", "cpu",
                 "--continue-from", str(dirs["port"] / e0),
                 *[a for k, v in overrides.items()
                   for a in ("--resume-override", f"{k}={v}")]]) == 0

    assert len(tables["jax"]) == len(tables["port"]) == (every == 1)
    for got, want in zip(tables["port"], tables["jax"]):
        np.testing.assert_allclose(got, want, rtol=RTOL_TABLE, atol=1e-7)
    got = arrays(dirs["port"] / f"{STEM}_e1.npz")
    model = build_model("fhvae", 20 * 80, ModelConfig(
        z1_hus=(16, 16), z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4,
        z2_dim=4), K, feat_dim=80)
    state = step.create_train_state(model)
    ckpt.load_train_state(dirs["jax"] / f"{STEM}_e1.npz", state)
    want = {**{n: p.detach().numpy() for n, p in model.named_parameters()},
            **{f"adam_mu.{n}": v.numpy() for n, v in state.mu.items()},
            **{f"adam_nu.{n}": v.numpy() for n, v in state.nu.items()}}
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert int(got["step"]) == state.step
    g, w = metrics(dirs["port"])[-1], metrics(dirs["jax"])[-1]
    assert g["epoch"] == w["epoch"] == 1
    for k in ("train_loss", "val_loss", "val_lower_bound", "val_log_qy"):
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# ------------------------------------------------------------ the tiers


@pytest.fixture(scope="module")
def host_run(corpus, tmp_path_factory):
    root = tmp_path_factory.mktemp("host")
    assert main(train_args(corpus, root, "--data-placement", "host")) == 0
    return run_dir(root)


@pytest.fixture(scope="module")
def device_run(corpus, tmp_path_factory):
    root = tmp_path_factory.mktemp("device")
    assert main(train_args(corpus, root)) == 0
    return run_dir(root)


@pytest.fixture(scope="module")
def round_run(corpus, tmp_path_factory, pack_bytes):
    root = tmp_path_factory.mktemp("round")
    assert main(train_args(corpus, root, "--device-store-max-bytes",
                           str(pack_bytes - 1))) == 0
    return run_dir(root)


@pytest.mark.parametrize("tier", ["device views", "round-staged",
                                  "explicit device over the budget",
                                  "stream over the budget"])
def test_tier_matches_host(corpus, tmp_path, capsys, host_run, device_run,
                           pack_bytes, tier):
    """Two epochs, two turnovers, on a staged tier against the host
    loader's: ``auto`` within the budget stages the store whole; one byte
    under the store ``auto``, an explicit ``device`` and ``stream`` stage
    each round's sub-pack, say so, and train the device tier's bits."""
    budget = ["--device-store-max-bytes", str(pack_bytes - 1)]
    flags = {"device views": [],
             "round-staged": budget,
             "explicit device over the budget":
                 [*budget, "--data-placement", "device"],
             "stream over the budget":
                 [*budget, "--data-placement", "stream"]}[tier]
    assert main(train_args(corpus, tmp_path, *flags)) == 0
    out = capsys.readouterr().out
    if tier == "device views":
        assert "Training data device-resident" in out and STAGED not in out
    else:
        assert STAGED in out and "Training data device-resident" not in out
    assert out.count("Round at epoch") == 2
    assert_close_runs(run_dir(tmp_path), host_run)
    if tier != "device views":
        for epoch in (0, 1):
            assert_same_runs(run_dir(tmp_path), device_run, epoch,
                             dev_rtol=RTOL_TABLE)


@pytest.mark.parametrize("flags", [
    ["--transfer-dtype", "int8", "--data-placement", "stream"],
    ["--transfer-dtype", "bfloat16", "--data-placement", "stream"],
    ["--rand-seg", "true"],
], ids=["round-staged int8", "round-staged bf16", "device random windows"])
def test_other_map_inits_run(corpus, tmp_path, capsys, flags):
    """The array-plan MAP init (int8 stores, random windows) and bf16 rows
    through the chunked one: two rounds, finite."""
    assert main(train_args(corpus, tmp_path, *flags)) == 0
    assert capsys.readouterr().out.count("Round at epoch") == 2
    for r in metrics(run_dir(tmp_path)):
        assert np.isfinite([r["train_loss"], r["val_lower_bound"]]).all()


@pytest.mark.parametrize("placement", ["device", "stream", "auto"])
def test_budget_below_one_sequence(corpus, tmp_path, capsys, placement):
    """A budget whose three quarters hold less than the longest sequence
    and the slack: an explicit staged placement raises the JAX package's
    ``ValueError``; ``auto`` trains from the host loader."""
    cfg = ExperimentConfig(data=DataConfig(
        dataset="synthetic", mvn_path=str(corpus / "mvn.json")))
    store = build_loaders(cfg, corpus, True)[0].dataset.store
    floor = int(store.lens.max()) + STORE_TAIL_SLACK
    budget = floor * 80 * 4 * 4 // 3 - 80 * 4
    args = train_args(corpus, tmp_path, "--device-store-max-bytes",
                      str(budget), "--data-placement", placement,
                      epochs=1)
    if placement != "auto":
        with pytest.raises(ValueError, match="sub-pack"):
            main(args)
        return
    assert main(args) == 0
    out = capsys.readouterr().out
    assert STAGED not in out and "Round at epoch 0" in out


def test_reduced_round_size_is_announced_quietly(corpus, capsys, tmp_path):
    """A budget under the K longest sequences lowers K, and says so with
    ``verbose=False``; the table has the lower K's rows."""
    cfg = ExperimentConfig(
        data=DataConfig(dataset="synthetic",
                        mvn_path=str(corpus / "mvn.json"),
                        training_batch_size=8, dev_batch_size=64),
        model=ModelConfig(model_type="fhvae", z1_hus=(16, 16),
                          z2_hus=(16, 16), x_hus=(16, 16),
                          z1_dim=4, z2_dim=4),
        train=TrainConfig(epochs=1, sample_hierarchical=True,
                          num_hierarchical_sequences=K))
    train_loader, dev_loader = build_loaders(cfg, corpus, True)
    lens = np.sort(train_loader.dataset.store.lens)[::-1]
    rows = int(lens[:3].sum()) + STORE_TAIL_SLACK
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, device_store_max_bytes=-(-rows * 80 * 4 * 4 // 3)))
    capsys.readouterr()
    res = run_training(cfg, train_loader, dev_loader, tmp_path,
                       device="cpu", verbose=False)
    out = capsys.readouterr().out
    assert f"Hierarchical round size reduced {K} -> 3: a round's " \
        "worst-case sub-pack must fit the device-store budget (raise " \
        "--device-store-max-bytes or use --transfer-dtype bfloat16/int8 " \
        "for larger rounds)\n" in out
    assert STAGED not in out and "Round at epoch" not in out
    assert res.state.model.mu2_table.shape[0] == 3


# ------------------------------------------------------------ in place


def test_turnover_is_in_place(corpus):
    """Two turnovers of the round-staged tier: the table, its moments and
    the staged buffer keep their addresses; the table's moments are zero
    and every other moment is untouched."""
    cfg = ExperimentConfig(
        data=DataConfig(dataset="synthetic",
                        mvn_path=str(corpus / "mvn.json"),
                        training_batch_size=8),
        model=ModelConfig(model_type="fhvae", z1_hus=(16, 16),
                          z2_hus=(16, 16), x_hus=(16, 16),
                          z1_dim=4, z2_dim=4),
        train=TrainConfig(sample_hierarchical=True,
                          num_hierarchical_sequences=K))
    loader = build_loaders(cfg, corpus, True)[0]
    ds = loader.dataset
    ceiling = int(np.sort(ds.store.lens)[-K:].sum()) + STORE_TAIL_SLACK
    source = DeviceDataSource(ds.store.subset([], materialize=True), CPU,
                              pad_to_rows=ceiling)
    model = build_model("fhvae", 20 * 80, cfg.model, K, feat_dim=80,
                        generator=torch.Generator().manual_seed(0))
    state = step.create_train_state(model)
    g = torch.Generator().manual_seed(1)
    for moments in (state.mu, state.nu):
        for v in moments.values():
            v.copy_(torch.rand(v.shape, generator=g))
    before = {n: (state.mu[n].clone(), state.nu[n].clone())
              for n in state.mu}
    ptrs = (model.mu2_table.data_ptr(), state.mu["mu2_table"].data_ptr(),
            state.nu["mu2_table"].data_ptr(), source.data.data_ptr())
    r = rounds.Rounds(cfg, loader, "round", source, K, CPU)
    tables = []
    for epoch in (0, 1):
        sub = r.loader_for(epoch, state, resumed=False, verbose=False)
        tables.append(model.mu2_table.detach().clone())
        assert (model.mu2_table.data_ptr(), state.mu["mu2_table"].data_ptr(),
                state.nu["mu2_table"].data_ptr(),
                source.data.data_ptr()) == ptrs
        # the round is gathered from the held store: its rows are the
        # sub-pack's of its keys
        want = ds.store.subset(sub.dataset.store.seq_keys,
                               materialize=True).data
        rows = want.shape[0]
        np.testing.assert_array_equal(source.data[:rows].numpy(), want)
        assert not source.data[rows:].any()
    assert not torch.equal(tables[0], tables[1])
    for n, (mu, nu) in before.items():
        if n == "mu2_table":
            assert not state.mu[n].any() and not state.nu[n].any()
        else:
            assert torch.equal(state.mu[n], mu) and torch.equal(state.nu[n],
                                                                nu), n
    with pytest.raises(ValueError, match="does not fit"):
        source.restage(ds.store)
    with pytest.raises(ValueError, match="pad_to_rows"):
        DeviceDataSource(ds.store, CPU, pad_to_rows=ceiling)


# ------------------------------------------------- K = 3, kill and resume


def test_k3_equals_k1_over_a_turnover(corpus, tmp_path, round_run,
                                      pack_bytes):
    assert main(train_args(corpus, tmp_path, "--device-store-max-bytes",
                           str(pack_bytes - 1), "--steps-per-dispatch",
                           "3")) == 0
    assert_same_runs(run_dir(tmp_path), round_run)
    assert_same_runs(run_dir(tmp_path), round_run, epoch=0)


TIERS = {"device": [], "round-staged": ["--data-placement", "stream"],
         "host": ["--data-placement", "host"]}


@pytest.mark.parametrize("tier", list(TIERS))
def test_kill_inside_a_round_and_resume(corpus, tmp_path, capsys, pack_bytes,
                                        tier):
    """Two-epoch rounds: a run stopped by ``--max-steps`` in the round's
    second epoch and resumed from its step checkpoint equals the run never
    stopped, and the resume re-enters the round with its restored table."""
    flags = [*TIERS[tier], "--hierarchical-round-epochs", "2"]
    if tier == "round-staged":
        flags += ["--device-store-max-bytes", str(pack_bytes - 1)]
    assert main(train_args(corpus, tmp_path / "full", *flags)) == 0
    full = run_dir(tmp_path / "full")
    first = int(metrics(full)[0]["train_steps"])
    assert main(train_args(corpus, tmp_path / "cut", *flags,
                           "--ckpt-every-steps", "2", "--max-steps",
                           str(first + 2))) == 0
    cut = run_dir(tmp_path / "cut")
    last = sorted(cut.glob(f"{STEM}_e1s*.npz"))[-1]
    assert ckpt.read_checkpoint_meta(last)["step"] == first + 2
    capsys.readouterr()
    assert main(["train", "--dataset", "synthetic", "--preprocessed",
                 "--data-root", str(corpus), "--device", "cpu",
                 "--continue-from", str(last), "--resume-override",
                 "max_steps=0"]) == 0
    out = capsys.readouterr().out
    assert "Round at epoch 0 (6 sequences, 2 epochs, re-entered" in out
    assert "map_init" not in out
    assert_same_runs(cut, full)
    assert not list(cut.glob(f"{STEM}_e*s*.npz"))


def test_restore_with_another_k_raises(corpus, round_run, tmp_path):
    """A hierarchical checkpoint's table has K rows: a resume whose K
    differs names both and the settings that set K."""
    shutil.copytree(round_run, tmp_path / "run")
    with pytest.raises(ValueError, match=r"table of 6 rows, but this run's "
                       r"round size K is 5.*--device-store-max-bytes"):
        main(["train", "--dataset", "synthetic", "--preprocessed",
              "--data-root", str(corpus), "--device", "cpu",
              "--continue-from", str(tmp_path / "run" / f"{STEM}_e0.npz"),
              "--resume-override", "num_hierarchical_sequences=5"])
