"""The port's device-resident data tier against the JAX package's, on the CPU.

Same numpy-seeded store and plans, same JAX-initialised weights on both
sides. The JAX side runs as its own tests run it here: the chunked MAP pass
with its Pallas gather in interpret mode, the model on its scan/jnp path
with fp32 operands; the port runs its plain versions (``--device cpu``
stages the store on the CPU).

Limits and their reasons:
- MAP tables and per-batch eval sums: rtol 1e-5, fp32 sums in another order;
- four device-tier train steps: as ``tests/test_torch_train_step.py`` holds
  the host-fed ones (loss 1e-5 relative; Adam moments 1e-4 of each tensor's
  largest value; parameters 2e-4 absolute and at most 0.5% of elements over
  1e-5, since Adam moves each element by ~lr whatever its gradient);
- host tier vs device tier of the port: the same batches in the same order,
  padding rows of weight 0 whose gradient is exactly 0, so parameters, Adam
  moments and train losses must be equal bit for bit; the dev metrics to
  rtol 1e-5, since the device MAP table sums in fp32 and the host's in fp64.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from pytorch_scalablefhvae_tpu.data.device_store import (
    DeviceDataSource as JaxDeviceDataSource,
)
from pytorch_scalablefhvae_tpu.data.feature_store import FeatureStore
from pytorch_scalablefhvae_tpu.data.loader import SegmentLoader
from pytorch_scalablefhvae_tpu.data.segments import SegmentDataset
from pytorch_scalablefhvae_tpu.features.pipeline import preprocess_data
from pytorch_scalablefhvae_tpu.models.fhvae import FHVAE as JaxFHVAE
from pytorch_scalablefhvae_tpu.train import device_step as jax_device_step
from pytorch_scalablefhvae_tpu.train import step as jax_step
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.data.device_store import (
    STORE_TAIL_SLACK,
    DeviceDataSource,
    Quantized,
    build_epoch_plan,
)
from pytorch_scalablefhvae_tpu_torch.data.quantize import dequantize
from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
from pytorch_scalablefhvae_tpu_torch.train import device_step, loop, step
from pytorch_scalablefhvae_tpu_torch.train.checkpoint import (
    jax_leaf_names,
    params_from_jax,
    train_state_from_jax,
)
from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

T, SHIFT, F, ALPHA = 10, 4, 8, 10.0
LENS = (61, 47, 33, 75, 14)  # the last is short: its chunk runs into the slack
DIMS = dict(z1_hus=(16, 16), z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4,
            z2_dim=4, num_seqs=len(LENS), feat_dim=F)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    store = FeatureStore.from_arrays({
        f"s{i}": rng.standard_normal((n, F)).astype(np.float32)
        for i, n in enumerate(LENS)})
    return store, SegmentDataset(store, seg_len=T, seg_shift=SHIFT)


@pytest.fixture(scope="module")
def models():
    jm = JaxFHVAE(input_size=T * F, use_pallas="never", lstm_pallas="never",
                  lstm_mm_dtype="float32", **DIMS)
    params = jm.init(jax.random.PRNGKey(3))
    tm = FHVAE(T * F, lstm_mm_dtype="float32", **DIMS)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    return jm, params, tm


def test_source_stages_the_store_and_its_slack(data):
    store, _ = data
    src = DeviceDataSource(store, CPU)
    rows = store.data.shape[0]
    assert src.data.dtype == torch.float32 and src.data.device == CPU
    assert src.data.shape == (rows + STORE_TAIL_SLACK, F)
    np.testing.assert_array_equal(src.data[:rows].numpy(), store.data)
    assert not src.data[rows:].any()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_compressed_staging_matches_jax(data, dtype):
    """``--transfer-dtype`` staging against the JAX package's staged store,
    slack rows included: bfloat16 rows with the bits of its ``ml_dtypes``
    cast; int8 as the same uint8 codes with fp32 ``scale`` and ``offset``,
    whose gather dequantizes to ``quantize.dequantize``'s bits."""
    store, _ = data
    src = DeviceDataSource(store, CPU, dtype)
    want = JaxDeviceDataSource(store, store_dtype=dtype).data
    rows = store.data.shape[0]
    if dtype == "bfloat16":
        assert src.data.dtype == torch.bfloat16
        assert src.data.shape == (rows + STORE_TAIL_SLACK, F)
        np.testing.assert_array_equal(src.data.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))
        return
    assert isinstance(src.data, Quantized)
    assert src.data.rows.dtype == torch.uint8
    for got, ref in zip(src.data, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    starts = torch.tensor([0, 17, rows - T])
    feats = device_step.gather_segments(src.data, starts, T)
    deq = dequantize(*(np.asarray(a) for a in want))
    np.testing.assert_array_equal(
        feats.numpy(), np.stack([deq[a:a + T] for a in starts.tolist()]))


def test_stage_epoch_uploads_the_plan(data):
    store, ds = data
    order = SegmentLoader(ds, 8, shuffle=True, seed=2)._order()
    plan, (seq, starts, nsegs) = DeviceDataSource(store, CPU).stage_epoch(
        ds, order, 8)
    want = build_epoch_plan(ds, order, 8)
    assert plan.n_real == want.n_real == len(ds) and len(seq) % 8 == 0
    np.testing.assert_array_equal(seq.numpy(), want.seq_idx)
    np.testing.assert_array_equal(starts.numpy(), want.abs_starts)
    np.testing.assert_array_equal(nsegs.numpy(), ds.nsegs.astype(np.float32))


@pytest.mark.parametrize("skip", [1, 8])
def test_chunked_map_pass_matches_jax(data, models, skip):
    store, ds = data
    jm, params, tm = models
    spb, B = 4, 8
    cps = -(-(-(-ds.nsegs // spb)) // skip)
    n_batches = max(-(-int((cps * spb).sum()) // B), 1)
    pz2_var = float(np.exp(jm.pz2_logvar))
    want = jax_device_step.make_device_map_pass_chunked(
        jm, T, SHIFT, B, n_batches, len(LENS), pz2_var, spb=spb,
        chunk_skip=skip, interpret=True)(
            params, JaxDeviceDataSource(store).data,
            jnp.asarray(store.seq_starts.astype(np.int32)),
            jnp.asarray(ds.nsegs.astype(np.int32)))
    got = device_step.device_map_pass_chunked(
        tm, DeviceDataSource(store, CPU).data,
        torch.from_numpy(store.seq_starts), torch.from_numpy(ds.nsegs),
        seg_len=T, seg_shift=SHIFT, batch_size=B, n_batches=n_batches,
        num_rows=len(LENS), pz2_var=pz2_var, spb=spb, chunk_skip=skip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_chunk_layout_reaches_the_slack(data):
    """The last, short sequence's chunk starts at its first frame and its
    region runs past the store's frames; only its real windows are valid,
    and padding chunks start at frame 0."""
    store, ds = data
    spb, rows = 4, 64
    seq_all, valid, starts = device_step.chunk_layout(
        torch.from_numpy(store.seq_starts), torch.from_numpy(ds.nsegs),
        spb=spb, seg_shift=SHIFT, rows=rows)
    chunks = -(-ds.nsegs // spb)
    n_real = int(chunks.sum())
    last = n_real - 1
    assert int(starts[last]) == store.seq_starts[-1]
    assert store.seq_starts[-1] + (spb - 1) * SHIFT + T > store.data.shape[0]
    assert valid[last * spb:(last + 1) * spb].tolist() == [1, 1, 0, 0]
    assert (starts[n_real:] == 0).all() and not valid[n_real * spb:].any()
    assert int(valid.sum()) == len(ds)
    assert (seq_all[n_real * spb:] == len(LENS) - 1).all()


def test_chunked_pass_rejects_a_region_over_the_slack(models):
    with pytest.raises(ValueError, match="tail slack"):
        device_step.device_map_pass_chunked(
            models[2], torch.zeros((8, F)), torch.zeros(1), torch.ones(1),
            seg_len=20, seg_shift=20, batch_size=16, n_batches=1, num_rows=1,
            pz2_var=0.25, spb=16)


def test_array_map_pass_matches_jax(data, models):
    store, ds = data
    jm, params, tm = models
    B = 8
    plan = build_epoch_plan(ds, np.arange(len(ds)), B)
    pz2_var = float(np.exp(jm.pz2_logvar))
    want = jax_device_step.make_device_map_pass(
        jm, T, B, plan.n_batches, len(LENS), pz2_var)(
            params, JaxDeviceDataSource(store).data, jnp.asarray(plan.seq_idx),
            jnp.asarray(plan.abs_starts), np.int32(plan.n_real))
    _, (seq, starts, _) = DeviceDataSource(store, CPU).stage_epoch(
        ds, np.arange(len(ds)), B)
    got = device_step.device_map_pass(
        tm, DeviceDataSource(store, CPU).data, seq, starts, plan.n_real,
        seg_len=T, batch_size=B, n_batches=plan.n_batches,
        num_rows=len(LENS), pz2_var=pz2_var)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_eval_pass_matches_jax(data, models):
    store, ds = data
    jm, params, tm = models
    B = 10
    order = SegmentLoader(ds, B, shuffle=True, seed=1)._order()
    plan = build_epoch_plan(ds, order, B)
    assert plan.n_real % B  # the last batch carries padding rows
    table = np.random.default_rng(4).standard_normal((len(LENS), 4)) \
        .astype(np.float32)
    jsrc = JaxDeviceDataSource(store)
    _, (jseq, jstarts, jnsegs) = jsrc.stage_epoch(ds, order, B)
    want = jax_device_step.make_device_eval_pass(
        jm, ALPHA, T, B, plan.n_batches)(
            params, jsrc.data, jseq, jstarts, jnsegs, np.int32(plan.n_real),
            jnp.asarray(table))
    src = DeviceDataSource(store, CPU)
    _, arrays = src.stage_epoch(ds, order, B)
    got = device_step.device_eval_pass(
        tm, src.data, arrays, plan.n_real, ALPHA, torch.from_numpy(table),
        batch_size=B, seg_len=T, n_batches=plan.n_batches)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (plan.n_batches,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)


def jax_noise(state, model, batch):
    """The noise ``FHVAE.apply`` draws inside JAX's train step."""
    k_enc, _ = jax.random.split(jax.random.fold_in(state.rng, state.step))
    k2, k1 = jax.random.split(k_enc)
    return {"z2": torch.tensor(np.asarray(jax.random.normal(
                k2, (batch, model.z2_dim), jnp.float32))),
            "z1": torch.tensor(np.asarray(jax.random.normal(
                k1, (batch, model.z1_dim), jnp.float32)))}


def test_device_train_steps_match_jax(data):
    store, ds = data
    B = 10
    jm = JaxFHVAE(input_size=T * F, use_pallas="never", lstm_pallas="never",
                  lstm_mm_dtype="float32", **DIMS)
    opt = jax_step.make_optimizer(1e-3, 0.95, 0.999)
    jstate = jax_step.create_train_state(jm, opt, seed=0)
    jfn = jax_device_step.make_device_train_step(jm, opt, ALPHA, T, B, k=1,
                                                 donate=False)
    tm = FHVAE(T * F, lstm_mm_dtype="float32", **DIMS)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate.params)))
    tstate = step.create_train_state(tm, seed=0)
    topt = step.make_optimizer(1e-3, 0.95, 0.999)

    order = SegmentLoader(ds, B, shuffle=True, seed=0)._order()
    jsrc = JaxDeviceDataSource(store)
    plan, jarrays = jsrc.stage_epoch(ds, order, B)
    src = DeviceDataSource(store, CPU)
    _, arrays = src.stage_epoch(ds, order, B)
    n_real = plan.n_real
    assert n_real % B
    for b in (0, 1, 2, plan.n_batches - 1):  # the last batch is padded
        noise = jax_noise(jstate, jm, B)
        jstate, jm_metrics = jfn(jstate, jsrc.data, *jarrays,
                                 np.int32(b * B), np.int32(n_real))
        tm_metrics = device_step.device_train_step(
            tstate, topt, src.data, arrays, b * B, n_real, ALPHA,
            batch_size=B, seg_len=T, noise=noise)
        want = float(jm_metrics["loss"][0])
        assert abs(float(tm_metrics["loss"]) - want) <= 1e-5 * abs(want)
    assert tstate.step == tstate.count == 4

    names = jax_leaf_names(dict(tstate.model.named_parameters()))
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)]
    want = train_state_from_jax(leaves, names)
    got = dict(tstate.model.named_parameters())
    for n in names:
        diff = np.abs(got[n].detach().numpy() - want["params"][n])
        assert diff.max() <= 2e-4, (n, diff.max())
        assert (diff > 1e-5).mean() <= 0.005, (n, (diff > 1e-5).sum())
        for key in ("mu", "nu"):
            ref = want[key][n]
            err = np.abs(getattr(tstate, key)[n].numpy() - ref).max()
            assert err <= 1e-4 * max(np.abs(ref).max(), 1e-30), (n, key)


# ----------------------------------------------------- the port's train loop

WIDTHS = ["--z1-hus", "16", "16", "--z2-hus", "16", "16", "--x-hus", "16",
          "16", "--z1-dim", "4", "--z2-dim", "4"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    cfg = ExperimentConfig(data=DataConfig(dataset="synthetic",
                                           synthetic_speakers=6,
                                           synthetic_utts=4))
    preprocess_data(cfg, root=root)
    return root


def small_config(corpus, placement, dev_batch):
    return ExperimentConfig(
        data=DataConfig(dataset="synthetic", mvn_path=str(corpus / "mvn.json"),
                        training_batch_size=32, dev_batch_size=dev_batch,
                        data_placement=placement),
        model=ModelConfig(model_type="fhvae", z1_hus=(16, 16),
                          z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4, z2_dim=4,
                          lstm_mm_dtype="float32"),
        train=TrainConfig(epochs=2))


@pytest.mark.parametrize("dev_batch,chunked", [(64, True), (40, False)],
                         ids=["chunked dev MAP", "array-plan dev MAP"])
def test_host_and_device_tiers_train_alike(corpus, tmp_path, dev_batch,
                                           chunked):
    runs = {}
    for placement in ("host", "device"):
        cfg = small_config(corpus, placement, dev_batch)
        train_loader, dev_loader = build_loaders(cfg, corpus, True)
        if placement == "device":
            split = loop.stage_split(dev_loader, CPU)
            assert (split.chunked is not None) == chunked
        d = tmp_path / placement
        res = loop.run_training(cfg, train_loader, dev_loader, d,
                                device="cpu", verbose=False)
        recs = [json.loads(line) for line in
                (d / "metrics.jsonl").read_text().splitlines()]
        runs[placement] = (res.state, recs)
    (hs, hrecs), (ds_, drecs) = runs["host"], runs["device"]
    assert hs.step == ds_.step > 0 and len(hrecs) == len(drecs) == 2
    assert [r["train_loss"] for r in hrecs] == [r["train_loss"]
                                                for r in drecs]
    hp, dp = hs.params(), ds_.params()
    for n in hp:
        assert torch.equal(hp[n], dp[n]), n
        assert torch.equal(hs.mu[n], ds_.mu[n]), n
        assert torch.equal(hs.nu[n], ds_.nu[n]), n
    for h, d in zip(hrecs, drecs):
        for k in ("val_loss", "val_lower_bound", "val_log_qy"):
            np.testing.assert_allclose(d[k], h[k], rtol=1e-5, err_msg=k)


def cli_train(corpus, exp_root, *extra):
    return main(["train", "--dataset", "synthetic", "--preprocessed",
                 "--data-root", str(corpus), "--mvn-path",
                 str(corpus / "mvn.json"), "--training-batch-size", "32",
                 "--dev-batch-size", "64", "--exp-root", str(exp_root),
                 "--device", "cpu", "--epochs", "1", *WIDTHS, *extra])


def train_store_bytes(corpus):
    cfg = small_config(corpus, "auto", 64)
    store = build_loaders(cfg, corpus, True)[0].dataset.store
    return store.data.shape[0] * store.dim * 4


def test_auto_stages_the_store_and_the_dev_split(corpus, tmp_path, capsys):
    assert cli_train(corpus, tmp_path) == 0
    out = capsys.readouterr().out
    assert "Training data device-resident" in out
    assert "Dev split device-resident" in out


def test_dev_split_stays_on_the_host_past_the_budget(corpus, tmp_path,
                                                     capsys):
    """The dev split stages only into what the training store leaves of
    the budget."""
    budget = str(train_store_bytes(corpus))
    assert cli_train(corpus, tmp_path, "--device-store-max-bytes",
                     budget) == 0
    out = capsys.readouterr().out
    assert "Training data device-resident" in out
    assert "Dev split" not in out


def test_auto_over_budget_streams(corpus, tmp_path, capsys):
    """A store one byte over the budget streams through the device in
    chunks of a quarter of it, never from the host loader; what the two
    slots leave of the budget holds no dev split."""
    budget = str(train_store_bytes(corpus) - 1)
    assert cli_train(corpus, tmp_path, "--device-store-max-bytes",
                     budget) == 0
    out = capsys.readouterr().out
    assert "over the device-store budget" in out and "streaming it" in out
    assert "Training data streams through the device" in out
    assert "device-resident" not in out and "host loader" not in out


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_auto_stages_a_compressed_store_that_fits(corpus, tmp_path, capsys,
                                                  dtype):
    """At 2 (bfloat16) or 1 (int8) byte an element, a store over the
    budget in float32 fits it, and ``auto`` stages it whole."""
    budget = str(train_store_bytes(corpus) - 1)
    assert cli_train(corpus, tmp_path, "--device-store-max-bytes", budget,
                     "--transfer-dtype", dtype) == 0
    out = capsys.readouterr().out
    assert f"in {dtype}, within the device-store budget" in out
    assert "Training data device-resident" in out


def test_host_placement_trains_from_the_host_loader(corpus, tmp_path, capsys):
    assert cli_train(corpus, tmp_path, "--data-placement", "host") == 0
    assert "device-resident" not in capsys.readouterr().out


def test_device_placement_over_budget_raises(corpus, tmp_path):
    with pytest.raises(ValueError, match="device-store budget"):
        cli_train(corpus, tmp_path, "--data-placement", "device",
                  "--device-store-max-bytes", "1")
