"""The port's streamed data tier and compressed staging, on the CPU.

``--data-placement stream`` (and ``auto`` over ``--device-store-max-bytes``)
double-buffers sequence-aligned chunks of the packed store through the
device (``data/stream_store.py``); ``--transfer-dtype bfloat16|int8``
stages the store, its chunks and the dev split in half or a quarter of the
bytes. On the CPU the port runs its plain versions with the same code; the
JAX side runs at ``use_pallas="never"`` / ``lstm_pallas="never"`` with
fp32 LSTM operands, its dev MAP pass through the Pallas gather in interpret
mode, as its own tests run it here.

Limits and their reasons:
- the port's streamed ``run_training`` against the JAX package's, same
  initial weights and the JAX noise handed to the port's steps, one epoch
  in each transfer dtype: the epoch's train loss and dev metrics, and every
  final parameter, within 3e-4 (relative for the metrics, absolute and
  relative for the parameters): fp32 sums in another order over a few
  Adam steps, the tolerance ``tests/test_torch_train_loop.py`` holds the
  JAX extractor to;
- a streamed epoch against a host replay of its own schedule (windows cut
  on the host from the numpy store, rounded to bfloat16 by torch, or
  dequantized from each chunk's int8 codes by ``quantize.dequantize``):
  the same batches in the same order, padding rows of weight 0, so
  parameters, Adam moments and losses are equal bit for bit;
- K = 3 against K = 1 on the streamed tier, and a resumed streamed run
  against an uninterrupted one: bit for bit;
- kernel #8's plain version on a bfloat16 store against the JAX kernel in
  interpret mode: a copy, so bit for bit.
"""

import json
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.config import (
    DataConfig as JaxDataConfig,
    ExperimentConfig as JaxExperimentConfig,
    ModelConfig as JaxModelConfig,
    TrainConfig as JaxTrainConfig,
)
from pytorch_scalablefhvae_tpu.data.stream_store import (
    resolve_data_mode as jax_resolve_data_mode,
)
from pytorch_scalablefhvae_tpu.features.pipeline import preprocess_data
from pytorch_scalablefhvae_tpu.models.base import build_model as jax_build
from pytorch_scalablefhvae_tpu.ops.window_gather_pallas import (
    windowed_chunk_gather as jax_window_gather,
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
from pytorch_scalablefhvae_tpu_torch.data.quantize import (
    dequantize,
    quantize_columns,
)
from pytorch_scalablefhvae_tpu_torch.data.stream_store import (
    StreamingDeviceSource,
    resolve_data_mode,
    resolve_tier,
)
from pytorch_scalablefhvae_tpu_torch.ops.window_gather import (
    windowed_chunk_gather,
)
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train import loop, step
from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

CPU = torch.device("cpu")
ALPHA = 10.0
RUN = "synthetic_np_fbank"
WIDTHS = dict(z1_hus=(16, 16), z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4,
              z2_dim=4)
FLAGS = ["--z1-hus", "16", "16", "--z2-hus", "16", "16", "--x-hus", "16",
         "16", "--z1-dim", "4", "--z2-dim", "4"]
ROWS = 180  # frames a chunk holds: two or three synthetic utterances
TOL = 3e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    cfg = JaxExperimentConfig(data=JaxDataConfig(dataset="synthetic",
                                                 synthetic_speakers=6,
                                                 synthetic_utts=4))
    preprocess_data(cfg, root=root)
    return root


def chunk_bytes(dtype: str, dim: int = 80) -> int:
    return ROWS * dim * {"bfloat16": 2, "int8": 1}.get(dtype, 4)


def configs(corpus, dtype: str, batch: int = 8, **train_kw):
    """The same run for both packages: streamed in chunks of ``ROWS``
    frames, in ``dtype``; the dev split fits the budget and is staged."""
    kw = dict(
        data=dict(dataset="synthetic", mvn_path=str(corpus / "mvn.json"),
                  training_batch_size=batch, dev_batch_size=64,
                  data_placement="stream", transfer_dtype=dtype,
                  stream_chunk_bytes=chunk_bytes(dtype)),
        model=dict(model_type="fhvae", use_pallas="never",
                   lstm_pallas="never", lstm_mm_dtype="float32", **WIDTHS),
        train=dict(epochs=1, **train_kw))
    port = ExperimentConfig(data=DataConfig(**kw["data"]),
                            model=ModelConfig(**kw["model"]),
                            train=TrainConfig(**kw["train"]))
    jax_cfg = JaxExperimentConfig(data=JaxDataConfig(**kw["data"]),
                                  model=JaxModelConfig(**kw["model"]),
                                  train=JaxTrainConfig(**kw["train"]))
    return port, jax_cfg


def records(d):
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


def jax_noise(rng, step_no, model, rows):
    """The noise ``FHVAE.apply`` draws inside JAX's step number ``step_no``."""
    k_enc, _ = jax.random.split(jax.random.fold_in(rng, step_no))
    k2, k1 = jax.random.split(k_enc)
    return {"z2": torch.tensor(np.asarray(jax.random.normal(
                k2, (rows, model.z2_dim), jnp.float32))),
            "z1": torch.tensor(np.asarray(jax.random.normal(
                k1, (rows, model.z1_dim), jnp.float32)))}


@pytest.fixture(scope="module")
def jax_init(corpus):
    """The JAX model of the corpus's runs, its initial parameters and the
    noise key, as ``create_train_state`` makes them for seed 0."""
    cfg, jax_cfg = configs(corpus, "float32")
    ds = build_loaders(cfg, corpus, True)[0].dataset
    jm = jax_build("fhvae", ds.seg_len * ds.store.dim, jax_cfg.model,
                   ds.num_seqs, feat_dim=ds.store.dim)
    k_init, k_state = jax.random.split(jax.random.PRNGKey(0))
    return jm, jm.init(k_init), k_state


def port_from_jax(monkeypatch, jax_init):
    """Make the port's runs start from the JAX initial parameters and feed
    every step the JAX noise of its step number."""
    jm, params, k_state = jax_init
    real_build = loop.build_model

    def build_from_jax(*args, **kw):
        model = real_build(*args, **kw)
        model.load_state_dict(ckpt.params_from_jax(jax.tree_util.tree_map(
            np.asarray, params)))
        return model

    monkeypatch.setattr(loop, "build_model", build_from_jax)
    monkeypatch.setattr(step, "step_noise", lambda st, rows, device, mesh:
                        jax_noise(k_state, st.step, st.model, rows))


def assert_params_match_jax(tstate, jparams):
    """The port's parameters against a JAX parameter tree (its leaves in
    ``jax_leaf_names`` order)."""
    names = ckpt.jax_leaf_names(dict(tstate.model.named_parameters()))
    want = dict(zip(names, jax.tree_util.tree_leaves(jparams)))
    params = dict(tstate.model.named_parameters())
    for n in names:
        np.testing.assert_allclose(params[n].detach().numpy(),
                                   np.asarray(want[n]), rtol=TOL, atol=TOL,
                                   err_msg=n)


def test_streamed_run_matches_jax(corpus, tmp_path, monkeypatch, capsys,
                                  jax_init):
    """One streamed epoch of both packages' ``run_training`` (float32):
    the epoch's train loss, every dev metric of the staged dev split (the
    MAP pass through kernel #8's plain version), the final parameters."""
    port_cfg, jax_cfg = configs(corpus, "float32")
    res = jax_train_from_config(jax_cfg, corpus, tmp_path / "jax",
                                is_preprocessed=True, verbose=True)
    out = capsys.readouterr().out
    assert "streams through HBM" in out and "Dev split device-resident" in out
    port_from_jax(monkeypatch, jax_init)
    train_loader, dev_loader = build_loaders(port_cfg, corpus, True)
    got = loop.run_training(port_cfg, train_loader, dev_loader,
                            tmp_path / "port", device="cpu", verbose=True)
    out = capsys.readouterr().out
    assert "Training data streams through the device" in out
    assert "Dev split device-resident" in out
    assert got.state.step == int(res.state.step)

    exp = jax_cfg.exp_dir(tmp_path / "jax")
    (want_rec,), (got_rec,) = records(exp), records(tmp_path / "port")
    assert got_rec["train_steps"] == got.state.step > 4
    for key in ("train_loss", "val_loss", "val_lower_bound", "val_log_qy",
                "val_log_px_z", "val_neg_kld_z1", "val_neg_kld_z2",
                "val_log_pmu2"):
        np.testing.assert_allclose(got_rec[key], want_rec[key], rtol=TOL,
                                   err_msg=key)
    assert_params_match_jax(got.state, res.state.params)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_streamed_epoch_matches_jax(corpus, monkeypatch, jax_init, dtype):
    """A streamed epoch in ``dtype``: the port's ``run_stream_epoch``
    against the JAX package's streamed loop body (its
    ``StreamingDeviceSource`` chunks through ``make_device_train_step``,
    as ``run_training`` runs them at K = 1): every step's loss and the
    final parameters. (The whole run's dev pass is held to JAX in
    float32 above; #8 on bfloat16 rows below.)"""
    from pytorch_scalablefhvae_tpu.data.stream_store import (
        StreamingDeviceSource as JaxStreamingDeviceSource,
    )
    from pytorch_scalablefhvae_tpu.train import step as jax_step
    from pytorch_scalablefhvae_tpu.train.device_step import (
        make_device_train_step,
    )

    cfg, _ = configs(corpus, dtype)
    loader, _ = build_loaders(cfg, corpus, True)
    ds, B = loader.dataset, loader.batch_size
    jm, params, k_state = jax_init
    opt = jax_step.make_optimizer(1e-3, 0.95, 0.999)
    jstate = jax_step.TrainState(params=params, opt_state=opt.init(params),
                                 step=jnp.int32(0), rng=k_state)
    jfn = make_device_train_step(jm, opt, ALPHA, ds.seg_len, B, 1,
                                 donate=False)
    jsrc = JaxStreamingDeviceSource(ds, chunk_bytes(dtype), B,
                                    store_dtype=dtype)
    assert len(jsrc.chunks) >= 3
    want = []
    for plan, chunk, seq_d, starts_d, _ in jsrc.epoch_batches(
            loop.stream_seed(loader, 0)):
        for b in range(plan.n_batches):
            jstate, m = jfn(jstate, chunk, seq_d, starts_d, jsrc.nsegs_tab,
                            np.int32(b * B), np.int32(plan.n_real))
            want.append(float(m["loss"][0]))

    port_from_jax(monkeypatch, jax_init)
    tstate = fresh_state(loader, cfg)
    source = StreamingDeviceSource(ds, chunk_bytes(dtype), B, CPU, dtype)
    got, real_push = [], loop.DispatchLosses.push

    def push(self, loss, rows):  # keep every step's loss as it is read
        got.extend(loss.reshape(-1).tolist())
        return real_push(self, loss, rows)

    monkeypatch.setattr(loop.DispatchLosses, "push", push)
    stats = loop.run_stream_epoch(tstate, step.make_optimizer(
        1e-3, 0.95, 0.999), source, loader, ALPHA, CPU, 0)
    assert len(got) == len(want) == tstate.step == stats.steps
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert_params_match_jax(tstate, jstate.params)


def host_replay_batches(source, epoch_seed: int, dtype: str):
    """The batches of a streamed epoch, built on the host: windows cut from
    the numpy store (int8: from each chunk's dequantized codes), padded as
    the host loader pads, in the stream schedule's order."""
    ds, B = source.dataset, source.batch_size
    store = ds.store
    for spec, order in source.epoch_schedule(epoch_seed):
        frames = store.data[spec.frame_base:spec.frame_base + spec.n_frames]
        if dtype == "int8":
            frames = dequantize(*quantize_columns(frames))
        for b0 in range(0, len(order), B):
            idx = order[b0:b0 + B]
            real = len(idx)
            idx = np.concatenate([idx, np.full(B - real, idx[0], idx.dtype)])
            seq_idx = ds.seq_idx[idx]
            rel = store.seq_starts[seq_idx] + ds.starts[idx] - spec.frame_base
            feats = torch.from_numpy(np.stack(
                [frames[a:a + ds.seg_len] for a in rel]).astype(np.float32))
            if dtype == "bfloat16":
                feats = feats.to(torch.bfloat16)
            weight = np.zeros(B, np.float32)
            weight[:real] = 1.0
            yield (feats, torch.from_numpy(seq_idx.astype(np.int32)),
                   torch.from_numpy(ds.nsegs[seq_idx].astype(np.float32)),
                   torch.from_numpy(weight)), real


def fresh_state(loader, cfg):
    ds = loader.dataset
    model = loop.build_model("fhvae", ds.seg_len * ds.store.dim, cfg.model,
                             ds.num_seqs, feat_dim=ds.store.dim,
                             generator=torch.Generator().manual_seed(0))
    return step.create_train_state(model, seed=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_stream_epoch_equals_host_replay(corpus, dtype):
    """Two streamed epochs (the int8 chunks quantized once, then reused)
    against the same schedules replayed from host batches."""
    cfg, _ = configs(corpus, dtype, batch=4)
    loader, _ = build_loaders(cfg, corpus, True)
    source = StreamingDeviceSource(loader.dataset, chunk_bytes(dtype), 4, CPU,
                                   dtype)
    assert len(source.chunks) >= 3
    opt = step.make_optimizer(1e-3, 0.95, 0.999)
    streamed, replayed = fresh_state(loader, cfg), fresh_state(loader, cfg)
    for epoch in range(2):
        stats = loop.run_stream_epoch(streamed, opt, source, loader, ALPHA,
                                      CPU, epoch)
        loss_sum, count = 0.0, 0
        for batch, real in host_replay_batches(
                source, loop.stream_seed(loader, epoch), dtype):
            loss = float(step.train_step(replayed, opt, *batch,
                                         ALPHA)["loss"])
            loss_sum, count = loss_sum + loss * real, count + real
        assert stats.train_loss == loss_sum / count
        assert stats.segments == count == len(loader.dataset)
    assert streamed.step == replayed.step == streamed.count > 0
    assert all(w is None for _, w in source.switch_waits())
    sp, rp = streamed.params(), replayed.params()
    for n in sp:
        assert torch.equal(sp[n], rp[n]), n
        assert torch.equal(streamed.mu[n], replayed.mu[n]), n
        assert torch.equal(streamed.nu[n], replayed.nu[n]), n


def cli_args(corpus, exp_root, *extra):
    return ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(corpus), "--mvn-path", str(corpus / "mvn.json"),
            "--training-batch-size", "4", "--dev-batch-size", "64",
            "--exp-root", str(exp_root), "--device", "cpu",
            "--data-placement", "stream", "--stream-chunk-bytes",
            str(chunk_bytes("float32")), *FLAGS, *extra]


def test_stream_k3_and_resume_equal_k1(corpus, tmp_path, capsys):
    """``train --data-placement stream`` at K = 3 (each chunk's batches
    three to a dispatch, its remainder eager) for two epochs, against K = 1
    for one epoch resumed for a second: metrics and checkpoints bit for
    bit, the step count continued."""
    k3 = tmp_path / "k3"
    assert main(cli_args(corpus, k3, "--epochs", "2", "--steps-per-dispatch",
                         "3")) == 0
    out = capsys.readouterr().out
    assert "3 steps per dispatch" in out and "streams through the device" in out
    k1 = tmp_path / "k1"
    assert main(cli_args(corpus, k1, "--epochs", "1")) == 0
    first = k1 / RUN / "fhvae_e1_p10_a10.0" / f"fhvae_{RUN}_e0.npz"
    assert main(cli_args(corpus, k1, "--continue-from", str(first),
                         "--resume-override", "epochs=2")) == 0
    a_dir = k3 / RUN / "fhvae_e2_p10_a10.0"
    b_dir = k1 / RUN / "fhvae_e1_p10_a10.0"
    got, want = records(a_dir), records(b_dir)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in ("train_loss", "train_steps", "step", "val_loss",
                    "val_lower_bound", "val_log_qy"):
            assert g[key] == w[key], key
    n = got[0]["train_steps"]
    assert ckpt.read_checkpoint_meta(b_dir / f"fhvae_{RUN}_e1.npz")["step"] \
        == 2 * n > 0
    with np.load(a_dir / f"fhvae_{RUN}_e1.npz") as a, \
            np.load(b_dir / f"fhvae_{RUN}_e1.npz") as b:
        assert any(k.startswith("adam_mu.") for k in a.files)
        for key in a.files:
            if key in b.files and a[key].dtype != object:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_stream_divergence_exits_2(corpus, tmp_path, capsys):
    assert main(cli_args(corpus, tmp_path, "--epochs", "2",
                         "--learning-rate", "1e18")) == 2
    assert "Training diverged" in capsys.readouterr().out


def store_of(corpus):
    cfg, _ = configs(corpus, "float32")
    return build_loaders(cfg, corpus, True)[0].dataset.store


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_resolve_tier_by_the_budget(corpus, capsys, dtype):
    """``auto`` stages the store when its bytes in the transfer dtype fit
    the budget and streams it otherwise, and says which; ``stream`` and
    ``host`` are taken as asked; ``device`` over the budget raises."""
    store = store_of(corpus)
    nbytes = store.data.shape[0] * store.dim * {"bfloat16": 2,
                                                "int8": 1}.get(dtype, 4)
    assert resolve_tier("auto", store, nbytes, dtype) == "device"
    assert "within the device-store budget" in capsys.readouterr().out
    assert resolve_tier("auto", store, nbytes - 1, dtype) == "stream"
    assert "over the device-store budget" in capsys.readouterr().out
    assert resolve_tier("stream", store, nbytes, dtype) == "stream"
    assert resolve_tier("host", store, nbytes - 1, dtype) == "host"
    with pytest.raises(ValueError, match="device-store budget"):
        resolve_tier("device", store, nbytes - 1, dtype)


def test_streamed_tier_on_a_mesh_raises(corpus):
    """On a mesh the streamed tier raises only where it raises on one device
    (``--legacy``), and ``device`` over the budget raises, the budget scaled
    by the model axis when the store is row-sharded; ``auto`` streams a
    store over it (``tests/test_torch_mesh_tiers.py`` trains it)."""
    store = store_of(corpus)
    nbytes = store.data.shape[0] * store.dim * 4
    mesh = types.SimpleNamespace(shape=(2, 2))
    with pytest.raises(ValueError, match="legacy"):
        resolve_tier("stream", store, nbytes, mesh=mesh, legacy=True)
    with pytest.raises(ValueError, match="device-store budget"):
        resolve_tier("device", store, nbytes // 2 - 1, mesh=mesh,
                     shard_store=True)
    assert resolve_tier("auto", store, nbytes - 1, mesh=mesh) == "stream"
    assert resolve_tier("auto", store, nbytes // 2, mesh=mesh,
                        shard_store=True) == "device"


@pytest.mark.parametrize("placement", ["auto", "stream", "device", "host"])
def test_legacy_and_hierarchical_resolve_as_jax(corpus, placement):
    """JAX's ``TestResolveMode``: legacy runs never stream (``stream``
    raises), hierarchical ones resolve to ``host`` where they would
    stream."""
    store = store_of(corpus)
    for max_bytes in (64, 1 << 30):
        for legacy, hier in ((True, False), (False, True), (True, True)):
            kw = dict(max_bytes=max_bytes, legacy=legacy, hierarchical=hier)
            try:
                want = jax_resolve_data_mode(placement, store, **kw)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)[:20]):
                    resolve_data_mode(placement, store, **kw)
                continue
            assert resolve_data_mode(placement, store, **kw) == want
            assert want != "stream"


def test_window_gather_plain_on_bfloat16_matches_jax():
    """Kernel #8's plain version on a bfloat16 store (the dev split staged
    at ``--transfer-dtype bfloat16``) against the Pallas kernel in
    interpret mode: the windows in bfloat16, bit for bit."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((120, 8)).astype(np.float32)
    starts = np.array([0, 17, 60, 90], np.int32)
    spb, seg, stride = 4, 10, 4
    want = jax_window_gather(jnp.asarray(x.astype(ml_dtypes.bfloat16)),
                             jnp.asarray(starts), spb=spb, seg_len=seg,
                             stride=stride, interpret=True)
    got = windowed_chunk_gather(torch.from_numpy(x).to(torch.bfloat16),
                                torch.from_numpy(starts), spb, seg, stride)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
