"""The port's SimpleFHVAE (``--model-type simple_fhvae``) against the JAX
package's, on the CPU.

JAX ``SimpleFHVAE.init`` parameters cross over through ``params_from_jax``;
the JAX model scores ``log_qy`` with its jnp form (``use_pallas="never"``),
the port with the discriminative kernels' plain versions. Inputs come from
a numpy seed; each step's reparameterization noise is drawn from JAX's key
schedule and handed to the port.

Limits and their reasons:
- a forward (fp32): every output within rtol 1e-5 (atol 1e-5 on values
  near zero): the same products, summed in another order;
- gradients of the loss: 1e-5 of each tensor's largest value;
- ``compute_dtype="bfloat16"``: both round every MLP operand to bf16 and sum
  in fp32, so a sum in another order can flip a rounding: 3e-2 relative,
  5e-2 absolute, and the bf16 outputs must differ from the fp32 ones;
- train steps: ``tests/test_torch_train_step.py``'s limits (losses 1e-5
  relative, moments 1e-4 of their largest value, parameters 2e-4 with at
  most 0.5% of the elements over 1e-5);
- two-epoch runs on every single-device tier against the JAX run (the JAX
  initial weights and noise): train loss and dev metrics, and every final
  parameter, within 3e-4, the limit ``tests/test_torch_stream.py`` holds
  the fhvae's runs to (fp32 sums in another order over a few Adam steps);
- the port's own runs: resumed against uninterrupted bit for bit; on
  ``--mesh 2,1`` and ``1,2`` against one device at
  ``tests/test_torch_parallel.py``'s limits (first train loss 2e-5, the rest
  2e-4).
"""

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
from pytorch_scalablefhvae_tpu.features.pipeline import preprocess_data
from pytorch_scalablefhvae_tpu.models.base import build_model as jax_build
from pytorch_scalablefhvae_tpu.models.base import (
    loss_from_outputs as jax_loss,
)
from pytorch_scalablefhvae_tpu.models.simple_fhvae import (
    SimpleFHVAE as JaxSimpleFHVAE,
)
from pytorch_scalablefhvae_tpu.train import step as jax_step
from pytorch_scalablefhvae_tpu.train.driver import (
    train_from_config as jax_train_from_config,
)
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.config import ModelConfig
from pytorch_scalablefhvae_tpu_torch.models.base import (
    METRIC_KEYS,
    build_model,
    loss_from_outputs,
)
from pytorch_scalablefhvae_tpu_torch.models.simple_fhvae import SimpleFHVAE
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train import graphs, loop, step
from pytorch_scalablefhvae_tpu_torch.train.checkpoint import (
    jax_leaf_names,
    params_from_jax,
    train_state_from_jax,
)

B, T, F, NSEQ, ALPHA = 6, 5, 8, 5, 10.0
DIMS = dict(z1_hus=(16, 16), z2_hus=(24, 16), x_hus=(16, 32), z1_dim=4,
            z2_dim=6, num_seqs=NSEQ)
TOL = dict(rtol=1e-5, atol=1e-5)
RUN = "synthetic_np_fbank"
STEM = f"simple_fhvae_{RUN}"
RUN_TOL = 3e-4
WIDTHS = dict(z1_hus=(16, 16), z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4,
              z2_dim=4)
FLAGS = ["--z1-hus", "16", "16", "--z2-hus", "16", "16", "--x-hus", "16",
         "16", "--z1-dim", "4", "--z2-dim", "4"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The CLI runs here train on the CPU while other test processes run
    (and, in the mesh cases, beside their ranks): every process keeps to
    one torch thread, so that none waits for a core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    jm = JaxSimpleFHVAE(input_size=T * F, use_pallas="never", **DIMS)
    params = jm.init(jax.random.PRNGKey(0))
    tm = SimpleFHVAE(T * F, feat_dim=F, **DIMS)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    return jm, params, tm


def batch(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((B, T, F))).astype(np.float32)
    seq = rng.integers(0, NSEQ, B).astype(np.int32)
    nsegs = rng.integers(1, 9, B).astype(np.float32)
    weight = np.array([1, 1, 1, 1, 1, 0], np.float32)
    return x, seq, nsegs, weight


def jax_noise(rng, step_no, z1_dim, z2_dim, rows):
    """The noise ``SimpleFHVAE.apply`` draws inside JAX's step number
    ``step_no``: ``fold_in(rng, step)``, split into the encoder's and the
    decoder's keys, the encoder's into z2's and z1's."""
    k_enc, _ = jax.random.split(jax.random.fold_in(rng, step_no))
    k2, k1 = jax.random.split(k_enc)
    return {"z2": torch.tensor(np.asarray(jax.random.normal(
                k2, (rows, z2_dim), jnp.float32))),
            "z1": torch.tensor(np.asarray(jax.random.normal(
                k1, (rows, z1_dim), jnp.float32)))}


def test_names_are_the_jax_tree(models):
    jm, params, tm = models
    names = jax_leaf_names(dict(tm.named_parameters()))
    assert names == jax_leaf_names(ckpt.params_from_jax(params))
    assert "z2_pre.layers.1.w" in names and len(names) == 25
    assert tm.model_params() == jm.model_params()
    assert tm.model_params()[0] == T * F and tm.table_rows == NSEQ
    assert tm.pz2_logvar == pytest.approx(jm.pz2_logvar)


@pytest.mark.parametrize("sample", [False, True])
def test_apply_matches_jax_all_fields(models, sample):
    jm, params, tm = models
    x, seq, nsegs, _ = batch(0)
    key = jax.random.PRNGKey(1)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(seq),
                    jnp.asarray(nsegs), key, sample=sample)
    k2, k1 = jax.random.split(jax.random.split(key)[0])
    noise = {"z2": torch.tensor(np.asarray(jax.random.normal(k2, (B, 6)))),
             "z1": torch.tensor(np.asarray(jax.random.normal(k1, (B, 4))))}
    with torch.inference_mode():
        got = tm.apply(torch.from_numpy(x), torch.from_numpy(seq),
                       torch.from_numpy(nsegs), sample=sample, noise=noise)
    assert got._fields == want._fields
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL,
                                   err_msg=name)
    assert got.x_mu.shape == (B, T, F)


def test_gradients_match_jax(models):
    jm, params, tm = models
    x, seq, nsegs, weight = batch(1, scale=3.0)
    key = jax.random.PRNGKey(2)

    def loss_of(p):
        out = jm.apply(p, jnp.asarray(x), jnp.asarray(seq),
                       jnp.asarray(nsegs), key, sample=True)
        return jax_loss(out, jnp.asarray(weight), ALPHA)[0]

    want_loss, want = jax.value_and_grad(loss_of)(params)
    k2, k1 = jax.random.split(jax.random.split(key)[0])
    noise = {"z2": torch.tensor(np.asarray(jax.random.normal(k2, (B, 6)))),
             "z1": torch.tensor(np.asarray(jax.random.normal(k1, (B, 4))))}
    out = tm.apply(torch.from_numpy(x), torch.from_numpy(seq),
                   torch.from_numpy(nsegs), sample=True, noise=noise)
    loss, metrics = loss_from_outputs(out, torch.from_numpy(weight), ALPHA)
    assert tuple(metrics) == METRIC_KEYS
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want))
    for (n, _), g in zip(named.items(), grads):
        ref = want[n].numpy()
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-5 * max(np.abs(ref).max(), 1e-30), (n, err)


def test_bf16_compute_near_jax(models):
    jm, params, tm = models
    jb = JaxSimpleFHVAE(input_size=T * F, use_pallas="never",
                        compute_dtype="bfloat16", **DIMS)
    tb = SimpleFHVAE(T * F, feat_dim=F, compute_dtype="bfloat16", **DIMS)
    tb.load_state_dict(tm.state_dict())
    x, seq, nsegs, _ = batch(5)
    want = jb.apply(params, jnp.asarray(x), jnp.asarray(seq),
                    jnp.asarray(nsegs), jax.random.PRNGKey(1), sample=False)
    with torch.inference_mode():
        args = (torch.from_numpy(x), torch.from_numpy(seq),
                torch.from_numpy(nsegs))
        got, f32 = tb.apply(*args), tm.apply(*args)
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=5e-2, rtol=3e-2, err_msg=name)
    assert not torch.equal(got.x_mu, f32.x_mu)  # the rounding is applied


def test_encode_decode_encode_z2_match_jax(models):
    jm, params, tm = models
    x, _, _, _ = batch(2)
    enc = jm.encode(params, jnp.asarray(x), jax.random.PRNGKey(2),
                    sample=False)
    with torch.inference_mode():
        got = tm.encode(torch.from_numpy(x))
        z2_only = tm.encode_z2(torch.from_numpy(x))
        dec = tm.decode(got["z1"], got["z2"], num_frames=T)
        default = tm.decode(got["z1"], got["z2"])
    for k in enc:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(enc[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(
        z2_only.numpy(), np.asarray(jm.encode_z2(params, jnp.asarray(x))),
        **TOL)
    want = jm.decode(params, enc["z1"], enc["z2"], out_shape=(T, F))
    for a, b, c in zip(dec, want, default):
        assert a.shape == (B, T, F)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        assert torch.equal(a, c)


def test_table_override_and_indices_past_the_table(models):
    jm, params, tm = models
    x, seq, nsegs, weight = batch(3)
    table = np.random.default_rng(3).standard_normal((NSEQ + 2, 6)) \
        .astype(np.float32)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(seq),
                    jnp.asarray(nsegs), jax.random.PRNGKey(1), sample=False,
                    mu2_table=jnp.asarray(table))
    _, want_m = jax_loss(want, jnp.asarray(weight), ALPHA)
    seq_past = seq.copy()
    seq_past[:2] = [NSEQ, NSEQ + 3]
    with torch.inference_mode():
        out = tm.apply(torch.from_numpy(x), torch.from_numpy(seq),
                       torch.from_numpy(nsegs),
                       mu2_table=torch.from_numpy(table))
        _, got_m = loss_from_outputs(out, torch.from_numpy(weight), ALPHA)
        past = tm.apply(torch.from_numpy(x), torch.from_numpy(seq_past),
                        torch.from_numpy(nsegs))
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), **TOL)
    assert all(torch.isfinite(v).all() for v in past)


def test_build_model_from_config():
    cfg = ModelConfig(model_type="simple_fhvae", **WIDTHS)
    m = build_model("simple_fhvae", 20 * 8, cfg, 7, feat_dim=8,
                    generator=torch.Generator().manual_seed(0))
    assert isinstance(m, SimpleFHVAE) and m.model_type == "simple_fhvae"
    assert m.mu2_table.shape == (7, 4) and m.feat_dim == 8
    again = build_model("simple_fhvae", 20 * 8, cfg, 7, feat_dim=8,
                        generator=torch.Generator().manual_seed(0))
    for a, b in zip(m.parameters(), again.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="Unknown model_type"):
        build_model("lstm_fhvae", 20 * 8, cfg, 7)


# ------------------------------------------------------------ train steps


@pytest.fixture(scope="module")
def trajectory():
    """Four steps on both sides from the same start; the first batch is
    scaled so that its gradient norm passes the clip at 100."""
    jm = JaxSimpleFHVAE(input_size=T * F, use_pallas="never", **DIMS)
    opt = jax_step.make_optimizer(1e-3, 0.95, 0.999)
    jstate = jax_step.create_train_state(jm, opt, seed=0)
    jfn = jax_step.make_train_step(jm, opt, ALPHA, donate=False)
    tm = SimpleFHVAE(T * F, feat_dim=F, **DIMS)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate.params)))
    tstate = step.create_train_state(tm, seed=0)
    topt = step.make_optimizer(1e-3, 0.95, 0.999)
    losses = []
    for s in range(4):
        arrs = batch(10 + s, scale=30.0 if s == 0 else 1.0)
        noise = jax_noise(jstate.rng, int(jstate.step), 4, 6, B)
        jstate, jm_metrics = jfn(jstate, *(jnp.asarray(a) for a in arrs))
        tm_metrics = step.train_step(tstate, topt,
                                     *(torch.from_numpy(a) for a in arrs),
                                     ALPHA, noise=noise)
        losses.append((float(jm_metrics["loss"]),
                       float(tm_metrics["loss"])))
    return jstate, tstate, losses


def test_train_steps_match_jax(trajectory):
    jstate, tstate, losses = trajectory
    for want, got in losses:
        assert abs(got - want) <= 1e-5 * abs(want), losses
    names = jax_leaf_names(dict(tstate.model.named_parameters()))
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)]
    want = train_state_from_jax(leaves, names)
    assert want["step"] == tstate.step == 4 and tstate.count == 4
    got = dict(tstate.model.named_parameters())
    for n in names:
        diff = np.abs(got[n].detach().numpy() - want["params"][n])
        assert diff.max() <= 2e-4, (n, diff.max())
        assert (diff > 1e-5).mean() <= 0.005, (n, (diff > 1e-5).sum())
        for key in ("mu", "nu"):
            ref = want[key][n]
            err = np.abs(getattr(tstate, key)[n].numpy() - ref).max()
            assert err <= 1e-4 * max(np.abs(ref).max(), 1e-30), (n, key)


def test_port_checkpoint_round_trips(trajectory, tmp_path):
    _, tstate, _ = trajectory
    model = tstate.model
    path = ckpt.save_checkpoint(
        tmp_path, model, model_type=model.model_type,
        model_params=model.model_params(), run_info="r", epoch=0,
        best_epoch=0, best_val_lb=-1.0, values={}, train_state=tstate,
        extra_meta={"num_seqs": NSEQ})
    assert path.name == "simple_fhvae_r_e0.npz"
    fresh = step.create_train_state(SimpleFHVAE(T * F, feat_dim=F, **DIMS))
    meta = ckpt.load_train_state(path, fresh)
    assert meta["model_type"] == "simple_fhvae" and meta["start_epoch"] == 1
    assert fresh.step == tstate.step and fresh.count == tstate.count
    for (n, a), b in zip(fresh.params().items(), tstate.params().values()):
        assert torch.equal(a, b), n
        assert torch.equal(fresh.mu[n], tstate.mu[n])
        assert torch.equal(fresh.nu[n], tstate.nu[n])


# ------------------------------------------------------------ runs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    preprocess_data(JaxExperimentConfig(data=JaxDataConfig(
        dataset="synthetic", synthetic_speakers=6, synthetic_utts=4)),
        root=root)
    return root


def jax_config(corpus, data=None, train=None):
    return JaxExperimentConfig(
        data=JaxDataConfig(dataset="synthetic",
                           mvn_path=str(corpus / "mvn.json"),
                           training_batch_size=16, dev_batch_size=64,
                           **(data or {})),
        model=JaxModelConfig(model_type="simple_fhvae", use_pallas="never",
                             **WIDTHS),
        train=JaxTrainConfig(epochs=2, **(train or {})))


def train_args(corpus, exp_root, *extra):
    return ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(corpus), "--mvn-path", str(corpus / "mvn.json"),
            "--training-batch-size", "16", "--dev-batch-size", "64",
            "--exp-root", str(exp_root), "--device", "cpu", "--epochs", "2",
            "--model-type", "simple_fhvae", *FLAGS, *extra]


def run_dir(exp_root, epochs: int = 2) -> Path:
    return Path(exp_root) / RUN / f"simple_fhvae_e{epochs}_p10_a10.0"


def metrics(d):
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


def arrays(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jax_runs(corpus, tmp_path_factory):
    """The JAX package's two-epoch runs: the device tier (which trains as
    its host loader does), the streamed tier, and hierarchical rounds of 6
    sequences; each run's directory."""
    cases = {
        "device": jax_config(corpus),
        "stream": jax_config(corpus, data=dict(
            data_placement="stream", stream_chunk_bytes=60_000)),
        "hier": jax_config(corpus, train=dict(
            sample_hierarchical=True, num_hierarchical_sequences=6)),
    }
    out = {}
    for name, cfg in cases.items():
        root = tmp_path_factory.mktemp(f"jax_{name}")
        jax_train_from_config(cfg, corpus, root, is_preprocessed=True,
                              verbose=False)
        out[name] = cfg.exp_dir(root)
    return out


def port_from_jax(monkeypatch, corpus, num_seqs_of=None):
    """The port's runs start from the JAX run's initial parameters (seed 0)
    and draw every step's JAX noise, eager or in a K-step bundle."""
    k_init, k_state = jax.random.split(jax.random.PRNGKey(0))
    real_build = loop.build_model

    def build_from_jax(model_type, input_size, cfg, num_seqs, **kw):
        model = real_build(model_type, input_size, cfg, num_seqs, **kw)
        jm = jax_build(model_type, input_size, jax_config(corpus).model,
                       num_seqs)
        model.load_state_dict(ckpt.params_from_jax(jax.tree_util.tree_map(
            np.asarray, jm.init(k_init))))
        return model

    monkeypatch.setattr(loop, "build_model", build_from_jax)
    monkeypatch.setattr(step, "step_noise", lambda st, rows, device, mesh:
                        jax_noise(k_state, st.step, 4, 4, rows))
    # a bundle seeds step i's generator from (seed, step + i)
    monkeypatch.setattr(graphs, "draw_noise", lambda model, g, rows, device:
                        jax_noise(k_state, g.initial_seed() & 0xFFFFFFFF,
                                  4, 4, rows))


def assert_run_matches_jax(got: Path, want: Path):
    g_recs, w_recs = metrics(got), metrics(want)
    assert [r["epoch"] for r in g_recs] == [r["epoch"] for r in w_recs] \
        == [0, 1]
    for g, w in zip(g_recs, w_recs):
        for k in ("train_loss", "val_loss", "val_lower_bound", "val_log_qy",
                  "val_log_px_z", "val_neg_kld_z1", "val_neg_kld_z2",
                  "val_log_pmu2"):
            np.testing.assert_allclose(g[k], w[k], rtol=RUN_TOL, err_msg=k)
    state = step.create_train_state(build_model(
        "simple_fhvae", 20 * 80, ModelConfig(**WIDTHS),
        ckpt.read_checkpoint_meta(want / f"{STEM}_e1.npz")["num_seqs"]))
    ckpt.load_train_state(want / f"{STEM}_e1.npz", state)
    port = arrays(got / f"{STEM}_e1.npz")
    assert int(port["step"]) == state.step == g_recs[-1]["step"] > 4
    for n, p in state.params().items():
        np.testing.assert_allclose(port[n], p.detach().numpy(), rtol=RUN_TOL,
                                   atol=RUN_TOL, err_msg=n)


@pytest.mark.parametrize("tier,extra", [
    ("device", []),
    ("device", ["--data-placement", "host"]),
    ("device", ["--steps-per-dispatch", "4"]),
    ("stream", ["--data-placement", "stream", "--stream-chunk-bytes",
                "60000"]),
    ("hier", ["--hierarchical", "--num-hierarchical-sequences", "6"]),
], ids=["device", "host", "k4", "stream", "hierarchical"])
def test_cli_run_matches_jax(corpus, jax_runs, tmp_path, monkeypatch, capsys,
                             tier, extra):
    port_from_jax(monkeypatch, corpus)
    assert main(train_args(corpus, tmp_path, *extra)) == 0
    out = capsys.readouterr().out
    staged = {"device": "Training data device-resident",
              "stream": "Training data streams through the device",
              "hier": "Round at epoch 1 (6 sequences"}[tier]
    assert (staged in out) != ("host" in extra)
    assert_run_matches_jax(run_dir(tmp_path), jax_runs[tier])


def test_jax_checkpoint_resumes_in_the_port(corpus, jax_runs, tmp_path,
                                            monkeypatch):
    """The JAX run's epoch-0 ``.npz`` (its leaves in ``load_params``'
    order) resumed by the port's CLI for epoch 1: the JAX run's epoch 1."""
    port_from_jax(monkeypatch, corpus)
    exp = tmp_path / jax_runs["device"].name
    shutil.copytree(jax_runs["device"], exp)
    for p in exp.glob("*_e1.*"):
        p.unlink()
    (exp / "metrics.jsonl").write_text(
        (exp / "metrics.jsonl").read_text().splitlines()[0] + "\n")
    assert main(["train", "--dataset", "synthetic", "--preprocessed",
                 "--data-root", str(corpus), "--device", "cpu",
                 "--continue-from", str(exp / f"{STEM}_e0.npz")]) == 0
    assert ckpt.read_checkpoint_meta(exp / f"{STEM}_e1.npz")["format"] \
        == ckpt.PORT_FORMAT
    assert_run_matches_jax(exp, jax_runs["device"])


@pytest.fixture(scope="module")
def port_run(corpus, tmp_path_factory):
    root = tmp_path_factory.mktemp("port")
    assert main(train_args(corpus, root)) == 0
    return run_dir(root)


def test_resumed_run_equals_uninterrupted(corpus, tmp_path, port_run):
    assert main(train_args(corpus, tmp_path, "--epochs", "1")) == 0
    first = run_dir(tmp_path, 1) / f"{STEM}_e0.npz"
    assert main(train_args(corpus, tmp_path, "--continue-from", str(first),
                           "--resume-override", "epochs=2")) == 0
    a = arrays(run_dir(tmp_path, 1) / f"{STEM}_e1.npz")
    b = arrays(port_run / f"{STEM}_e1.npz")
    assert set(a) == set(b) and "adam_mu.z2_pre.layers.0.w" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("shape", ["2,1", "1,2"])
def test_mesh_matches_one_device(corpus, tmp_path, port_run, monkeypatch,
                                 shape):
    """``--mesh`` ranks on gloo, started by the CLI, against the run on one
    device (``tests/test_torch_parallel.py``'s harness and limits)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert main(train_args(corpus, tmp_path, "--mesh", shape,
                           "--dist-backend", "gloo", "--dist-timeout",
                           "60")) == 0
    got, want = metrics(run_dir(tmp_path)), metrics(port_run)
    assert [r["epoch"] for r in got] == [0, 1]
    for g, w in zip(got, want):
        assert g["train_steps"] == w["train_steps"]
        np.testing.assert_allclose(g["train_loss"], w["train_loss"],
                                   rtol=2e-5 if g["epoch"] == 0 else 2e-4)
        for k in ("val_loss", "val_lower_bound", "val_log_qy"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-4, err_msg=k)
    a = arrays(run_dir(tmp_path) / f"{STEM}_e1.npz")
    b = arrays(port_run / f"{STEM}_e1.npz")
    n = b["mu2_table"].shape[0]
    np.testing.assert_allclose(a["mu2_table"][:n], b["mu2_table"],
                               rtol=2e-4, atol=2e-5)


def test_eval_probe_encode_and_serve(corpus, port_run, tmp_path, capsys):
    """``eval`` and ``probe`` of the run's best checkpoint (the eval bound
    is the best epoch's dev bound: the same weights and split, the MAP
    sums in fp64 against the staged pass's fp32, 1e-5 relative), then
    ``encode`` and ``serve`` of its copy whose config says ``extractor:
    "jax"``, whose latents agree with the numpy extractor's within the
    features' own distance (2e-3, ``tests/test_torch_serve.py``)."""
    import dataclasses
    import io

    from pytorch_scalablefhvae_tpu_torch.config import ExperimentConfig
    from pytorch_scalablefhvae_tpu_torch.eval.serve import serve

    exp = tmp_path / "exp"
    shutil.copytree(port_run, exp)
    assert main(["eval", str(exp), "--set-name", "dev", "--data-root",
                 str(corpus), "--device", "cpu"]) == 0
    got = json.loads((exp / "eval" / "dev" / "metrics.json").read_text())
    best = ckpt.read_checkpoint_meta(ckpt.find_best_checkpoint(exp))
    rec = metrics(exp)[best["best_epoch"]]
    np.testing.assert_allclose(got["lower_bound"], rec["val_lower_bound"],
                               rtol=1e-5)
    capsys.readouterr()
    assert main(["probe", str(exp), "--set-name", "dev", "--data-root",
                 str(corpus), "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == got["probes"]

    wavs = corpus / RUN / "wav"
    cfg = ExperimentConfig.load(exp / "config.json")
    cfg.replace(features=dataclasses.replace(
        cfg.features, extractor="jax")).save(exp / "config.json")
    assert main(["encode", str(exp), str(wavs), "--output-dir",
                 str(tmp_path / "enc"), "--device", "cpu", "--batch-size",
                 "64"]) == 0
    assert main(["encode", str(port_run), str(wavs), "--output-dir",
                 str(tmp_path / "enc_np"), "--device", "cpu",
                 "--batch-size", "64"]) == 0
    by_name = {}
    for d in ("enc", "enc_np"):
        names = json.loads((tmp_path / d / "sequences.json").read_text())
        with np.load(tmp_path / d / "latents.npz") as z:
            by_name[d] = dict(zip(names, z["mu2_map"]))
    assert set(by_name["enc"]) == set(by_name["enc_np"])
    for k, v in by_name["enc"].items():
        np.testing.assert_allclose(v, by_name["enc_np"][k], atol=2e-3,
                                   rtol=0, err_msg=k)

    stdin = io.StringIO(json.dumps({"id": "r", "inputs": [str(wavs)]})
                        + "\n" + json.dumps({"cmd": "shutdown"}) + "\n")
    stdout = io.StringIO()
    assert serve(exp, batch_size=64, device="cpu", stdin=stdin,
                 stdout=stdout) == 0
    ready, resp, bye = (json.loads(line)
                        for line in stdout.getvalue().splitlines())
    assert ready["model_type"] == "simple_fhvae" and bye["bye"]
    assert resp["ok"] and resp["utterances"] == len(by_name["enc"])
    assert np.asarray(resp["mu2_map"]).shape == (resp["utterances"], 4)
    assert np.isfinite(np.asarray(resp["z1_seq_mean"])).all()
