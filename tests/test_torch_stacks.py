"""LSTM stacks the recurrence kernels do not take, on the CPU.

A stack that is not two equal-width layers at T >= 2 within the kernels'
width (one or three cells, unequal widths, T = 1, a wide two-layer stack)
runs ``models/fhvae.py`` ``plain_stack``, a time loop per layer: the
counterpart of the JAX package's scan path (``run_lstm``), on which the
reference has no Pallas kernel. The route is fixed by the stack's shape
when the model is built. The JAX side runs at ``lstm_pallas="never"``.

Limits and their reasons:
- ``plain_stack`` and the model against JAX ``run_lstm`` / ``FHVAE`` on the
  same weights and inputs, forward and gradients: rtol 1e-5 / atol 1e-6
  (fp32 sums in another order);
- one epoch of both packages' ``run_training`` from the JAX initial
  parameters with the JAX noise handed to the port: every metric and
  parameter within rtol 1e-4 / atol 1e-5 (``tests/test_torch_hier.py``'s
  limits for whole runs);
- K = 3 against K = 1 on the port's device tier: bit for bit.
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
from pytorch_scalablefhvae_tpu.models.fhvae import FHVAE as JaxFHVAE
from pytorch_scalablefhvae_tpu.models.fhvae import init_lstm_stack, run_lstm
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
from pytorch_scalablefhvae_tpu_torch.models import fhvae as port_fhvae
from pytorch_scalablefhvae_tpu_torch.models.base import loss_from_outputs
from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE, plain_stack
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt
from pytorch_scalablefhvae_tpu_torch.train import loop, step
from pytorch_scalablefhvae_tpu_torch.train.driver import build_loaders

RUN = "synthetic_np_fbank"
STEM = f"fhvae_{RUN}"
TOL = dict(rtol=1e-5, atol=1e-6)
RTOL, ATOL = 1e-4, 1e-5
B, F, NSEQ = 5, 8, 4
# the stacks the kernels do not take, by the three flags' widths
STACKS = {
    "one cell": dict(z2_hus=(16,)),
    "three cells": dict(z1_hus=(12, 12, 12)),
    "unequal": dict(x_hus=(16, 8)),
    "all three": dict(z1_hus=(16,), z2_hus=(12, 8), x_hus=(8, 8, 8)),
}
# the CLI's flags take two widths each: unequal ones reach the plain route
MIXED = ["--z1-hus", "16", "16", "--z2-hus", "16", "8", "--x-hus", "12",
         "8", "--z1-dim", "4", "--z2-dim", "4"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("widths,T", [((8,), 5), ((8, 8, 8), 4),
                                      ((12, 8), 5), ((8, 8), 1),
                                      ((520, 520), 3)],
                         ids=["one", "three", "unequal", "T1", "wide"])
def test_plain_stack_matches_run_lstm(widths, T):
    """Tops, last hidden state and every gradient (weights, biases, input)
    of a scalar of both, against JAX ``run_lstm`` on its scan path (the
    wavefront schedule for two layers)."""
    rng = np.random.default_rng(len(widths) * 10 + T)
    D = 6
    p = jax.tree_util.tree_map(np.asarray, init_lstm_stack(
        jax.random.PRNGKey(T), D, widths))
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    g_tops = rng.standard_normal((B, T, widths[-1])).astype(np.float32)
    g_last = rng.standard_normal((B, widths[-1])).astype(np.float32)

    def jax_loss(p, x):
        tops, last = run_lstm(p, x, None, 1, "never")
        return jnp.sum(tops * g_tops) + jnp.sum(last * g_last), (tops, last)

    (_, (w_tops, w_last)), (w_gp, w_gx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(p, x)
    cells = [(torch.tensor(c["w"], requires_grad=True),
              torch.tensor(c["b"], requires_grad=True)) for c in p["cells"]]
    xt = torch.tensor(x).transpose(0, 1).contiguous().requires_grad_(True)
    tops, last = plain_stack(cells, xt)
    loss = (tops.transpose(0, 1) * torch.from_numpy(g_tops)).sum() \
        + (last * torch.from_numpy(g_last)).sum()
    loss.backward()
    np.testing.assert_allclose(tops.detach().transpose(0, 1).numpy(),
                               np.asarray(w_tops), **TOL)
    np.testing.assert_allclose(last.detach().numpy(), np.asarray(w_last),
                               **TOL)
    np.testing.assert_allclose(xt.grad.transpose(0, 1).numpy(),
                               np.asarray(w_gx), **TOL)
    for (w, b), c in zip(cells, w_gp["cells"]):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(c["w"]), **TOL)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(c["b"]), **TOL)


@pytest.mark.parametrize("dims,T,route", [
    ({}, 5, (True, True, True)),
    ({"z2_hus": (16,)}, 5, (False, True, True)),
    ({"z1_hus": (16, 8)}, 5, (True, False, True)),
    ({"x_hus": (520, 520)}, 5, (True, True, False)),
    ({"x_hus": (512, 512)}, 5, (True, True, True)),
    ({}, 1, (False, False, False)),
], ids=["default", "one-cell z2", "unequal z1", "wide dec", "widest kernel",
        "T1"])
def test_route_is_fixed_by_the_shape(dims, T, route):
    model = FHVAE(T * F, **{**dict(z1_hus=(16, 16), z2_hus=(16, 16),
                                   x_hus=(16, 16), z1_dim=4, z2_dim=4,
                                   num_seqs=NSEQ, feat_dim=F), **dims})
    assert tuple(model.kernel_stacks[n] for n in
                 ("z2_lstm", "z1_lstm", "dec_lstm")) == route
    before = port_fhvae.plain_stack_calls
    with torch.inference_mode():
        model.apply(torch.zeros(2, T, F), torch.zeros(2, dtype=torch.long),
                    torch.ones(2), sample=False)
    assert port_fhvae.plain_stack_calls - before == route.count(False)


def model_pair(dims, T=5):
    kw = {**dict(z1_hus=(16, 16), z2_hus=(16, 16), x_hus=(16, 16),
                 z1_dim=4, z2_dim=4, num_seqs=NSEQ, feat_dim=F), **dims}
    jm = JaxFHVAE(input_size=T * F, use_pallas="never", lstm_pallas="never",
                  lstm_mm_dtype="float32", scan_unroll=1, **kw)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = FHVAE(T * F, lstm_mm_dtype="float32", **kw)
    tm.load_state_dict(ckpt.params_from_jax(params))
    return jm, params, tm


def batch(T, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, F)).astype(np.float32),
            rng.integers(0, NSEQ, B).astype(np.int32),
            rng.integers(1, 9, B).astype(np.float32))


@pytest.mark.parametrize("name", list(STACKS) + ["T1"])
def test_model_forward_and_gradients_match_jax(name):
    """``FHVAE.apply`` of a model with such stacks (with the JAX noise), its
    outputs, ``encode_z2`` and the gradient of the training loss of every
    parameter, against the JAX model."""
    T = 1 if name == "T1" else 5
    jm, params, tm = model_pair(STACKS.get(name, {}), T)
    x, seq, nsegs = batch(T)
    weight = np.ones(B, np.float32)
    key = jax.random.PRNGKey(3)
    k_enc, _ = jax.random.split(key)
    k2, k1 = jax.random.split(k_enc)
    noise = {"z2": torch.tensor(np.asarray(jax.random.normal(k2, (B, 4)))),
             "z1": torch.tensor(np.asarray(jax.random.normal(k1, (B, 4))))}

    from pytorch_scalablefhvae_tpu.models.base import (
        loss_from_outputs as jax_loss_from_outputs,
    )

    def jax_loss(p):
        out = jm.apply(p, jnp.asarray(x), jnp.asarray(seq),
                       jnp.asarray(nsegs), key, sample=True)
        return jax_loss_from_outputs(out, jnp.asarray(weight), 10.0)[0], out

    (want_loss, want), want_g = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(params)
    out = tm.apply(torch.from_numpy(x), torch.from_numpy(seq),
                   torch.from_numpy(nsegs), sample=True, noise=noise)
    loss, _ = loss_from_outputs(out, torch.from_numpy(weight), 10.0)
    named = dict(tm.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    for f in want._fields:
        np.testing.assert_allclose(getattr(out, f).detach().numpy(),
                                   np.asarray(getattr(want, f)), err_msg=f,
                                   **TOL)
    flat = ckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, want_g))
    assert set(flat) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), flat[n].numpy(), err_msg=n,
                                   rtol=1e-5, atol=1e-5)
    with torch.inference_mode():
        z2 = tm.encode_z2(torch.from_numpy(x))
    np.testing.assert_allclose(z2.numpy(), np.asarray(
        jm.encode_z2(params, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("widths", [(8,), (8, 8), (8, 8, 8), (12, 8)])
def test_params_cross_over_for_every_stack(widths):
    """``params_from_jax`` / ``params_to_jax`` carry 1-, 2- and 3-cell
    stacks, unequal widths included, both ways."""
    jm, params, tm = model_pair(dict(z1_hus=widths, z2_hus=widths,
                                     x_hus=widths))
    back = ckpt.params_to_jax(tm.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    preprocess_data(JaxExperimentConfig(data=JaxDataConfig(
        dataset="synthetic", synthetic_speakers=6, synthetic_utts=4)),
        root=root)
    return root


def configs(corpus, placement="host", **train_kw):
    kw = dict(
        data=dict(dataset="synthetic", mvn_path=str(corpus / "mvn.json"),
                  training_batch_size=32, dev_batch_size=64,
                  data_placement=placement),
        model=dict(model_type="fhvae", z1_hus=(12, 12, 12), z2_hus=(16,),
                   x_hus=(12, 8), z1_dim=4, z2_dim=4, use_pallas="never",
                   lstm_pallas="never", lstm_mm_dtype="float32",
                   scan_unroll=1),
        train=dict(epochs=1, **train_kw))
    return (ExperimentConfig(data=DataConfig(**kw["data"]),
                             model=ModelConfig(**kw["model"]),
                             train=TrainConfig(**kw["train"])),
            JaxExperimentConfig(data=JaxDataConfig(**kw["data"]),
                                model=JaxModelConfig(**kw["model"]),
                                train=JaxTrainConfig(**kw["train"])))


def metrics(d):
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def jax_run(corpus, tmp_path_factory):
    """One JAX epoch of the mixed stacks from the host loader, and its
    initial parameters and noise key (seed 0)."""
    root = tmp_path_factory.mktemp("jax")
    cfg, jcfg = configs(corpus)
    res = jax_train_from_config(jcfg, corpus, root, is_preprocessed=True,
                                verbose=False)
    ds = build_loaders(cfg, corpus, True)[0].dataset
    jm = jax_build("fhvae", ds.seg_len * ds.store.dim, jcfg.model,
                   ds.num_seqs, feat_dim=ds.store.dim)
    k_init, k_state = jax.random.split(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jm.init(k_init))
    return jcfg.exp_dir(root), res, params, k_state


def test_epoch_matches_jax_on_the_device_tier(corpus, tmp_path, monkeypatch,
                                              jax_run):
    """One epoch of the mixed stacks (z1 three cells, z2 one, the decoder
    12 then 8) on the port's device tier (the dev MAP pass through #8's
    plain version, then the plain stacks) against the JAX epoch."""
    exp, res, params, k_state = jax_run
    real_build = loop.build_model

    def build_from_jax(*args, **kw):
        model = real_build(*args, **kw)
        model.load_state_dict(ckpt.params_from_jax(params))
        return model

    def jax_noise(st, rows, device, mesh):
        k_enc, _ = jax.random.split(jax.random.fold_in(k_state, st.step))
        k2, k1 = jax.random.split(k_enc)
        return {k: torch.tensor(np.asarray(jax.random.normal(
            kk, (rows, 4), jnp.float32))) for k, kk in (("z2", k2),
                                                        ("z1", k1))}

    monkeypatch.setattr(loop, "build_model", build_from_jax)
    monkeypatch.setattr(step, "step_noise", jax_noise)
    cfg, _ = configs(corpus, "auto")
    train_loader, dev_loader = build_loaders(cfg, corpus, True)
    before = port_fhvae.plain_stack_calls
    got = loop.run_training(cfg, train_loader, dev_loader, tmp_path,
                            device="cpu", verbose=False)
    assert port_fhvae.plain_stack_calls > before
    assert got.state.step == int(res.state.step)
    (g,), (w,) = metrics(tmp_path), metrics(exp)
    for k in ("train_loss", "val_loss", "val_lower_bound", "val_log_qy",
              "val_log_px_z", "val_neg_kld_z1", "val_neg_kld_z2"):
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    names = ckpt.jax_leaf_names(dict(got.state.model.named_parameters()))
    want = dict(zip(names, jax.tree_util.tree_leaves(res.state.params)))
    for n, p in got.state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def cli_args(corpus, exp_root, *extra):
    return ["train", "--dataset", "synthetic", "--preprocessed",
            "--data-root", str(corpus), "--mvn-path", str(corpus / "mvn.json"),
            "--training-batch-size", "32", "--dev-batch-size", "64",
            "--exp-root", str(exp_root), "--device", "cpu", *MIXED, *extra]


def test_k3_equals_k1_eval_and_encode(corpus, tmp_path):
    """The K-step bundle (eager on the CPU, through its static buffers)
    takes the same route: K = 3 equals K = 1 bit for bit; ``eval`` and
    ``encode`` of the run work."""
    runs = {}
    for k in (1, 3):
        assert main(cli_args(corpus, tmp_path / f"k{k}", "--epochs", "2",
                             "--steps-per-dispatch", str(k))) == 0
        runs[k] = tmp_path / f"k{k}" / RUN / "fhvae_e2_p10_a10.0"
    with np.load(runs[1] / f"{STEM}_e1.npz") as a, \
            np.load(runs[3] / f"{STEM}_e1.npz") as b:
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    exp = runs[1]
    assert main(["eval", str(exp), "--set-name", "dev", "--data-root",
                 str(corpus), "--device", "cpu"]) == 0
    got = json.loads((exp / "eval" / "dev" / "metrics.json").read_text())
    assert np.isfinite(got["lower_bound"])
    assert main(["encode", str(exp), str(corpus / RUN / "wav"),
                 "--output-dir", str(tmp_path / "enc"), "--device", "cpu",
                 "--batch-size", "64"]) == 0
    with np.load(tmp_path / "enc" / "latents.npz") as z:
        assert z["mu2_map"].shape[1] == 4
        assert np.isfinite(z["mu2_map"]).all()


def test_jax_checkpoint_of_three_cell_stacks_resumes(corpus, tmp_path,
                                                     jax_run):
    """The JAX epoch's ``.npz`` (z1 three cells, z2 one, decoder 12 / 8)
    resumes in the port's CLI for one more epoch."""
    exp, res, _, _ = jax_run
    run = tmp_path / "run"
    shutil.copytree(exp, run)
    assert main(["train", "--continue-from", str(run / f"{STEM}_e0.npz"),
                 "--resume-override", "epochs=2", "--data-root", str(corpus),
                 "--preprocessed", "--device", "cpu"]) == 0
    meta = ckpt.read_checkpoint_meta(run / f"{STEM}_e1.npz")
    assert meta["step"] == 2 * int(res.state.step)
    assert meta["model_params"][1:4] == [[12, 12, 12], [16], 4]
    rec = metrics(run)[-1]
    assert rec["epoch"] == 1 and np.isfinite(rec["train_loss"])
