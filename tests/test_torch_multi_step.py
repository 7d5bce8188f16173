"""The port's K-step bundle (``--steps-per-dispatch``) on the CPU.

On the CPU the bundle (``train/graphs.py``) runs its body eagerly through
the same static buffers the card's CUDA graph reads; ``tests/test_torch_gpu.py``
holds the graph replay to that body on the card.

- Against the JAX package, same weights and zero Adam state: the bundle from
  the host loader's stacked batches against ``make_multi_train_step``, and
  the bundle over the staged store against ``make_device_train_step(k=3)``,
  each step's noise drawn from JAX's key schedule and handed to the port.
  Limits as ``tests/test_torch_train_step.py`` holds single steps: losses
  1e-5 relative (fp32 sum order); Adam's moments 1e-4 of each tensor's
  largest value; parameters 2e-4 absolute with at most 0.5% of the elements
  over 1e-5 (Adam moves each element by ~lr whatever its gradient).
- Against the port's own eager steps: K = 3 equals three K = 1 steps bit for
  bit on both tiers, and so does ``train --steps-per-dispatch 3`` through
  the CLI on an epoch whose batch count leaves a tail of eager steps; a
  resumed K = 3 run equals an uninterrupted one, and divergence exits 2.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.config import DataConfig, ExperimentConfig
from pytorch_scalablefhvae_tpu.data.device_store import (
    DeviceDataSource as JaxDeviceDataSource,
)
from pytorch_scalablefhvae_tpu.data.feature_store import FeatureStore
from pytorch_scalablefhvae_tpu.data.segments import SegmentDataset
from pytorch_scalablefhvae_tpu.features.pipeline import preprocess_data
from pytorch_scalablefhvae_tpu.models.fhvae import FHVAE as JaxFHVAE
from pytorch_scalablefhvae_tpu.train import device_step as jax_device_step
from pytorch_scalablefhvae_tpu.train import step as jax_step
from pytorch_scalablefhvae_tpu_torch.cli.main import main
from pytorch_scalablefhvae_tpu_torch.data.device_store import DeviceDataSource
from pytorch_scalablefhvae_tpu_torch.data.loader import Batch, SegmentLoader
from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
from pytorch_scalablefhvae_tpu_torch.train import device_step, step
from pytorch_scalablefhvae_tpu_torch.train.checkpoint import (
    jax_leaf_names,
    params_from_jax,
    train_state_from_jax,
)
from pytorch_scalablefhvae_tpu_torch.train.graphs import (
    HostInputs,
    StepBundle,
)

K, ALPHA = 3, 10.0
CPU = torch.device("cpu")
B, T, F, NSEQ = 6, 5, 8, 5
DIMS = dict(z1_hus=(16, 16), z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4,
            z2_dim=4, feat_dim=F)


def batch(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((B, T, F))).astype(np.float32)
    seq = rng.integers(0, NSEQ, B).astype(np.int32)
    nsegs = rng.integers(1, 9, B).astype(np.float32)
    weight = np.array([1, 1, 1, 1, 1, 0], np.float32)
    return Batch(x, seq, nsegs, weight, n_real=5)


def jax_noise(rng, step_no, model, rows):
    """The noise ``FHVAE.apply`` draws inside JAX's step number ``step_no``."""
    k_enc, _ = jax.random.split(jax.random.fold_in(rng, step_no))
    k2, k1 = jax.random.split(k_enc)
    return {"z2": torch.tensor(np.asarray(jax.random.normal(
                k2, (rows, model.z2_dim), jnp.float32))),
            "z1": torch.tensor(np.asarray(jax.random.normal(
                k1, (rows, model.z1_dim), jnp.float32)))}


def jax_and_port(num_seqs, seg_len):
    """A JAX train state and the port's state and optimizer at its weights."""
    jm = JaxFHVAE(input_size=seg_len * F, use_pallas="never",
                  lstm_pallas="never", lstm_mm_dtype="float32",
                  num_seqs=num_seqs, **DIMS)
    opt = jax_step.make_optimizer(1e-3, 0.95, 0.999)
    jstate = jax_step.create_train_state(jm, opt, seed=0)
    tm = FHVAE(seg_len * F, lstm_mm_dtype="float32", num_seqs=num_seqs,
               **DIMS)
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate.params)))
    return jm, opt, jstate, step.create_train_state(tm, seed=0), \
        step.make_optimizer(1e-3, 0.95, 0.999)


def assert_state_matches_jax(jstate, tstate, steps):
    names = jax_leaf_names(dict(tstate.model.named_parameters()))
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)]
    want = train_state_from_jax(leaves, names)
    assert want["step"] == want["count"] == steps
    assert tstate.step == tstate.count == steps
    got = dict(tstate.model.named_parameters())
    for n in names:
        diff = np.abs(got[n].detach().numpy() - want["params"][n])
        assert diff.max() <= 2e-4, (n, diff.max())
        assert (diff > 1e-5).mean() <= 0.005, (n, (diff > 1e-5).sum())
        for key in ("mu", "nu"):
            ref = want[key][n]
            err = np.abs(getattr(tstate, key)[n].numpy() - ref).max()
            assert err <= 1e-4 * max(np.abs(ref).max(), 1e-30), (n, key)


def test_bundle_matches_jax_multi_train_step():
    """Two dispatches of K = 3 from stacked host batches; the first batch
    is scaled so that its gradient norm passes the clip at 100."""
    jm, opt, jstate, tstate, topt = jax_and_port(NSEQ, T)
    jfn = jax_step.make_multi_train_step(jm, opt, ALPHA, donate=False)
    inputs = HostInputs(K, B, T, F, CPU)
    bundle = StepBundle(tstate, topt, ALPHA, K, inputs, CPU)
    for d in range(2):
        group = [batch(d * K + i, scale=30.0 if d == i == 0 else 1.0)
                 for i in range(K)]
        noise = [jax_noise(jstate.rng, int(jstate.step) + i, jm, B)
                 for i in range(K)]
        stacked = [jnp.asarray(np.stack([getattr(b, f) for b in group]))
                   for f in ("feats", "seq_idx", "nsegs", "weight")]
        jstate, jm_metrics = jfn(jstate, *stacked)
        inputs.load(group)
        got = bundle(noise=noise)["loss"]
        want = np.asarray(jm_metrics["loss"])
        assert got.shape == want.shape == (K,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert_state_matches_jax(jstate, tstate, 2 * K)


@pytest.fixture(scope="module")
def staged():
    """A seeded store of five sequences (48 windows of 10 frames at shift
    4), and a batch of 10: five batches, the last one padded."""
    rng = np.random.default_rng(0)
    store = FeatureStore.from_arrays({
        f"s{i}": rng.standard_normal((n, F)).astype(np.float32)
        for i, n in enumerate((61, 47, 33, 75, 14))})
    return store, SegmentDataset(store, seg_len=10, seg_shift=4), 10


def test_device_bundle_matches_jax_device_train_step(staged):
    store, ds, bs = staged
    jm, opt, jstate, tstate, topt = jax_and_port(ds.num_seqs, ds.seg_len)
    jfn = jax_device_step.make_device_train_step(jm, opt, ALPHA, ds.seg_len,
                                                 bs, k=K, donate=False)
    order = SegmentLoader(ds, bs, shuffle=True, seed=0)._order()
    jsrc = JaxDeviceDataSource(store)
    plan, jarrays = jsrc.stage_epoch(ds, order, bs)
    src = DeviceDataSource(store, CPU)
    _, arrays = src.stage_epoch(ds, order, bs)
    assert plan.n_real % bs and plan.n_batches == 5
    inputs = device_step.PlanInputs(src.data, bs, ds.seg_len)
    inputs.load_plan(arrays, plan.n_real)
    bundle = StepBundle(tstate, topt, ALPHA, K, inputs, CPU)
    for base_b in (0, 2):  # the second dispatch ends on the padded batch
        noise = [jax_noise(jstate.rng, int(jstate.step) + i, jm, bs)
                 for i in range(K)]
        jstate, jm_metrics = jfn(jstate, jsrc.data, *jarrays,
                                 np.int32(base_b * bs), np.int32(plan.n_real))
        inputs.set_base(base_b * bs)
        got = bundle(noise=noise)["loss"]
        np.testing.assert_allclose(got.numpy(), np.asarray(jm_metrics["loss"]),
                                   rtol=1e-5)
    assert_state_matches_jax(jstate, tstate, 2 * K)


def assert_states_equal(a, b):
    assert a.step == b.step and a.count == b.count
    pa, pb = a.params(), b.params()
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
        assert torch.equal(a.mu[n], b.mu[n]), n
        assert torch.equal(a.nu[n], b.nu[n]), n


@pytest.mark.parametrize("tier", ["host", "device"])
def test_bundle_equals_single_steps_bitwise(staged, tier):
    """Two K = 3 dispatches against six eager steps from one start, the
    noise drawn by each from (seed, step): the same bits."""
    store, ds, bs = staged
    model = FHVAE(ds.seg_len * F, lstm_mm_dtype="float32",
                  num_seqs=ds.num_seqs, generator=torch.Generator()
                  .manual_seed(1), **DIMS)
    loader = SegmentLoader(ds, bs, shuffle=True, seed=0, prefetch=0)
    src = DeviceDataSource(store, CPU)
    _, arrays = src.stage_epoch(ds, loader._order(), bs)
    batches = list(loader)
    states = [step.create_train_state(FHVAE(
        ds.seg_len * F, lstm_mm_dtype="float32", num_seqs=ds.num_seqs,
        **DIMS), seed=5) for _ in range(2)]
    for s in states:
        s.model.load_state_dict(model.state_dict())
    opt = step.make_optimizer(1e-3, 0.95, 0.999)
    single = []
    for b in (0, 1, 2, 2, 3, 4):
        if tier == "host":
            m = step.train_step(states[0], opt, *(torch.from_numpy(a) for a in (
                batches[b].feats, batches[b].seq_idx, batches[b].nsegs,
                batches[b].weight)), ALPHA)
        else:
            m = device_step.device_train_step(
                states[0], opt, src.data, arrays, b * bs, len(ds), ALPHA,
                batch_size=bs, seg_len=ds.seg_len)
        single.append(float(m["loss"]))
    if tier == "host":
        inputs = HostInputs(K, bs, ds.seg_len, F, CPU)
    else:
        inputs = device_step.PlanInputs(src.data, bs, ds.seg_len)
        inputs.load_plan(arrays, len(ds))
    bundle = StepBundle(states[1], opt, ALPHA, K, inputs, CPU)
    bundled = []
    for first in (0, 2):
        if tier == "host":
            inputs.load([batches[first + i] for i in range(K)])
        else:
            inputs.set_base(first * bs)
        bundled += bundle()["loss"].tolist()
    assert bundled == single
    assert_states_equal(states[0], states[1])


# ----------------------------------------------------- the CLI, both tiers

WIDTHS = ["--z1-hus", "16", "16", "--z2-hus", "16", "16", "--x-hus", "16",
          "16", "--z1-dim", "4", "--z2-dim", "4"]
RUN = "synthetic_np_fbank"
TRAIN_BATCH = 16  # 66 training segments: 5 batches, a bundle and 2 eager


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    cfg = ExperimentConfig(data=DataConfig(dataset="synthetic",
                                           synthetic_speakers=6,
                                           synthetic_utts=4))
    preprocess_data(cfg, root=root)
    return root


def train(corpus, exp_root, placement, *extra):
    return main(["train", "--dataset", "synthetic", "--preprocessed",
                 "--data-root", str(corpus), "--mvn-path",
                 str(corpus / "mvn.json"), "--training-batch-size",
                 str(TRAIN_BATCH), "--dev-batch-size", "64", "--exp-root",
                 str(exp_root), "--device", "cpu", "--data-placement",
                 placement, *WIDTHS, *extra])


def run_dir(exp_root, epochs):
    return exp_root / RUN / f"fhvae_e{epochs}_p10_a10.0"


def records(d):
    return [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]


def assert_checkpoints_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert set(x.files) == set(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("placement", ["host", "device"])
def test_cli_steps_per_dispatch_equals_single_steps(corpus, tmp_path,
                                                    placement, capsys):
    for k in ("1", "3"):
        assert train(corpus, tmp_path / k, placement, "--epochs", "2",
                     "--steps-per-dispatch", k) == 0
    out = capsys.readouterr().out
    assert "3 steps per dispatch" in out
    assert ("device-resident" in out) == (placement == "device")
    one, three = (records(run_dir(tmp_path / k, 2)) for k in ("1", "3"))
    steps = one[0]["train_steps"]
    assert steps % K and steps > K  # bundles and a tail of eager steps
    for a, b in zip(one, three):
        for key in ("train_loss", "train_steps", "step", "val_loss",
                    "val_lower_bound", "val_log_qy"):
            assert a[key] == b[key], (key, a[key], b[key])
    for e in (0, 1):
        assert_checkpoints_equal(
            run_dir(tmp_path / "1", 2) / f"fhvae_{RUN}_e{e}.npz",
            run_dir(tmp_path / "3", 2) / f"fhvae_{RUN}_e{e}.npz")


def test_resume_at_three_steps_per_dispatch_equals_uninterrupted(corpus,
                                                                tmp_path):
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    k3 = ("--steps-per-dispatch", "3")
    assert train(corpus, whole, "device", "--epochs", "2", *k3) == 0
    assert train(corpus, parts, "device", "--epochs", "1", *k3) == 0
    first = run_dir(parts, 1) / f"fhvae_{RUN}_e0.npz"
    assert train(corpus, parts, "device", "--continue-from", str(first),
                 "--resume-override", "epochs=2") == 0
    assert_checkpoints_equal(run_dir(parts, 1) / f"fhvae_{RUN}_e1.npz",
                             run_dir(whole, 2) / f"fhvae_{RUN}_e1.npz")
    assert records(run_dir(parts, 1))[-1]["train_loss"] == \
        records(run_dir(whole, 2))[-1]["train_loss"]


@pytest.mark.parametrize("placement", ["host", "device"])
def test_divergence_at_three_steps_per_dispatch_exits_2(corpus, tmp_path,
                                                        placement, capsys):
    assert train(corpus, tmp_path, placement, "--epochs", "2",
                 "--steps-per-dispatch", "3", "--learning-rate",
                 "1e18") == 2
    assert "Training diverged" in capsys.readouterr().out


def test_bias_corrections_divide_as_the_host_floats_did():
    """The bias corrections travel as fp32 operands on the device; applying
    them (``step.unbias``) gives the bits that ``_foreach_div`` by the
    host's float gave. On the CPU the operand is the float's fp32 rounding
    (``tests/test_torch_gpu.py`` holds CUDA's reciprocal form)."""
    opt = step.make_optimizer(1e-3, 0.95, 0.999)
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.random(257).astype(np.float32) * 1e-3)
          for _ in range(3)]
    for c in (0, 1, 6, 999, 123_456):
        bc = opt.bias_corrections(c, 2)
        assert bc.dtype == np.float32 and bc.shape == (2, 2)
        one = np.float32(1.0)
        for j, b in enumerate((0.95, 0.999)):
            host = float(one - np.float32(b) ** np.int32(c + 1))
            assert bc[0, j] == np.float32(host)
            got = step.unbias(xs, torch.from_numpy(bc)[0, j])
            want = torch._foreach_div(xs, host)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
