"""The plain reference against the program's plain CPU path at small
widths, from the same weights, batch and noise: the forward's per-segment
terms, the loss's gradients and the MAP table."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_small import SMALL
from fhbench import weights
from reference import common, model_for


def program_model(model_type: str, num_seqs: int, lstm_mm_dtype: str):
    from pytorch_scalablefhvae_tpu_torch.config import ModelConfig
    from pytorch_scalablefhvae_tpu_torch.models.base import build_model

    cfg = ModelConfig(model_type=model_type, z1_hus=(16, 16),
                      z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4, z2_dim=4,
                      lstm_mm_dtype=lstm_mm_dtype)
    return build_model(model_type, SMALL["seg_len"] * SMALL["feat_dim"], cfg,
                       num_seqs, feat_dim=SMALL["feat_dim"])


@pytest.mark.parametrize("model_type,lstm", [("fhvae", "float32"),
                                             ("fhvae", "bfloat16"),
                                             ("simple_fhvae", "float32")])
def test_reference_matches_program(model_type, lstm):
    ref = model_for(model_type, {**SMALL, "pz2_std": 0.5})
    params = weights.make(ref, 12, 1.0, 5, torch.device("cpu"))
    prog = program_model(model_type, 12, lstm)
    prog.load_state_dict(params)
    g = torch.Generator().manual_seed(3)
    B = 24
    x = torch.randn((B, SMALL["seg_len"], SMALL["feat_dim"]), generator=g)
    seq = torch.randint(0, 12, (B,), generator=g)
    nsegs = torch.randint(5, 30, (B,), generator=g).float()
    noise = common.step_noise(7, 0, B, 4, 4, "cpu")
    prec = {"lstm": "bf16"} if lstm == "bfloat16" else None
    # bf16 operands: the program projects z2 and the decoder's input once
    # a segment in fp32 and rounds only the recurrence's operands, the
    # reference every LSTM product's
    tol = 1e-2 if lstm == "bfloat16" else 2e-5

    out_p = prog.apply(x, seq.int(), nsegs, sample=True, noise=noise)
    leaves = {n: p.clone().requires_grad_(True) for n, p in params.items()}
    out_r = ref.forward(leaves, x, seq, nsegs, None, noise, prec)
    for key in ("lower_bound", "log_qy", "log_px_z", "neg_kld_z1",
                "neg_kld_z2", "log_pmu2"):
        torch.testing.assert_close(out_r[key], getattr(out_p, key),
                                   rtol=tol, atol=tol)

    weight = torch.ones(B)
    loss_r = common.training_loss(out_r, weight, 10.0)
    loss_p = -((out_p.lower_bound + 10.0 * out_p.log_qy) * weight).sum() / B
    grads_p = torch.autograd.grad(loss_p, list(prog.parameters()))
    names = [n for n, _ in prog.named_parameters()]
    grads_r = torch.autograd.grad(loss_r, [leaves[n] for n in names])
    for n, gp, gr in zip(names, grads_p, grads_r):
        scale = max(float(gr.norm()), 1e-3)
        assert float((gp - gr).norm()) / scale < 10 * tol, n


def test_map_table_matches_program():
    from pytorch_scalablefhvae_tpu_torch.data.feature_store import (
        FeatureStore,
    )
    from pytorch_scalablefhvae_tpu_torch.data.loader import SegmentLoader
    from pytorch_scalablefhvae_tpu_torch.data.segments import SegmentDataset
    from pytorch_scalablefhvae_tpu_torch.train.loop import (
        estimate_split_mu2,
    )

    ref = model_for("fhvae", {**SMALL, "pz2_std": 0.5})
    params = weights.make(ref, 6, 1.0, 1, torch.device("cpu"))
    prog = program_model("fhvae", 6, "float32")
    prog.load_state_dict(params)
    rng = np.random.default_rng(0)
    lens = rng.integers(30, 80, 6)
    frames = rng.standard_normal((int(lens.sum()), 8)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    store = FeatureStore.from_arrays(
        {f"s{i}": frames[o:o + n] for i, (o, n) in
         enumerate(zip(offsets, lens))})
    loader = SegmentLoader(SegmentDataset(store, 20, 8), 16, shuffle=False)
    want = estimate_split_mu2(prog, loader, 6, 0.25, torch.device("cpu"))
    split = common.Split(frames, offsets, lens, 20, 8)
    got = common.map_table(lambda x: ref.encode_z2(params, x), split, None,
                           6, 0.25, "cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_round_draw_and_batches_follow_the_program():
    from pytorch_scalablefhvae_tpu_torch.data.segments import make_segments
    from pytorch_scalablefhvae_tpu_torch.train.rounds import round_keys

    keys = [f"train_{i:05d}" for i in range(50)]
    assert common.round_draw(keys, 20, 2**31 + 5, 3) == \
        round_keys(keys, 20, 2**31 + 5, 3)
    lens = np.random.default_rng(1).integers(10, 60, 40)
    seq, start, nsegs = common.segment_index(lens, 20, 8)
    want = make_segments(lens, 20, 8)
    np.testing.assert_array_equal(seq, want[0])
    np.testing.assert_array_equal(start, want[1])
    np.testing.assert_array_equal(nsegs, want[2])
