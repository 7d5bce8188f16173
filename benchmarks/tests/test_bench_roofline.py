"""The yardstick's arithmetic: model FLOPs a segment against the worked
values, the kernels' operations against the kernel table's bounds, the
peaks, and the names a profiler gives kernels."""

from __future__ import annotations

import pytest
import torch

from fhbench.trace import bound_seconds, kernel_base, union
from roofline import PEAKS, disc, fhvae, lstm, simple_fhvae, window_gather

WIDTHS = {"z1_hus": [128, 128], "z2_hus": [128, 128], "x_hus": [128, 128],
          "z1_dim": 16, "z2_dim": 16, "feat_dim": 80, "seg_len": 20,
          "seg_shift": 8}


def test_model_flops_worked_values():
    assert fhvae.flops_per_segment(WIDTHS, 4620) == pytest.approx(86.5e6,
                                                                  rel=1e-3)
    assert simple_fhvae.flops_per_segment(WIDTHS, 4620) == pytest.approx(
        5.74e6, rel=1e-3)
    assert fhvae.flops_per_segment(WIDTHS, 4620, train=False) * 3 == \
        fhvae.flops_per_segment(WIDTHS, 4620)


def test_peaks_are_the_h100_sxm_data_sheet():
    assert PEAKS == {"bf16_dense": 989e12, "fp8_dense": 1979e12,
                     "tf32_dense": 495e12, "fp32": 67e12, "hbm": 3.35e12}


def test_lstm_forward_bounds():
    # the kernel table's bounds (B 2048): the z1 form 0.0197 ms, the decoder
    # 0.0163 ms, by operations over 989 TFLOP/s
    assert lstm.forward_ops(20, 2048, 80, 128) / 989e12 * 1e3 == \
        pytest.approx(0.0197, abs=5e-5)
    assert lstm.forward_ops(20, 2048, 0, 128) / 989e12 * 1e3 == \
        pytest.approx(0.0163, abs=5e-5)
    # the backward: the gates again, the gradient's chain, the weights'
    assert lstm.backward_ops(20, 1024, 80, 128, True) == \
        3 * lstm.forward_ops(20, 1024, 80, 128)
    assert lstm.backward_ops(20, 1024, 0, 128, False) / 989e12 * 1e3 == \
        pytest.approx(0.0244, abs=5e-5)


def test_lstm_cost_of_a_call():
    T, B, D, H = 20, 8, 16, 32
    f32 = torch.float32
    a = {"entry": lstm, "x": torch.zeros(T, B, D),
         "xadd": torch.zeros(B, 4 * H),
         "T": T, "w1x": torch.zeros(D, 4 * H), "w1h": torch.zeros(H, 4 * H),
         "w2x": torch.zeros(H, 4 * H), "w2h": torch.zeros(H, 4 * H),
         "b2": torch.zeros(4 * H), "mm_dtype": "bfloat16"}
    out = (torch.zeros(T, B, H, dtype=f32), torch.zeros(B, H), None)
    c = lstm.cost("forward", a, out)
    assert c["ops"] == 2 * T * B * 4 * H * (D + 3 * H)
    assert c["peak"] == "bf16_dense" and c["entry"] == "roofline.lstm"
    assert c["bytes"] == 4 * (T * B * D + B * 4 * H + D * 4 * H
                              + 3 * H * 4 * H + 4 * H + T * B * H + B * H)


def test_disc_and_window_gather():
    a = {"entry": disc, "z2_mu": torch.zeros(1024, 16),
         "mu2_table": torch.zeros(4620, 16),
         "seq_idx": torch.zeros(1024, dtype=torch.int64)}
    c = disc.cost("forward", a, (torch.zeros(1024), torch.zeros(1024)))
    assert c["ops"] == 2 * 1024 * 4620 * 16 and c["peak"] == "fp32"
    assert c["bytes"] == 4 * (1024 * 16 + 4620 * 16) + 8 * 1024 + 8 * 1024
    a.update(lse=torch.zeros(1024), g=torch.zeros(1024))
    assert disc.cost("backward", a, ())["ops"] == 3 * c["ops"]
    # a chunk: 15 strides of 8 and a 20-row window read, 16 windows written
    assert window_gather.gather_bytes(1, 16, 20, 8, 80, 4) == \
        (140 + 320) * 320


def test_kernel_names():
    assert kernel_base("void lstm2_fwd_chain_kernel<128, 2>(float const*)") \
        == "lstm2_fwd_chain_kernel"
    assert kernel_base("void (anonymous namespace)::combine_kernel(float*)") \
        == "combine_kernel"
    assert kernel_base("disc_fwd_kernel") == "disc_fwd_kernel"
    assert union([(3, 4), (0, 2), (1, 3)]) == [[0, 4]]


def test_bound_counts_replays_of_the_captured_graph():
    class Log:
        captured = [{"entry": "e", "ops": 989e12, "bytes": 0,
                     "peak": "bf16_dense"}] * 2
        eager = [{"entry": "e", "ops": 989e12, "bytes": 0,
                  "peak": "bf16_dense"}]

    class Group:
        PEAKS, ENTRIES = PEAKS, ("e",)

    # one eager launch and three replays of a two-launch graph
    assert bound_seconds(Log, {"e": 7}, Group) == pytest.approx(7.0)
    # counters that do not square with the graph give no bound
    assert bound_seconds(Log, {"e": 6}, Group) is None
