"""Kernels #1-#4: the two-layer LSTM recurrence, forward and backward
(``ops/lstm_cuda.py`` -> ``csrc/lstm2_*.cu``).

Operations from shapes (T steps, B rows, input width D, hidden H; D = 0
where the input projection is done outside the kernel):
- forward: ``2 T B 4H (D + 3H)``: the input projection and the three
  ``[B, H] x [H, 4H]`` products of a step (layer 1's recurrent, layer 2's
  input and recurrent);
- backward: the forward's products again (the gates are recomputed), the
  products that carry the gradient back (``2 T B 4H 3H``, plus ``2 T B 4H
  D`` where the input's gradient is asked for) and the weight gradients
  (``2 T B 4H (D + 3H)``).
Bytes: every tensor the launcher is handed or returns, once. The peak is
bf16's on the tensor cores for bf16 operands, fp32's otherwise.
"""

from roofline import PEAKS, tensor_bytes  # noqa: F401  (PEAKS: the probe's)

MODULE = "pytorch_scalablefhvae_tpu_torch.ops.lstm_cuda"
LAUNCHERS = {"_forward_tc": "forward", "_forward_fma": "forward",
             "_backward_tc": "backward", "_backward_fma": "backward"}
ENTRIES = ("lstm2_tm_proj", "lstm2_tm", "lstm2_tm_proj_bwd", "lstm2_tm_bwd")
KERNELS = ("lstm2_fwd_xproj_kernel", "lstm2_fwd_chain_kernel",
           "lstm2_fwd_fma_kernel", "lstm2_bwd_gates_kernel",
           "lstm2_bwd_chain_kernel", "lstm2_bwd_wgrad_kernel",
           "lstm2_bwd_combine_kernel", "lstm2_bwd_colsum_kernel",
           "lstm2_bwd_dx_kernel", "lstm2_bwd_recurrent_kernel",
           "tn_partial_kernel", "combine_kernel", "sum_t_kernel",
           "colsum_kernel", "nt_kernel")
# the kernel each call of these entries launches exactly once (in the
# tensor-core forms): the profiler's count must equal the entries' launches
CHECKED = {"lstm2_fwd_xproj_kernel": ("lstm2_tm_proj",),
           "lstm2_fwd_chain_kernel": ("lstm2_tm_proj", "lstm2_tm"),
           "lstm2_bwd_chain_kernel": ("lstm2_tm_proj_bwd", "lstm2_tm_bwd")}


def forward_ops(T: int, B: int, D: int, H: int) -> float:
    return 2.0 * T * B * 4 * H * (D + 3 * H)


def backward_ops(T: int, B: int, D: int, H: int, need_dx: bool) -> float:
    return (forward_ops(T, B, D, H) + 2.0 * T * B * 4 * H
            * (3 * H + (D if need_dx else 0)) + forward_ops(T, B, D, H))


def cost(kind: str, a: dict, result) -> dict:
    """``{"entry", "ops", "bytes", "peak"}`` of one launcher call, from its
    bound arguments ``a`` and what it returned."""
    x, H, T = a["x"], a["w1h"].shape[0], int(a["T"])
    D = 0 if x is None else x.shape[-1]
    weights = [a[k] for k in ("w1x", "w1h", "w2x", "w2h", "b2")]
    if kind == "forward":
        B = result[1].shape[0]
        ops = forward_ops(T, B, D, H)
        nbytes = tensor_bytes(x, a["xadd"], weights, result)
    else:
        B = int(a["B"])
        ops = backward_ops(T, B, D, H, bool(a["need_dx"]))
        nbytes = tensor_bytes(x, a["xadd"], a["resid"], a["tops"], weights,
                              a["g_tops"], a["g_h2"], result)
    return {"entry": a["entry"].__name__, "ops": ops, "bytes": nbytes,
            "peak": "bf16_dense" if a["mm_dtype"] == "bfloat16" else "fp32"}
