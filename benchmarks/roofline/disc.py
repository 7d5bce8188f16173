"""Kernels #5/#6: the discriminative ``log q(y | z2)`` over the mu2 table,
forward and backward (``ops/discriminative.py`` ->
``csrc/discriminative_*.cu``).

Operations from shapes (B rows, N table rows, z2 width Z): the forward's
logits ``2 B N Z``; the backward recomputes them and forms both gradients,
``6 B N Z``. Bytes: every tensor the launcher is handed or returns, once.
The peak is fp32's outside the tensor cores (the kernels multiply in fp32).
"""

from roofline import PEAKS, tensor_bytes  # noqa: F401  (PEAKS: the probe's)

MODULE = "pytorch_scalablefhvae_tpu_torch.ops.discriminative"
LAUNCHERS = {"_forward_partials": "forward", "_backward": "backward"}
ENTRIES = ("discriminative_log_qy", "discriminative_log_qy_bwd",
           "discriminative_log_qy_sharded",
           "discriminative_log_qy_sharded_bwd")
KERNELS = ("disc_fwd_kernel", "disc_combine_kernel", "disc_merge_kernel",
           "disc_bwd_fused_kernel", "disc_bwd_combine_kernel")
CHECKED = {"disc_fwd_kernel": ("discriminative_log_qy",
                               "discriminative_log_qy_sharded"),
           "disc_bwd_fused_kernel": ("discriminative_log_qy_bwd",
                                     "discriminative_log_qy_sharded_bwd")}


def cost(kind: str, a: dict, result) -> dict:
    B, Z = a["z2_mu"].shape
    N = a["mu2_table"].shape[0]
    ins = [a["z2_mu"], a["mu2_table"], a["seq_idx"]]
    if kind == "backward":
        ins += [a["lse"], a["g"]]
    return {"entry": a["entry"].__name__,
            "ops": (2.0 if kind == "forward" else 6.0) * B * N * Z,
            "bytes": tensor_bytes(ins, result), "peak": "fp32"}
