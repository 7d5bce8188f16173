"""Kernel #8: the windowed chunk gather of the chunked MAP pass
(``ops/window_gather.py`` -> ``csrc/window_gather.cu``): no arithmetic, so
its bound is by bytes: each chunk's region of ``(spb - 1) stride + seg_len``
rows read once, its ``spb`` windows of ``seg_len`` rows written once.

No metric reads its roofline yet; the profiler's count of its kernel is
held to its launch counter in the traced cycle."""

MODULE = "pytorch_scalablefhvae_tpu_torch.ops.window_gather"
LAUNCHERS = {}
ENTRIES = ("windowed_chunk_gather",)
KERNELS = ("window_gather_kernel",)
CHECKED = {"window_gather_kernel": ("windowed_chunk_gather",)}


def gather_bytes(chunks: int, spb: int, seg_len: int, stride: int,
                 dim: int, itemsize: int) -> int:
    region = (spb - 1) * stride + seg_len
    return chunks * (region + spb * seg_len) * dim * itemsize
