"""Device resolution: the one place the port picks where tensors live."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """``"cuda"`` (the default everywhere) or ``"cpu"``.

    There is no silent fallback: ``"cuda"`` raises when no CUDA device is
    present, and the CPU, where every kernel wrapper runs its plain PyTorch
    version, is reached only by asking for ``"cpu"``.

    Float32 matrix products and convolutions run in full fp32: TF32 keeps
    only about three decimal digits, and the LSTM kernels' fp32 mode and the
    plain versions they are checked against must agree to ~1e-6. cuDNN
    enables TF32 for convolutions by default, so both switches are set here.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was requested but torch.cuda.is_available() "
                "is false; pass --device cpu to run the plain PyTorch "
                "versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (expected cuda or cpu)")
    return dev
