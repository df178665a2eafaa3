"""Device resolution for every entry point of the port.

Entry points take `device=` and default to `"cuda"`; tests pass
`device="cpu"`. Asking for CUDA where there is none raises: the port never
drops to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a `torch.device`. For CUDA it also turns TF32 off for
    float32 convolutions and matmuls, so the float32 path computes in
    float32 as the reference does (cuDNN convolutions default to TF32);
    bf16 work under autocast is not affected."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev
