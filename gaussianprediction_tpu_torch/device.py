"""Device resolution shared by the port's entry points.

`device=None` means CUDA. Asking for CUDA on a machine without it raises;
the CPU is used only when the caller asks for it (the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        # the JAX reference's MLP and projection run in full f32: keep
        # matmuls and convolutions out of TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
