"""Device resolution for the port's entry points.

Every entry point runs on the CUDA card unless its caller asks for the
host with ``device="cpu"``; there is no silent fallback to the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when a CUDA device is asked for
    (explicitly or by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    return dev
