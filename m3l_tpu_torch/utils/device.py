"""Device resolution for the port's entry points: the card by default, never a silent CPU."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a usable card raises; it does not fall
    back to the CPU. Tests and reference runs pass ``device="cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' explicitly to run on the CPU")
    return dev
