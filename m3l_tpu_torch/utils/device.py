"""Device resolution for the port's entry points (the card by default, never a silent CPU), and
the numerics an f32 configuration trains with on the card."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a usable card raises; it does not fall
    back to the CPU. Tests and reference runs pass ``device="cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' explicitly to run on the CPU")
    return dev


def f32_numerics(compute_dtype) -> None:
    """For an f32 configuration (``"float32"`` or ``torch.float32``), turn TF32 off in cuDNN's
    convolutions and in cuBLAS's matrix products, so the card computes in the f32 that the tests
    hold against the JAX package (PyTorch's default runs cuDNN convolutions in TF32). A bf16
    configuration leaves both flags as they are. The flags are process-wide."""
    if compute_dtype in ("float32", torch.float32):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
