"""PyTorch + CUDA port of ``semireward_tpu``.

The JAX package stays the reference; this package computes the same
training step with PyTorch on one NVIDIA H100, through hand-written Hopper
kernels where the JAX package had Pallas TPU kernels (``ops/``). It imports
neither JAX nor the JAX package. Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA card, and raises without one; the CPU
    is used only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: semireward_tpu_torch runs on the GPU; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
