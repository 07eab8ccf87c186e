"""Device selection and float32 numerics, shared by every entry point."""

from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Float32 convs and matmuls in full float32 on the card (process-wide
    PyTorch flags; cuDNN's conv forward and backward default to TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without CUDA raises
    rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
