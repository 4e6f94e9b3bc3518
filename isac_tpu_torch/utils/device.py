"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for CUDA without a card raises: the
    entry points never carry on silently on the CPU.

    TF32 is switched off for CUDA: the CRC is an f32 matrix product that is
    exact only at full f32 precision (ops/crc.py), and the channel/precoding
    contractions are held to the JAX reference's f32 numerics."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
