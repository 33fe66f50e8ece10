"""Device selection: ``cuda`` by default, the CPU only when asked for."""
from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """Return the device called ``name``; raise if it is CUDA and absent.

    There is no fallback: a caller that asks for the card and has none
    gets an error, never a silent run on the CPU.
    """
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return device
