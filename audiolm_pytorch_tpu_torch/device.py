"""Device choice for the port's entry points: the card unless the caller asks
for the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """Return `device` as a torch.device; raise if it names CUDA and no card is
    present (the port never moves to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return device
