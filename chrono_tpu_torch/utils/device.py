"""The device an entry point builds on: the CUDA card unless the caller
names another.  Without a card the default raises; nothing falls back to
the CPU by itself."""

from __future__ import annotations

import torch


def resolve_device(device, what: str) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} builds on the CUDA card by default and none is "
            "available; pass device='cpu' to build on the CPU")
    return device
