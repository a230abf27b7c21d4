"""Where the port runs: the GPU unless the caller names another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device to decode on: CUDA unless the caller names another.

    device=None asks for the GPU and raises when there is none; the CPU
    runs only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
