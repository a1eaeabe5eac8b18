"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""
from __future__ import annotations

import torch

#: device of every public entry point when the caller names none
DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device. A CUDA device on a machine without CUDA
    raises here, before any work runs: nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return device
