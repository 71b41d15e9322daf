"""Where the port's entry points and constructors put their tensors."""

from __future__ import annotations

import torch

from tpuserve_torch.utils.errors import BackendError


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller asks for
    the CPU. Raises when a card is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise BackendError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
