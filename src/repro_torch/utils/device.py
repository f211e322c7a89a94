"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another device. There is no silent fallback to the CPU — without
    a card, the default raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def synchronize(device: Union[str, torch.device]) -> None:
    """Wait for the card's queued work (a no-op on the CPU): a host clock
    read after this has timed the device work, not its enqueue."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
