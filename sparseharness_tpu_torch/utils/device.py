"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for another device.
With no GPU and no explicit request they raise: they never fall back to
the CPU on their own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device``, or ``cuda`` when it is None; raises if that has no card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, else the device type."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
