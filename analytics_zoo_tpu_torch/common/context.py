"""Device choice for the port's entry points.

The JAX package's context (``analytics_zoo_tpu/common/context.py``) builds a
device mesh; this slice runs on one card and needs only the device.  An
entry point runs on ``cuda`` unless its caller names another device; with
no card and no device named it raises rather than run on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


class NoCudaDeviceError(RuntimeError):
    """No CUDA device is visible and the caller named no device."""


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device, and raises ``NoCudaDeviceError`` when there is none."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise NoCudaDeviceError(f"device {dev} asked for, but no CUDA "
                                    "device is visible")
        return dev
    if not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "no CUDA device is visible; the port runs on the card by "
            "default. Pass device='cpu' to run the plain PyTorch versions "
            "on the CPU.")
    return torch.device("cuda", torch.cuda.current_device())
