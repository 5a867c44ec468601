"""The port's one rule for devices: an entry point runs on the card
(`device="cuda"`) unless its caller asks for the CPU, and without a card
the default raises; nothing falls back."""
from __future__ import annotations

import torch


def require_device(device, who: str) -> torch.device:
    """`device` as a `torch.device`; raises if it is a CUDA device and
    there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is available; pass device='cpu' to "
            f"run on the CPU")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the work queued on `dev` (a no-op on the CPU), so a host
    clock read after it times the work, not its enqueueing."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
