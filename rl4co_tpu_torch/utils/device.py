"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """Turn ``device`` into a `torch.device`, refusing a card that is absent.

    Entry points default to ``"cuda"``. There is deliberately no silent
    move to the CPU: a caller that wants the CPU says ``device="cpu"``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU"
        )
    return device
