"""Explicit device selection: nothing in the port picks a device by itself.

Every stage function and the CLI take ``device``; asking for CUDA where no
card is visible is an error, never a silent move to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device`` for ``device``; raises if it names an absent CUDA card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (use 'cuda' or 'cpu')")
    return dev
