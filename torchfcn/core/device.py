"""The devices the port runs on: a CUDA device (the kernels) or the CPU
(their plain versions).  Entry points default to "cuda" and raise without
one; nothing falls back to the CPU on its own."""

from __future__ import annotations

import torch


def port_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; raises for "cuda" without CUDA and
    for any device but a CUDA one or the CPU.  ``what`` names the caller in
    the message."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} on device='cuda' needs a CUDA device; "
                           f"pass device='cpu' to run on the CPU")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {device}")
    return device
