"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.

    Entry points default to CUDA and never fall back to the CPU on their
    own: the CPU runs only when the caller names it (as the tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
