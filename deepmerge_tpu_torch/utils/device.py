"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``. The port's entry points run on the
    card unless the caller asks for the CPU, and never fall back to it: a
    CUDA device without a card raises, naming the card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r}: no CUDA card found — the port's kernels "
            "need one; pass device='cpu' to run their plain versions on "
            "the CPU")
    return dev
