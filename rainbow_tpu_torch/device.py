"""Device selection for the port's entry points.

Entry points that create tensors take ``device="cuda"`` by default. Without
a card they raise instead of moving to the CPU; CPU runs (the tests) ask for
``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
