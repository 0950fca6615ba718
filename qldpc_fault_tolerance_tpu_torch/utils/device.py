"""Device selection shared by the port's entry points.

Entry points take ``device="cuda"`` by default and run on the CPU only when
the caller asks for it.  With no card and no explicit CPU request they raise:
nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when it names CUDA and no card
    is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
