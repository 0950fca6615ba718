"""Loader for the in-repo code assets (``codes_lib_tpu/*.npz``)."""
from __future__ import annotations

import numpy as np

from .css import CssCode

__all__ = ["load_code"]


def load_code(path: str) -> CssCode:
    """Load a CssCode saved as ``.npz`` (keys hx, hz, lx, lz, name, D)."""
    if not str(path).endswith(".npz"):
        raise ValueError(f"only .npz codes are supported, got {path}")
    with np.load(path, allow_pickle=False) as data:
        code = CssCode(
            hx=data["hx"], hz=data["hz"], lx=data["lx"], lz=data["lz"],
            name=str(data["name"]),
        )
        d = int(data["D"])
    code.D = None if d < 0 else d
    return code
