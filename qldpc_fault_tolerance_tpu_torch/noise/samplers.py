"""Generator-driven noise samplers.

Each sampler draws float32 uniforms from a ``torch.Generator`` on the
device.  Convention: ``pauli_error_probs = [px, py, pz]`` with the binning
order u < pz -> Z; pz <= u < pz+px -> X; pz+px <= u < pz+px+py -> Y.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.gf2_packed import pack_shots

__all__ = ["depolarizing_xz", "depolarizing_xz_packed", "bit_flips",
           "bit_flips_packed"]


def _uniform(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=generator.device)


def depolarizing_xz(generator: torch.Generator, shape, pauli_error_probs):
    """Sample X/Z error components for independent single-qubit Pauli noise.

    shape: output shape, e.g. (batch, n).  Returns (error_x, error_z) uint8
    on the generator's device.  The bin edges are float32 sums, as in the
    JAX package, passed as Python scalars: no host-to-device copy (which
    would synchronize the stream) per batch."""
    px, py, pz = (np.float32(p) for p in pauli_error_probs)
    z_edge, x_edge, y_edge = float(pz), float(pz + px), float(pz + px + py)
    u = _uniform(generator, shape)
    is_z = u < z_edge
    is_x = (u >= z_edge) & (u < x_edge)
    is_y = (u >= x_edge) & (u < y_edge)
    return (is_x | is_y).to(torch.uint8), (is_z | is_y).to(torch.uint8)


def depolarizing_xz_packed(generator: torch.Generator, shape,
                           pauli_error_probs):
    """``depolarizing_xz`` packed 32 shots per int32 word: (ceil(B/32), n)."""
    error_x, error_z = depolarizing_xz(generator, shape, pauli_error_probs)
    return pack_shots(error_x), pack_shots(error_z)


def bit_flips(generator: torch.Generator, shape, p):
    """i.i.d. Bernoulli(p) flips."""
    u = _uniform(generator, shape)
    return (u < float(np.float32(p))).to(torch.uint8)


def bit_flips_packed(generator: torch.Generator, shape, p):
    """``bit_flips`` packed 32 shots per int32 word (the same draws):
    (ceil(B/32), m)."""
    return pack_shots(bit_flips(generator, shape, p))
