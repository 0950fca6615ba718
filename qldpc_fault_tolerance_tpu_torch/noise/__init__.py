from .samplers import (
    bit_flips,
    bit_flips_packed,
    depolarizing_xz,
    depolarizing_xz_packed,
)

__all__ = ["depolarizing_xz", "depolarizing_xz_packed", "bit_flips",
           "bit_flips_packed"]
