from .samplers import bit_flips, depolarizing_xz, depolarizing_xz_packed

__all__ = ["depolarizing_xz", "depolarizing_xz_packed", "bit_flips"]
