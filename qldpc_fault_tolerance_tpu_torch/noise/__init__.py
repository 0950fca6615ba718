from .samplers import (
    bit_flips,
    bit_flips_packed,
    bit_flips_tilted,
    bit_flips_tilted_packed,
    depolarizing_xz,
    depolarizing_xz_packed,
    depolarizing_xz_stratum,
    depolarizing_xz_tilted,
    depolarizing_xz_tilted_packed,
    fixed_weight_flips,
    stratum_log_weight,
)

__all__ = ["depolarizing_xz", "depolarizing_xz_packed", "bit_flips",
           "bit_flips_packed", "depolarizing_xz_tilted",
           "depolarizing_xz_tilted_packed", "bit_flips_tilted",
           "bit_flips_tilted_packed", "fixed_weight_flips",
           "stratum_log_weight", "depolarizing_xz_stratum"]
