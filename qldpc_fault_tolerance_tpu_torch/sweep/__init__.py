"""Family orchestration and statistical analysis.

  fits      threshold / effective-distance / sustainable-threshold fits
            (host scipy, reference src/Simulators.py:675-741)
  family    CodeFamily — (code x p) sweeps for data / phenl / circuit noise
            (reference src/Simulators.py:746-963)
  family_spacetime
            CodeFamily_SpaceTime — the space-time decoding stack
            (reference src/Simulators_SpaceTime.py:1152-1362)

  fused     the fused cell path: every p of a code in one program
            (``eval_cells_fused``, the families' default for data and phenl
            grids)

The JAX package's ``sweep/__init__.py`` exports.
"""
from .family import CodeFamily
from .family_spacetime import CodeFamily_SpaceTime
from .fits import (
    CriticalExponentFit,
    DistanceEst,
    EmpericalFit,
    FitDistance,
    FitSusThreshold,
    SustainableThresholdEst,
    ThresholdEst_extrapolation,
)

__all__ = [
    "CriticalExponentFit",
    "DistanceEst",
    "EmpericalFit",
    "FitDistance",
    "FitSusThreshold",
    "SustainableThresholdEst",
    "ThresholdEst_extrapolation",
    "CodeFamily",
    "CodeFamily_SpaceTime",
]
