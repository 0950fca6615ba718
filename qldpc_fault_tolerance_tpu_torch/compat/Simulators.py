"""Reference ``src/Simulators.py`` API, backed by the port's engines."""
from ..codes.loaders import save_object
from ._paths import load_object_compat as load_object
from ..sim import (
    CodeSimulator_Circuit,
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
)
from ..sweep import (
    CodeFamily,
    CriticalExponentFit,
    DistanceEst,
    EmpericalFit,
    FitDistance,
    ThresholdEst_extrapolation,
)
from ._parmap import fun, parmap

__all__ = [
    "fun", "parmap", "save_object", "load_object",
    "CodeSimulator_DataError", "CodeSimulator_Phenon", "CodeSimulator_Circuit",
    "CriticalExponentFit", "EmpericalFit", "FitDistance", "DistanceEst",
    "ThresholdEst_extrapolation", "CodeFamily",
]
