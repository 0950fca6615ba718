"""Reference ``src/Simulators_SpaceTime.py`` API, backed by the port's engines.

The reference file duplicates the plain-stack classes verbatim (SURVEY §1
note); the shim re-exports the unified implementations under both names.
"""
from ..circuits import GenCorrecHyperGraph, GenFaultHyperGraph
from ..codes.loaders import save_object
from ._paths import load_object_compat as load_object
from ..sim import (
    CodeSimulator_Circuit_SpaceTime,
    CodeSimulator_DataError,
    CodeSimulator_Phenon,
    CodeSimulator_Phenon_SpaceTime,
)
from ..sweep import (
    CodeFamily_SpaceTime,
    CriticalExponentFit,
    DistanceEst,
    EmpericalFit,
    FitDistance,
    ThresholdEst_extrapolation,
)
from ._parmap import fun, parmap

__all__ = [
    "fun", "parmap", "save_object", "load_object",
    "CodeSimulator_DataError", "CodeSimulator_Phenon",
    "CodeSimulator_Phenon_SpaceTime", "CodeSimulator_Circuit_SpaceTime",
    "GenFaultHyperGraph", "GenCorrecHyperGraph",
    "CriticalExponentFit", "EmpericalFit", "FitDistance", "DistanceEst",
    "ThresholdEst_extrapolation", "CodeFamily_SpaceTime",
]
