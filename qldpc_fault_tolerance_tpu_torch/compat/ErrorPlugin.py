"""Reference ``src/ErrorPlugin.py`` API, backed by the circuit-text plugin."""
from ..circuits import (
    AddCXError,
    AddCZError,
    AddIdlingError,
    AddMeasurementError,
    AddResetError,
    AddSingleQubitErrorBeforeRound,
)

__all__ = [
    "AddCXError", "AddCZError", "AddSingleQubitErrorBeforeRound",
    "AddMeasurementError", "AddIdlingError", "AddResetError",
]
