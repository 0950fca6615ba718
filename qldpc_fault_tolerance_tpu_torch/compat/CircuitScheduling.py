"""Reference ``src/CircuitScheduling.py`` API, backed by the schedulers."""
from ..circuits import ColorationCircuit, RandomCircuit

__all__ = ["ColorationCircuit", "RandomCircuit"]
