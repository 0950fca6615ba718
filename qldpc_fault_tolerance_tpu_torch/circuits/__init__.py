"""Circuit layer: IR, CX scheduling, noise plugin, Pauli-frame detector
sampler, detector error model (the JAX package's ``circuits/``).

  scheduling    host-side CX schedule generation (coloration / random;
                ``ColorationCircuitHK`` imports networkx when called)
  ir            stabilizer-circuit IR with stim-compatible text round-trip
  error_plugin  circuit-text noise rewrites (AddCXError & friends)
  sampler       vectorized Pauli-frame detector sampler (PyTorch)
  dem           detector-error-model derivation + fault-hypergraph extraction

Every module but ``sampler`` is the port's own copy of the JAX package's
host module of that name.
"""
from .scheduling import ColorationCircuit, ColorationCircuitHK, RandomCircuit, validate_schedule
from .ir import Circuit, target_rec
from .error_plugin import (
    AddCXError,
    AddCZError,
    AddMeasurementError,
    AddResetError,
    AddIdlingError,
    AddSingleQubitErrorBeforeRound,
)
from .sampler import FrameSampler
from .dem import (
    DetectorErrorModel,
    detector_error_model,
    GenFaultHyperGraph,
    GenCorrecHyperGraph,
)

__all__ = [
    "ColorationCircuit",
    "ColorationCircuitHK",
    "RandomCircuit",
    "validate_schedule",
    "Circuit",
    "target_rec",
    "AddCXError",
    "AddCZError",
    "AddMeasurementError",
    "AddResetError",
    "AddIdlingError",
    "AddSingleQubitErrorBeforeRound",
    "FrameSampler",
    "DetectorErrorModel",
    "detector_error_model",
    "GenFaultHyperGraph",
    "GenCorrecHyperGraph",
]
