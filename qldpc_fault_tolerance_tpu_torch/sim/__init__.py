from .circuit import CodeSimulator_Circuit, build_memory_circuit
from .circuit_spacetime import CodeSimulator_Circuit_SpaceTime
from .data_error import CodeSimulator_DataError
from .phenom import CodeSimulator_Phenon
from .phenom_spacetime import CodeSimulator_Phenon_SpaceTime
from .stream_spacetime import (
    CircuitStreamDriver,
    PhenomStreamDriver,
    st_round_counts,
    st_window_count,
)

__all__ = ["CodeSimulator_Circuit", "CodeSimulator_Circuit_SpaceTime",
           "CodeSimulator_DataError", "CodeSimulator_Phenon",
           "CodeSimulator_Phenon_SpaceTime", "CircuitStreamDriver",
           "PhenomStreamDriver", "build_memory_circuit", "st_round_counts",
           "st_window_count"]
