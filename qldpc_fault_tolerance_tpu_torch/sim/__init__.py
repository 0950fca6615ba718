from .circuit import CodeSimulator_Circuit, build_memory_circuit
from .data_error import CodeSimulator_DataError
from .phenom import CodeSimulator_Phenon
from .phenom_spacetime import CodeSimulator_Phenon_SpaceTime

__all__ = ["CodeSimulator_Circuit", "CodeSimulator_DataError",
           "CodeSimulator_Phenon", "CodeSimulator_Phenon_SpaceTime",
           "build_memory_circuit"]
