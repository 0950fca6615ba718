from .data_error import CodeSimulator_DataError
from .phenom import CodeSimulator_Phenon

__all__ = ["CodeSimulator_DataError", "CodeSimulator_Phenon"]
