from .data_error import CodeSimulator_DataError

__all__ = ["CodeSimulator_DataError"]
