from .shots import (
    GeneratorInput,
    KeyInput,
    MegabatchDriver,
    batch_generator,
    batch_seed,
    count_min_driver,
)

__all__ = ["MegabatchDriver", "GeneratorInput", "KeyInput", "batch_generator",
           "batch_seed", "count_min_driver"]
