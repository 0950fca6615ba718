from .shots import (
    CellFusedDriver,
    GeneratorInput,
    KeyInput,
    MegabatchDriver,
    batch_generator,
    batch_seed,
    cell_fused_driver,
    count_min_driver,
)

__all__ = ["MegabatchDriver", "CellFusedDriver", "GeneratorInput", "KeyInput",
           "batch_generator", "batch_seed", "count_min_driver",
           "cell_fused_driver"]
