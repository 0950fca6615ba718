from .grid import merge_cell_results, process_cell_owner
from .shots import (
    SHOT_AXIS,
    CellFusedDriver,
    GeneratorInput,
    KeyInput,
    MegabatchDriver,
    MeshCellFusedDriver,
    ShotMesh,
    batch_generator,
    batch_seed,
    cell_fused_driver,
    count_min_driver,
    drain_double_buffered,
    replay_fold,
    sharded_batch_stats,
    shot_mesh,
    split_keys_for_mesh,
)

__all__ = ["SHOT_AXIS", "ShotMesh", "shot_mesh", "split_keys_for_mesh",
           "replay_fold", "sharded_batch_stats", "MegabatchDriver",
           "CellFusedDriver", "MeshCellFusedDriver", "GeneratorInput",
           "KeyInput", "batch_generator", "batch_seed", "count_min_driver",
           "cell_fused_driver", "drain_double_buffered",
           "process_cell_owner", "merge_cell_results"]
