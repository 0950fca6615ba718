"""Cell ownership of a sweep grid across processes.

The port's counterpart of the JAX package's ``parallel/grid.py``, where
every JAX process owns a round-robin subset of the (code, p, cycles) cells
and the scalar per-cell results meet in one allgather at the end.  Here at
world size 1: this process owns every cell and the merge is the identity.
A grid sharded across processes raises until the port's multi-GPU layer
(``torch.distributed``; ROADMAP queue A item 7) exists.
"""
from __future__ import annotations

import numpy as np

__all__ = ["process_cell_owner", "merge_cell_results", "world_size"]


def world_size() -> int:
    """Processes of the ``torch.distributed`` group, 1 without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _single_process(what: str) -> None:
    if world_size() != 1:
        raise NotImplementedError(
            f"{what}: a sweep grid across processes is not ported yet "
            "(ROADMAP queue A item 7); run it in one process")


def process_cell_owner(num_cells: int) -> np.ndarray:
    """Boolean mask of the cells this process owns: all of them."""
    _single_process("process_cell_owner")
    return np.ones(int(num_cells), dtype=bool)


def merge_cell_results(local_values: np.ndarray) -> np.ndarray:
    """Per-cell results of every process: this process's own."""
    _single_process("merge_cell_results")
    return local_values
