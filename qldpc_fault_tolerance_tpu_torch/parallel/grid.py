"""Sharding of a sweep grid across processes.

The port's counterpart of the JAX package's ``parallel/grid.py``.  Shot
batches shard across the devices of one process (``shots.py``); across
processes the (code, p, cycles) *grid* is what scales: every process of a
``torch.distributed`` group owns a round-robin subset of the cells, runs
them on its own devices, and only the scalar per-cell results cross between
processes, in one all-gather at the end.  The group is the caller's
(``torch.distributed.init_process_group``): ``gloo`` with CPU tensors, or
``nccl`` with each rank on its own card.  Without a group (world size 1)
this process owns every cell and the merge is the identity.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["process_cell_owner", "merge_cell_results", "world_size", "rank"]


def _group() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Processes of the ``torch.distributed`` group, 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if _group() else 1


def rank() -> int:
    """This process's rank in the group, 0 without one."""
    import torch.distributed as dist

    return dist.get_rank() if _group() else 0


def process_cell_owner(num_cells: int) -> np.ndarray:
    """Boolean mask of the cells this process owns: cell ``i`` belongs to
    rank ``i % world_size()``."""
    size, me = world_size(), rank()
    return np.asarray([i % size == me for i in range(int(num_cells))],
                      dtype=bool)


def merge_cell_results(local_values: np.ndarray) -> np.ndarray:
    """The per-cell results of every process.

    ``local_values``: a float array with this process's cells filled and
    every other cell NaN.  Returns the full array on every process (world
    size 1: ``local_values`` itself).  One all-gather of the float64 cells
    with NaN mapped to -inf, then a max over processes (exactly one
    process owns each cell); raises when a cell was computed by no
    process.  Under ``nccl`` the gathered tensors live on this rank's
    current card."""
    size = world_size()
    if size == 1:
        return local_values
    import torch.distributed as dist

    local = np.asarray(local_values, np.float64)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    mine = torch.from_numpy(np.nan_to_num(local, nan=-np.inf)).to(device)
    parts = [torch.empty_like(mine) for _ in range(size)]
    dist.all_gather(parts, mine)
    merged = torch.stack(parts).amax(dim=0).cpu().numpy()
    if np.isneginf(merged).any():
        raise RuntimeError("some sweep cells were computed by no process")
    return merged.reshape(local.shape)
