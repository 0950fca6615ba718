#!/usr/bin/env python3
"""Device memory of a data-noise sweep of the PyTorch port, cell by cell,
on one NVIDIA GPU.

  python3 scripts/sweep_memory.py

Runs chip_smoke.py phase 39's threshold grid (hgp_34_n225 and n625, BP +
OSD-E 10, EvalThreshold's 6 p at est 0.14, 8192 shots a cell) twice: each
cell as an engine built, run and dropped on its own, printing the
allocated and reserved device memory after ``torch.cuda.empty_cache()``
and again after ``gc.collect()`` (a simulator and its drivers hold each
other until a collection); then each cell through ``CodeFamily.EvalWER``,
which releases a cell's graphs when it ends.  A captured graph whose
memory stays reserved after its engine is gone shows as reserved memory
that grows cell by cell.
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_memory: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.decoders import (
        BP_Decoder_Class,
        BPOSD_Decoder_Class,
    )
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.sweep import CodeFamily
    from qldpc_fault_tolerance_tpu_torch.sweep.family import threshold_grid

    _kernels.build_all()
    dev = torch.device("cuda", 0)

    def mem(tag: str) -> None:
        print(f"{tag}: allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
              f" GiB, reserved {torch.cuda.memory_reserved() / 2 ** 30:.2f} "
              f"GiB", flush=True)

    codes = [load_code(str(ROOT / "codes_lib_tpu" / f"hgp_34_{t}.npz"))
             for t in ("n225", "n625")]
    fam = CodeFamily(codes, BP_Decoder_Class(30, "minimum_sum", 0.625,
                                             device=dev),
                     BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e",
                                         10, device=dev),
                     batch_size=2048, seed=1, device=dev)
    mem("start")
    for code in codes:
        for p in threshold_grid(0.14):
            t = time.time()
            sim = fam._data_sim(code, p, "Total")
            sim.WordErrorRate(8192)
            del sim
            torch.cuda.empty_cache()
            mem(f"engine N{code.N} p={p:.4f} ({time.time() - t:.2f} s), "
                f"dropped")
            gc.collect()
            torch.cuda.empty_cache()
            mem("  after gc.collect()")
    for code in codes:
        for p in threshold_grid(0.14):
            fam.EvalWER("data", "Total", [p], 8192, if_plot=False)
            torch.cuda.empty_cache()
            mem(f"CodeFamily cell N{code.N} p={p:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
