#!/usr/bin/env python3
"""Failure fraction of the phenomenological FirstMin/BPOSD-E cell over
eval_p and rounds, on one NVIDIA GPU.

CodeSimulator_Phenon on hgp_34_n625 as chip_smoke.py phase 29 builds it
(decoder 1 FirstMin BP, N/5 restarts, min-sum 0.9, on [H|I]; decoder 2 BP +
OSD-E order 10, N/10 iterations, on H; p = 3/2 eval_p depolarizing, q =
eval_p syndrome flips), one batch of 2048 shots at chip_smoke.py's seed per
(rounds, eval_p): prints failures, their fraction, WER per cycle, min
weight and the wall time.  It picks an eval_p at which phase 29's pin is
informative (neither almost no shot nor almost every shot failed).

Run from the root of a checkout:
  python3 scripts/phenom_p_scan.py [--rounds 5 11] [--p 0.004 0.01 0.02]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, nargs="+", default=[5, 11])
    ap.add_argument("--p", type=float, nargs="+",
                    default=[0.004, 0.006, 0.008, 0.01, 0.012, 0.015, 0.02])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.decoders import (
        BPOSD_Decoder_Class,
        FirstMinBP_Decoder_Class,
    )
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_Phenon

    if not torch.cuda.is_available():
        raise SystemExit("phenom_p_scan.py needs a CUDA device")
    _kernels.build_all()
    dev = torch.device("cuda")
    code = load_code(str(chip_smoke.CODE))
    first_min = FirstMinBP_Decoder_Class(5, "minimum_sum", 0.9, device=dev)
    osd_e10 = BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e", 10,
                                  device=dev)

    def ext(h):
        return np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])

    for rounds in args.rounds:
        for p in args.p:
            d1 = [first_min.GetDecoder({"h": ext(h), "p_data": p,
                                        "p_syndrome": p})
                  for h in (code.hz, code.hx)]
            d2 = [osd_e10.GetDecoder({"h": h, "p_data": p})
                  for h in (code.hz, code.hx)]
            sim = CodeSimulator_Phenon(
                code=code, decoder1_x=d1[0], decoder1_z=d1[1],
                decoder2_x=d2[0], decoder2_z=d2[1],
                pauli_error_probs=[p / 2] * 3, q=p, seed=chip_smoke.SEED,
                batch_size=2048, scan_chunk=8, device=dev)
            torch.cuda.synchronize()
            t = time.time()
            wer, _ = sim.WordErrorRate(rounds, 2048)
            dt = time.time() - t
            print(f"rounds {rounds} eval_p {p}: failures {sim.last_failures}"
                  f"/{sim.last_shots} ({sim.last_failures / sim.last_shots:.3f})"
                  f" WER/cycle {wer:.3e} min_w {sim.min_logical_weight} "
                  f"{dt:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
