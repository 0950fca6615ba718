#!/usr/bin/env python3
"""Where the time of the PyTorch port's WER path goes, on one NVIDIA GPU.

Runs the main-path configurations of chip_smoke.py (hgp_34_n625, BP-50 at
p=0.01 with batches of 4096 on the default path (the bf16 head), with
float32 min-sum (bp_kernel="xla"), with int8 min-sum decoders
(quantize="int8"), with the v1 tag (bp_kernel="v1", the bf16 head over a
PallasHeadGraph) and on both fused engines, fused_sampler=True and "v2" (bf16 messages with
float decoders, int8 with quantize="int8"); BP-50 + OSD-E order 10 at
p=0.05 with batches of 2048, on the blocked and the per-column elimination route; BP-50 +
OSD-CS order 10 at p=0.05 with batches of 2048) once to warm up and once
under torch.profiler, and prints
for each: wall time, shots/s, device time summed by kernel name (the top
``--rows``, 12 by default), and the device busy share (summed kernel time
over wall time; kernels do not overlap on one stream).

Run from the root of a checkout:  python3 scripts/profile_port_wer.py [--rows N]
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=12,
                    help="kernels listed per configuration")
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port_wer: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.decoders import BPDecoder, BPOSD_Decoder
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError

    torch.backends.cuda.matmul.allow_tf32 = False
    _kernels.build_all()
    dev = torch.device("cuda", 0)
    code = load_code(str(ROOT / "codes_lib_tpu" / "hgp_34_n625.npz"))
    print(torch.cuda.get_device_name(0), flush=True)

    def simulator(cls, p, batch, fused=False, elim="pallas", **kw):
        probs = np.full(code.N, 2 * p / 3)
        # decoders read the elimination route when they are built
        os.environ["QLDPC_OSD_ELIM"] = elim
        return CodeSimulator_DataError(
            code=code, decoder_x=cls(code.hz, probs, 50, device=dev, **kw),
            decoder_z=cls(code.hx, probs, 50, device=dev, **kw),
            pauli_error_probs=[p / 3] * 3, seed=1, batch_size=batch,
            scan_chunk=8, fused_sampler=fused, device=dev)

    for tag, sim, shots in (
            ("BP p=0.01", simulator(BPDecoder, 0.01, 4096), 16 * 4096),
            ("BP xla p=0.01", simulator(BPDecoder, 0.01, 4096,
                                        bp_kernel="xla"), 16 * 4096),
            ("BP int8 p=0.01", simulator(BPDecoder, 0.01, 4096,
                                         quantize="int8"), 16 * 4096),
            ("BP v1 p=0.01", simulator(BPDecoder, 0.01, 4096,
                                       bp_kernel="v1"), 16 * 4096),
            ("fused v1 BP p=0.01", simulator(BPDecoder, 0.01, 4096, True),
             16 * 4096),
            ("fused v2 BP p=0.01", simulator(BPDecoder, 0.01, 4096, "v2"),
             16 * 4096),
            ("fused v2 BP int8 p=0.01", simulator(BPDecoder, 0.01, 4096, "v2",
                                                  quantize="int8"), 16 * 4096),
            ("BPOSD p=0.05", simulator(BPOSD_Decoder, 0.05, 2048,
                                       osd_order=10), 8 * 2048),
            ("BPOSD per-column p=0.05", simulator(
                BPOSD_Decoder, 0.05, 2048, elim="pallas_percol",
                osd_order=10), 8 * 2048),
            ("BPOSD-CS p=0.05", simulator(BPOSD_Decoder, 0.05, 2048,
                                          osd_method="osd_cs", osd_order=10),
             8 * 2048)):
        sim.WordErrorRate(shots)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            sim.WordErrorRate(shots)
            torch.cuda.synchronize()
            wall = time.time() - t
        rows = [e for e in prof.key_averages()
                if getattr(e, "device_time_total", 0) > 0
                and e.device_type.name == "CUDA"]
        rows.sort(key=lambda e: e.device_time_total, reverse=True)
        busy = sum(e.device_time_total for e in rows) / 1e6
        print(f"== {tag}: wall {wall:.4f} s, {shots / wall:.1f} shots/s, "
              f"device busy {busy:.4f} s ({100 * busy / wall:.1f}%)")
        for e in rows[:args.rows]:
            print(f"  {e.device_time_total / 1e3:10.3f} ms  {e.count:6d}x  "
                  f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
