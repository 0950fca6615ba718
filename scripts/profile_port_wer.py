#!/usr/bin/env python3
"""Where the time of the PyTorch port's WER path goes, on one NVIDIA GPU.

Runs the main-path configurations of chip_smoke.py (hgp_34_n625, BP-50 at
p=0.01 with batches of 4096 on the default path (the bf16 head), with
float32 min-sum (bp_kernel="xla"), with int8 min-sum decoders
(quantize="int8"), with the v1 tag (bp_kernel="v1", the bf16 head over a
PallasHeadGraph) and on both fused engines, fused_sampler=True and "v2" (bf16 messages with
float decoders, int8 with quantize="int8"); BP-50 + OSD-E order 10 at
p=0.05 with batches of 2048, on the blocked and the per-column elimination route; BP-50 +
OSD-CS order 10 at p=0.05 with batches of 2048; and the phenomenological
engine of chip_smoke.py phases 28-30: CodeSimulator_Phenon on hgp_34_n625,
BP (max_iter N/30) on [H|I] then BP + OSD-E order 10 (N/10) on H,
eval_p=0.02, 9 rounds, batches of 2048; the FirstMin decoder 1 of phase
29, 11 rounds at eval_p=0.01; and BP + OSD-0 on both at hgp_34_n1600;
the phenomenological space-time engine of chip_smoke.py phase 32:
CodeSimulator_Phenon_SpaceTime on hgp_34_n625, the space-time BP window
decoder (N/30, windows of 3) then BP + OSD-E order 10, eval_p=0.01, 13
cycles, batches of 2048; and the circuit engine of phase 34:
CodeSimulator_Circuit on hgp_34_n625, p_CX=0.002, 6 cycles, BP (N/30) on
[H|I] per round then BP + OSD-E order 10, batches of 2048; and the
circuit-level space-time engine of phase 36, tagged circuit-st:
CodeSimulator_Circuit_SpaceTime on hgp_34_n625, p_CX=0.002, 13 cycles,
windows of 3, BP (max_iter N) on the detector error model's window matrix
then BP + OSD-E order 10 (N) on its final-layer matrix, batches of 2048,
its decoding graphs built on the host first) once
to warm up (on the card: to capture the megabatch's CUDA graph) and once
under torch.profiler (on the card: replaying it), and prints for each: wall
time, shots/s, the host reads per megabatch and per batch (the two-phase
straggler count and the OSD tier, ``decode_device``'s syncs, which a
replay does not make), device time summed by kernel name (the top
``--rows``, 12 by default), and the device busy share (summed kernel time
over wall time; kernels do not overlap on one stream).

Run from the root of a checkout:
  python3 scripts/profile_port_wer.py [--rows N] [--only TEXT]
(``--only`` keeps the configurations whose tag contains TEXT, e.g.
``--only phenom``.)
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
    ap.add_argument("--only", default="",
                    help="profile the configurations whose tag holds this")
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port_wer: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.decoders import (
        BP_Decoder_Class,
        BPDecoder,
        BPOSD_Decoder,
        BPOSD_Decoder_Class,
        FirstMinBP_Decoder_Class,
        ST_BP_Decoder_Circuit_Class,
        ST_BP_Decoder_Class,
        ST_BPOSD_Decoder_Circuit_Class,
        decode_device,
    )
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
    from qldpc_fault_tolerance_tpu_torch.sim import (
        CodeSimulator_Circuit,
        CodeSimulator_Circuit_SpaceTime,
        CodeSimulator_DataError,
        CodeSimulator_Phenon,
        CodeSimulator_Phenon_SpaceTime,
    )

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

    def ext(h):
        return np.hstack([h, np.eye(h.shape[0], dtype=np.uint8)])

    def phenom(pcode, cls1, cls2, eval_p=0.02):
        """chip_smoke.py's phenomenological cell: p = 3/2 eval_p, q =
        eval_p, decoder 1 on [H|I], decoder 2 on H."""
        d1 = [cls1.GetDecoder({"h": ext(h), "p_data": eval_p,
                               "p_syndrome": eval_p})
              for h in (pcode.hz, pcode.hx)]
        d2 = [cls2.GetDecoder({"h": h, "p_data": eval_p})
              for h in (pcode.hz, pcode.hx)]
        return CodeSimulator_Phenon(
            code=pcode, decoder1_x=d1[0], decoder1_z=d1[1], decoder2_x=d2[0],
            decoder2_z=d2[1], pauli_error_probs=[eval_p / 2] * 3, q=eval_p,
            seed=1, batch_size=2048, scan_chunk=8, device=dev)

    def spacetime(num_rep=3, eval_p=0.01):
        """chip_smoke.py phase 32's cell: decoder 1 the space-time window
        decoder over num_rep slices of [H|I], decoder 2 BP + OSD-E on H."""
        st = ST_BP_Decoder_Class(30, "minimum_sum", 0.625, device=dev)
        d1 = [st.GetDecoder({"h": h, "p_data": eval_p, "p_syndrome": eval_p,
                             "num_rep": num_rep}) for h in (code.hz, code.hx)]
        d2 = [osd_e10.GetDecoder({"h": h, "p_data": eval_p})
              for h in (code.hz, code.hx)]
        return CodeSimulator_Phenon_SpaceTime(
            code=code, decoder1_x=d1[0], decoder1_z=d1[1], decoder2_x=d2[0],
            decoder2_z=d2[1], pauli_error_probs=[eval_p / 2] * 3, q=eval_p,
            num_rep=num_rep, seed=1, batch_size=2048, scan_chunk=8,
            device=dev)

    def circuit(p=0.002):
        """chip_smoke.py phase 34's cell (a fresh code object: an "X"
        engine would swap it in place)."""
        ccode = load_code(str(ROOT / "codes_lib_tpu" / "hgp_34_n625.npz"))
        return CodeSimulator_Circuit(
            code=ccode, decoder1_z=bp30.GetDecoder(
                {"h": ext(ccode.hx), "p_data": p, "p_syndrome": p}),
            decoder2_z=osd_e10.GetDecoder({"h": ccode.hx, "p_data": p}),
            p=p, num_cycles=6, error_params={
                "p_i": 0, "p_state_p": 0, "p_m": 0, "p_CX": p,
                "p_idling_gate": 0},
            seed=1, batch_size=2048, scan_chunk=4, device=dev)

    def circuit_st(p=0.002):
        """chip_smoke.py phase 36's cell: SpaceTimeDecodingDemo's decoders
        (ratio 1) on the detector error model's matrices."""
        ccode = load_code(str(ROOT / "codes_lib_tpu" / "hgp_34_n625.npz"))
        sim = CodeSimulator_Circuit_SpaceTime(
            code=ccode, p=p, num_cycles=13, num_rep=3, error_params={
                "p_i": 0, "p_state_p": 0, "p_m": 0, "p_CX": p,
                "p_idling_gate": 0},
            seed=1, batch_size=2048, scan_chunk=4, device=dev)
        sim._generate_circuit_graph()
        g = sim.circuit_graph
        for k, cls in (("1", ST_BP_Decoder_Circuit_Class(
                1, "minimum_sum", 0.625, device=dev)),
                       ("2", ST_BPOSD_Decoder_Circuit_Class(
                           1, "minimum_sum", 0.625, "osd_e", 10,
                           device=dev))):
            setattr(sim, f"decoder{k}_z", cls.GetDecoder(
                {"h": g["h" + k], "code_h": ccode.hx,
                 "channel_probs": g["channel_ps" + k]}))
        return sim

    def data_run(shots):
        return (lambda sim: sim.WordErrorRate(shots)), shots

    def phenom_run(rounds, batches):
        return (lambda sim: sim.WordErrorRate(rounds, batches * 2048),
                batches * 2048)

    bp30 = BP_Decoder_Class(30, "minimum_sum", 0.625, device=dev)
    osd_e10 = BPOSD_Decoder_Class(10, "minimum_sum", 0.625, "osd_e", 10,
                                  device=dev)
    configs = (
        ("BP p=0.01", lambda: simulator(BPDecoder, 0.01, 4096), data_run(16 * 4096)),
        ("BP xla p=0.01", lambda: simulator(BPDecoder, 0.01, 4096,
                                            bp_kernel="xla"), data_run(16 * 4096)),
        ("BP int8 p=0.01", lambda: simulator(BPDecoder, 0.01, 4096,
                                             quantize="int8"), data_run(16 * 4096)),
        ("BP v1 p=0.01", lambda: simulator(BPDecoder, 0.01, 4096,
                                           bp_kernel="v1"), data_run(16 * 4096)),
        ("fused v1 BP p=0.01", lambda: simulator(BPDecoder, 0.01, 4096, True),
         data_run(16 * 4096)),
        ("fused v2 BP p=0.01", lambda: simulator(BPDecoder, 0.01, 4096, "v2"),
         data_run(16 * 4096)),
        ("fused v2 BP int8 p=0.01", lambda: simulator(
            BPDecoder, 0.01, 4096, "v2", quantize="int8"), data_run(16 * 4096)),
        ("BPOSD p=0.05", lambda: simulator(BPOSD_Decoder, 0.05, 2048,
                                           osd_order=10), data_run(8 * 2048)),
        ("BPOSD per-column p=0.05", lambda: simulator(
            BPOSD_Decoder, 0.05, 2048, elim="pallas_percol", osd_order=10),
         data_run(8 * 2048)),
        ("BPOSD-CS p=0.05", lambda: simulator(
            BPOSD_Decoder, 0.05, 2048, osd_method="osd_cs", osd_order=10),
         data_run(8 * 2048)),
        ("phenom BP/BPOSD-E n625 eval_p=0.02 9 rounds",
         lambda: phenom(code, bp30, osd_e10), phenom_run(9, 8)),
        ("phenom FirstMin/BPOSD-E n625 eval_p=0.01 11 rounds",
         lambda: phenom(code, FirstMinBP_Decoder_Class(
             5, "minimum_sum", 0.9, device=dev), osd_e10, 0.01),
         phenom_run(11, 1)),
        ("phenom BPOSD-0/BPOSD-0 n1600 eval_p=0.02 9 rounds",
         lambda: phenom(load_code(str(ROOT / "codes_lib_tpu"
                                      / "hgp_34_n1600.npz")),
                        *(BPOSD_Decoder_Class(r, "minimum_sum", 0.625, "osd_0",
                                              0, device=dev) for r in (30, 10))),
         phenom_run(9, 2)),
        ("phenom space-time BP-ST/BPOSD-E n625 num_rep 3 eval_p=0.01 13 "
         "cycles", spacetime, phenom_run(13, 8)),
        ("circuit BP/BPOSD-E n625 p=0.002 6 cycles", circuit,
         data_run(4 * 2048)),
        ("circuit-st BP/BPOSD-E n625 p=0.002 13 cycles num_rep 3", circuit_st,
         data_run(4 * 2048)))
    for tag, make, (run, shots) in configs:
        if args.only not in tag:
            continue
        sim = make()
        batches = shots // sim.batch_size
        run(sim)
        torch.cuda.synchronize()
        reads0 = (tbp.bp_decode_two_phase.host_reads, decode_device.host_reads)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            run(sim)
            torch.cuda.synchronize()
            wall = time.time() - t
        reads = (tbp.bp_decode_two_phase.host_reads - reads0[0],
                 decode_device.host_reads - reads0[1])
        rows = [e for e in prof.key_averages()
                if getattr(e, "device_time_total", 0) > 0
                and e.device_type.name == "CUDA"]
        rows.sort(key=lambda e: e.device_time_total, reverse=True)
        busy = sum(e.device_time_total for e in rows) / 1e6
        print(f"== {tag}: wall {wall:.4f} s, {shots / wall:.1f} shots/s, "
              f"device busy {busy:.4f} s ({100 * busy / wall:.1f}%); host "
              f"reads per megabatch {sim.last_host_reads}/"
              f"{sim.last_megabatches}, per batch: two-phase "
              f"{reads[0] / batches:.2f}, OSD tier {reads[1] / batches:.2f}")
        for e in rows[:args.rows]:
            print(f"  {e.device_time_total / 1e3:10.3f} ms  {e.count:6d}x  "
                  f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
