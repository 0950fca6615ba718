#!/usr/bin/env python3
"""A/B the PyTorch port's WER throughput between two checkouts on one GPU.

    python3 scripts/ab_port_wer.py ROOT_A ROOT_B [--rounds 4]

Each round runs A, B, B, A (each in a fresh process that imports the
package from its root, builds its kernels, warms up once and times one
``WordErrorRate``), so drift on the host or card hits both sides alike.
Configurations: hgp_34_n625 BP-50 at p=0.01 (batch 4096, 32 batches) and
BP-50 + OSD-E order 10 at p=0.05 (batch 2048, 16 batches).  Prints every
run's shots/s and the medians per side.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from qldpc_fault_tolerance_tpu_torch.codes import load_code
from qldpc_fault_tolerance_tpu_torch.decoders import BPDecoder, BPOSD_Decoder
from qldpc_fault_tolerance_tpu_torch.ops import _kernels
from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError
torch.backends.cuda.matmul.allow_tf32 = False
_kernels.build_all()
dev = torch.device("cuda", 0)
code = load_code(sys.argv[2])
out = {}
for tag, cls, p, batch, nb, kw in (
        ("bp_p0.01", BPDecoder, 0.01, 4096, 32, {}),
        ("bposd_p0.05", BPOSD_Decoder, 0.05, 2048, 16, {"osd_order": 10})):
    probs = np.full(code.N, 2 * p / 3)
    sim = CodeSimulator_DataError(
        code=code, decoder_x=cls(code.hz, probs, 50, device=dev, **kw),
        decoder_z=cls(code.hx, probs, 50, device=dev, **kw),
        pauli_error_probs=[p / 3] * 3, seed=3, batch_size=batch,
        scan_chunk=8, device=dev)
    sim.WordErrorRate(batch * nb)
    torch.cuda.synchronize()
    t = time.time()
    sim.WordErrorRate(batch * nb)
    out[tag] = sim.last_shots / (time.time() - t)
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    code = Path(__file__).resolve().parents[1] / "codes_lib_tpu" / "hgp_34_n625.npz"
    runs = {"A": [], "B": []}
    for r in range(args.rounds):
        for side in ("A", "B", "B", "A"):
            root = args.root_a if side == "A" else args.root_b
            res = subprocess.run([sys.executable, "-c", CHILD, root, str(code)],
                                 capture_output=True, text=True, check=True,
                                 timeout=600)
            vals = json.loads(res.stdout.strip().splitlines()[-1])
            runs[side].append(vals)
            print(f"round {r} {side}: " + ", ".join(
                f"{k} {v:.1f} shots/s" for k, v in vals.items()), flush=True)
    for tag in runs["A"][0]:
        a = statistics.median(v[tag] for v in runs["A"])
        b = statistics.median(v[tag] for v in runs["B"])
        print(f"median {tag}: A {a:.1f}  B {b:.1f}  B/A {b / a:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
