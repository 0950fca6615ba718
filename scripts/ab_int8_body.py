#!/usr/bin/env python3
"""Time the int8 min-sum kernels of two checkouts of the PyTorch port, in
turns, on one NVIDIA GPU: kernel B6 (``bp_head_int8``) at chip_smoke.py
phase 19's shapes and kernel B5's int8 mode (``fused_decode_stats``) at
phase 24's, on hgp_34_n625 and on the larger codes that ship with the
repo, with what the compiler reports for each kernel.

  python3 scripts/ab_int8_body.py --parent DIR

DIR holds another checkout's ``qldpc_fault_tolerance_tpu_torch/`` and
``codes_lib_tpu/hgp_34_n{625,1225,1600}.npz`` (for example the parent
commit's, from ``git archive``).  Each side runs in its own process, which
builds that checkout's kernels into its own ``build/``; the order is
parent, change, change, parent.  Per run it prints one JSON line: ``nvcc
-Xptxas -v`` of ``bp_int8.cu``, ``fused_decode_int8.cu`` and
``bp_minsum.cu`` (registers, spills, shared memory per kernel), the int8
fused kernel's clusters that the card runs at once, and the times:

  * B6 head: hx of each code, 4096 syndromes of p=0.05 errors (phase 3's
    seed), 50 iterations, tile 256, no early exit; by CUDA events, and on
    hgp_34_n625 at 10 iterations too, so that the per-iteration cost and
    the fixed cost part;
  * B6 tail (hgp_34_n625): 768 stragglers of a 3-iteration head and 256
    zero rows, tile 512, early exit (events);
  * B5 int8: 4096 shots at p=0.01, 50 iterations, tile 256 (block_w 8), on
    hgp_34_n625 (and at p=0.05) and hgp_34_n1225, by profiler device time
    (hgp_34_n1600's block does not fit the kernel).

Every kernel output is checked against its plain version first.  Each run
also gives chip_smoke.py phase 21's and phase 25's int8 (failures, min
weight), which must not depend on the side.  The last line is a summary
with the median of each side.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 20261016  # chip_smoke.py's


def ptxas_report(root: Path, name: str) -> list:
    """The lines of ``nvcc -Xptxas -v`` about the kernels of csrc/<name>.cu
    (the port's build flags, output discarded)."""
    sys.path.insert(0, str(root))
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels

    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           os.devnull, str(root / "qldpc_fault_tolerance_tpu_torch" / "csrc"
                           / f"{name}.cu")]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    return [ln.split("ptxas info    :")[-1].strip()
            for ln in (out.stdout + out.stderr).splitlines()
            if any(k in ln for k in ("entry function", "Function properties",
                                     "registers", "spill"))]


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
    from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk
    from qldpc_fault_tolerance_tpu_torch.ops import gf2_kernel as gk

    dev = torch.device("cuda", 0)
    _kernels.build_all(("bp_int8", "fused_decode_int8"))

    def events(fn, reps):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def same(a, b, what):
        for x, y in zip(a, b):
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            if not torch.equal(x, y):
                raise AssertionError(f"{what} differs from its plain version")

    out = {"root": str(root), "card": torch.cuda.get_device_name(0)}
    key = gk.fold_in(gk.split_key(gk.prng_key(SEED))[1], 0)
    for name in ("n625", "n1225", "n1600"):
        code = load_code(str(root / "codes_lib_tpu" / f"hgp_34_{name}.npz"))
        hx = code.hx
        m, n = hx.shape
        rng = np.random.default_rng(SEED)
        err = (rng.random((4096, n)) < 2 * 0.05 / 3).astype(np.uint8)
        synd = torch.from_numpy((err @ hx.T % 2).astype(np.uint8)).to(dev)
        llr0 = tbp.llr_from_probs(np.full(n, 2 * 0.05 / 3), dev)
        sg = bk.build_sparse_head(tbp.build_tanner_graph_host(hx), dev)

        def head(iters, rows=synd, block=256, early=False):
            return lambda: bk.bp_head_int8(sg, rows, llr0, head_iters=iters,
                                           block_b=block, early_stop=early)

        with _kernels.force_plain():
            plain = head(50)()
        same(head(50)(), plain, f"B6 head {name}")
        out[f"b6_head_{name}_ms"] = events(head(50), 10)
        if name == "n625":
            out["b6_head10_n625_ms"] = events(head(10), 10)
            first = head(3)()
            strag = torch.nonzero(~first[1]).flatten()[:768]
            tail_rows = torch.cat(
                [synd[strag], synd.new_zeros((1024 - strag.numel(), m))])
            tail = head(50, tail_rows, 512, True)
            with _kernels.force_plain():
                plain = tail()
            same(tail(), plain, "B6 tail")
            out["b6_tail_n625_ms"] = events(tail, 10)
        if name == "n1600":
            continue
        for p in ((0.01, 0.05) if name == "n625" else (0.01,)):
            llr = tbp.llr_from_probs(np.full(n, 2 * p / 3), dev)
            spec = gk.build_fused_decode_spec(code.hx, code.hz, code.lx,
                                              code.lz, [p / 3] * 3, llr, llr,
                                              dev)
            kw = dict(eval_type="Total", max_iter_z=50, max_iter_x=50,
                      ms_scaling_factor=0.625, quantize="int8", block_w=8)

            def run():
                return gk.fused_decode_stats(spec, key, 4096, **kw)

            k, pl = run(), gk.fused_decode_plain(spec, key, 4096, **kw)
            if (int(k[0]), int(k[1])) != (int(pl[0]), int(pl[1])) or not all(
                    torch.equal(a[f], b[f])
                    for a, b in ((k[2], pl[2]), (k[3], pl[3]))
                    for f in ("converged", "iterations")):
                raise AssertionError(f"B5 int8 {name} at p={p} differs from "
                                     "its plain version")
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    run()
                torch.cuda.synchronize()
            us = sum(e.device_time_total for e in prof.key_averages()
                     if "fused_decode_int8_kernel" in e.key)
            if us <= 0:
                raise AssertionError("the profiler recorded no B5 device time")
            out[f"b5_int8_{name}_p{p}_ms"] = us / 10 / 1e3
            out[f"b5_int8_{name}_p{p}_failures"] = int(k[0])
        out[f"b5_active_clusters_{name}_w8"] = gk.fused_int8_active_clusters(
            spec, 8)

    # chip_smoke.py phases 21 and 25 (int8): failures and min weight
    from qldpc_fault_tolerance_tpu_torch.decoders import BPDecoder
    from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError

    code = load_code(str(root / "codes_lib_tpu" / "hgp_34_n625.npz"))
    n = code.N
    probs = np.full(n, 2 * 0.01 / 3)
    for tag, fused in (("phase21", False), ("phase25_int8", "v2")):
        sim = CodeSimulator_DataError(
            code=code, decoder_x=BPDecoder(code.hz, probs, 50, device=dev,
                                           quantize="int8"),
            decoder_z=BPDecoder(code.hx, probs, 50, device=dev,
                                quantize="int8"),
            pauli_error_probs=[0.01 / 3] * 3, seed=SEED, batch_size=4096,
            scan_chunk=8, fused_sampler=fused, device=dev)
        sim.WordErrorRate(16 * 4096)
        out[tag] = [sim.last_failures, sim.min_logical_weight]
    out["ptxas"] = {name: ptxas_report(root, name)
                    for name in ("bp_int8", "fused_decode_int8", "bp_minsum")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_int8_body: no CUDA device available", file=sys.stderr)
        return 2
    if args.measure:
        print(json.dumps(measure(Path(args.measure).resolve())), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    parent = Path(args.parent).resolve()
    runs = {"parent": [], "change": []}
    for side, root in (("parent", parent), ("change", ROOT), ("change", ROOT),
                       ("parent", parent)):
        out = subprocess.run([sys.executable, __file__, "--measure", str(root)],
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["side"] = side
        print(json.dumps(res), flush=True)
        runs[side].append(res)
    keys = [k for k in runs["change"][0] if k.endswith("_ms")]
    print(json.dumps({"card": card, "median": {
        side: {k: statistics.median(r[k] for r in rs) for k in keys}
        for side, rs in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
