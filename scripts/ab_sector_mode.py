#!/usr/bin/env python3
"""Time kernel 1's sector mode (``bp_minsum(sectors=)``,
``csrc/bp_minsum.cu`` ``bp_minsum_sectors_launch``) of two checkouts of the
PyTorch port, in turns, on one NVIDIA GPU, at chip_smoke.py phase 53 (a)'s
shape: hz (+) hx of hgp_34_n625 and of hgp_34_n1600, 4096 syndromes of
p=0.05 errors, 50 iterations.

  python3 scripts/ab_sector_mode.py --parent DIR
  python3 scripts/ab_sector_mode.py            # this checkout alone
  python3 scripts/ab_sector_mode.py --lanes    # at each items per block

DIR holds another checkout's ``qldpc_fault_tolerance_tpu_torch/`` and
``codes_lib_tpu/hgp_34_n{625,1600}.npz`` (for example the parent commit's,
from ``git archive``).  Each side runs in its own process, which builds
that checkout's kernel into its own ``build/``; the order is parent,
change, change, parent.  Per run it prints one JSON line: per code the
layout the side's wrapper takes (items per block, threads, shared memory
per block, memory mode), the ms of one sector-mode launch and of the two
kernel-1 launches on hz and hx alone (CUDA events, the mean of 20 calls
after a warm-up), and a digest of the outputs.  Every output is first
checked bit for bit against the plain version and the two launches, and
the digests must agree between the sides.  The last line gives the card,
its power limit and each side's medians.  ``--lanes`` times this
checkout's sector mode at each number of items per block its layout
admits (``minsum_layout(lanes=)``), each run checked against the plain
version.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 20261016 + 53  # chip_smoke.py phase 53's
CODES = ("n625", "n1600")
SHOTS, P, ITERS, REPS = 4096, 0.05, 50, 20


def event_ms(fn, reps: int) -> float:
    """Mean time per call of ``fn`` between CUDA events, over ``reps``
    back-to-back calls after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def digest(out) -> str:
    h = hashlib.sha256()
    for t in out:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def layout(bk, dev, sectors, m, n, rw, cw) -> dict:
    """The layout this side's wrapper takes for the sector mode: the
    parent's sizes items by the whole graph with a sector's rows, this
    checkout's by the sector sizes."""
    items = SHOTS * len(sectors[0])
    if "rows" in inspect.signature(bk.card_minsum_layout).parameters:
        lay = bk.card_minsum_layout(dev, items, m, n, rw, cw, False,
                                    rows=max(map(max, sectors)),
                                    sectors=True)
    else:
        lay = bk.card_minsum_layout(dev, items, m, n, rw, cw, False,
                                    sectors=sectors)
    return {"items_per_block": lay.lanes, "threads": lay.threads,
            "smem_bytes": lay.smem_bytes, "memory": lay.memory,
            "blocks": lay.grid}


def measure(root: Path, lanes_sweep: bool = False) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
    from qldpc_fault_tolerance_tpu_torch.ops import bp_kernel as bk

    dev = torch.device("cuda", 0)
    _kernels.build_all(("bp_minsum",))
    out = {"root": str(root)}
    for tag in CODES:
        code = load_code(str(root / "codes_lib_tpu" / f"hgp_34_{tag}.npz"))
        hz, hx = code.hz, code.hx
        (ma, na), (mb, nb) = hz.shape, hx.shape
        h = np.zeros((ma + mb, na + nb), np.uint8)
        h[:ma, :na], h[ma:, na:] = hz, hx
        sectors = ((ma, mb), (na, nb))
        rng = np.random.default_rng(SEED)
        q = 2 * P / 3
        sa, sb = (torch.from_numpy(
            ((rng.random((SHOTS, hm.shape[1])) < q).astype(np.uint8)
             @ hm.T % 2).astype(np.uint8)).to(dev) for hm in (hz, hx))
        synd = torch.cat([sa, sb], dim=1)
        graph = tbp.build_tanner_graph(h, dev)
        ga, gb = tbp.build_tanner_graph(hz, dev), tbp.build_tanner_graph(hx, dev)
        la = tbp.llr_from_probs(np.full(na, q), dev)
        lb = tbp.llr_from_probs(np.full(nb, q), dev)
        llr = torch.cat([la, lb])

        def run_sec():
            return bk.bp_minsum(graph, synd, llr, max_iter=ITERS,
                                ms_scaling_factor=0.625, sectors=sectors)

        def run_two():
            return (bk.bp_minsum(ga, sa, la, max_iter=ITERS,
                                 ms_scaling_factor=0.625),
                    bk.bp_minsum(gb, sb, lb, max_iter=ITERS,
                                 ms_scaling_factor=0.625))

        sec = run_sec()
        with _kernels.force_plain():
            plain = run_sec()
        ka, kb = run_two()
        two = (torch.cat([ka[0], kb[0]], 1), ka[1] & kb[1],
               torch.cat([ka[2], kb[2]], 1), torch.maximum(ka[3], kb[3]))
        for a, b, c in zip(sec, plain, two):
            if not (torch.equal(a, b) and torch.equal(a, c)):
                raise AssertionError(f"{tag}: the sector mode differs from "
                                     f"its plain version or two launches")
        m, rw = graph.chk_nbr.shape
        n, cw = graph.var_nbr.shape
        out[f"{tag}_layout"] = layout(bk, dev, sectors, m, n, rw, cw)
        if lanes_sweep:
            orig = bk.minsum_layout
            for lanes in range(1, bk.MINSUM_MAX_LANES + 1):
                bk.minsum_layout = (lambda *a, _l=lanes, **k:
                                    orig(*a, **k, lanes=_l))
                try:
                    got = run_sec()
                except ValueError:
                    continue
                finally:
                    bk.minsum_layout = orig
                if not all(torch.equal(a, b) for a, b in zip(got, plain)):
                    raise AssertionError(f"{tag} at {lanes} items per block "
                                         f"differs from its plain version")
                bk.minsum_layout = (lambda *a, _l=lanes, **k:
                                    orig(*a, **k, lanes=_l))
                try:
                    out[f"{tag}_lanes{lanes}_ms"] = event_ms(run_sec, REPS)
                finally:
                    bk.minsum_layout = orig
        out[f"{tag}_ms"] = event_ms(run_sec, REPS)
        out[f"{tag}_two_ms"] = event_ms(run_two, REPS)
        out[f"{tag}_digest"] = digest(sec)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--lanes", action="store_true",
                    help="time this checkout at each items per block")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_sector_mode: no CUDA device available", file=sys.stderr)
        return 2
    if args.measure or args.lanes:
        root = Path(args.measure or ROOT).resolve()
        print(json.dumps(measure(root, args.lanes)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    order = [("change", ROOT)]
    if args.parent:
        parent = Path(args.parent).resolve()
        order = [("parent", parent), ("change", ROOT), ("change", ROOT),
                 ("parent", parent)]
    runs = {side: [] for side, _ in order}
    for side, root in order:
        res = subprocess.run([sys.executable, __file__, "--measure", str(root)],
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        line = json.loads(res.stdout.strip().splitlines()[-1])
        line["side"] = side
        print(json.dumps(line), flush=True)
        runs[side].append(line)
    digests = {tag: {r[f"{tag}_digest"] for rs in runs.values() for r in rs}
               for tag in CODES}
    if any(len(v) != 1 for v in digests.values()):
        print(f"outputs differ between the sides: {digests}", file=sys.stderr)
        return 1
    keys = [k for k in runs["change"][0] if k.endswith("_ms")]
    print(json.dumps({"card": card, "median": {
        side: {k: statistics.median(r[k] for r in rs) for k in keys}
        for side, rs in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
