#!/usr/bin/env python3
"""Time OSD-CS's sweep with its planes in two checkouts of the PyTorch port,
in turns, on one NVIDIA GPU, and find the shots whose winner the planes'
summation order decides.

  python3 scripts/ab_cs_sweep.py --parent DIR
  python3 scripts/ab_cs_sweep.py --ties

DIR holds another checkout's ``qldpc_fault_tolerance_tpu_torch/`` and
``codes_lib_tpu/hgp_34_n{625,1225,1600}.npz`` (for example the parent
commit's, from ``git archive``).  Each side runs in its own process, which
builds that checkout's kernels into its own ``build/``; the order is
parent, change, change, parent.  The shots are BP failures as
chip_smoke.py phase 4 draws them (``scripts/ab_osd_elim.py failures``);
the first 256 of hgp_34_n625 are phase 15's.  For each code and for 256 and
2048 shots, after the full elimination (``osd_elim(full=True)``), a run
times what turns the elimination into each shot's winner: a checkout whose
kernel builds its planes (``cs_sweep_rows``) times that launch; one without
times its PyTorch plane pass (``cs_planes``, from the gathered pivot rows)
and then ``cs_sweep``, and the pass alone (``planes_...``).  Times are the
wrapper's per call between CUDA events (``..._ms``: median of three rounds
of ten calls) and the profiler device time of every kernel it launches
(``..._dev_ms``).  A checkout with the launch is checked against its plain
version (tolerance 0 on cost and index) and its plain version is timed at
256 shots of hgp_34_n625.  On phase 15's shots each run also compares the
checkout's ``cs_planes`` with a float32 sum over the pivot rows in
ascending order (``sequential_planes``): entries that differ in any bit.
Each run gives chip_smoke.py phase 16's failures and min weight, and the
summary counts the shots whose winning candidate differs between the sides.

``--ties`` runs phase 16 in this checkout and, for every OSD-CS call, the
winners of the parent's plane formula (``parent_planes``, the e0d2ff6
``cs_planes``: torch.sum over each packed word's bit planes) beside this
checkout's; for every shot whose winner differs it prints both candidates'
float32 costs in both orders and their costs from float64 planes, whose
difference is the cost gap between the two corrections.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import ab_osd_elim  # noqa: E402  (the shots, the timers, phase 16's run)

CODES = ("n625", "n1225", "n1600")
BATCHES = (256, 2048)
ORDER = 10


def sequential_planes(rows_piv, signed_piv, cost_free, free_perm, w: int,
                      dtype=None):
    """dplane (f, B) and the pairs' X (w*(w-1)/2, B): each a sum over the
    pivot rows i = 0, 1, ..., r*-1 in that order, in float32 (or
    ``dtype``)."""
    import torch

    dtype = dtype or torch.float32
    word, bit = free_perm >> 5, free_perm & 31
    pairs = [(a, b) for a in range(w) for b in range(a + 1, w)]
    ia = torch.tensor([a for a, _ in pairs], dtype=torch.int64,
                      device=rows_piv.device)
    ib = torch.tensor([b for _, b in pairs], dtype=torch.int64,
                      device=rows_piv.device)
    s = signed_piv.to(dtype)
    d = torch.zeros(free_perm.shape, dtype=dtype, device=rows_piv.device)
    x = torch.zeros((len(pairs), free_perm.shape[1]), dtype=dtype,
                    device=rows_piv.device)
    for i in range(rows_piv.shape[1]):
        t = ((rows_piv[:, i].gather(0, word) >> bit) & 1).to(dtype)
        d += t * s[i]
        if pairs:
            x += (t[ia] * s[i]) * t[ib]
    return d + cost_free.to(dtype), x


def parent_planes(rows_piv, signed_piv, cost_free, free_perm, n: int, w: int):
    """The e0d2ff6 ``cs_planes``: each packed word's (r*, 32, B) bit planes
    times the signed costs, summed over r* by torch.sum; X one free column
    a at a time.  Returns dplane and xflat (w*w, B)."""
    import torch

    W, _r, B = rows_piv.shape
    dev = rows_piv.device
    shifts = torch.arange(32, dtype=torch.int32, device=dev)[None, :, None]
    dcost = torch.empty((W, 32, B), dtype=torch.float32, device=dev)
    for wi in range(W):
        bits = ((rows_piv[wi][:, None, :] >> shifts) & 1).to(torch.float32)
        dcost[wi] = (bits * signed_piv[:, None, :]).sum(dim=0)
    dplane = dcost.reshape(W * 32, B)[:n].gather(0, free_perm) + cost_free
    k, _ = free_perm[:w].shape
    word = (free_perm[:w] >> 5)[:, None, :].expand(k, rows_piv.shape[1], B)
    tw = ((rows_piv.gather(0, word) >> (free_perm[:w] & 31)[:, None, :]) & 1
          ).to(torch.float32)
    xflat = torch.zeros((max(w * w, 1), B), dtype=torch.float32, device=dev)
    for a in range(w - 1):
        xflat[a * w + a + 1:(a + 1) * w] = (
            tw[a + 1:] * (tw[a] * signed_piv)[None]).sum(dim=1)
    return dplane, xflat


def pair_rows(w: int):
    return [a * w + b for a in range(w) for b in range(a + 1, w)]


def inputs(root: Path, name: str, dev, B: int):
    """The OSD-CS sweep's inputs for the first B BP failures of the code:
    (n, w, pat_chunk, SweepInputs, pivot rows (W, r*, B))."""
    import numpy as np
    import torch

    from qldpc_fault_tolerance_tpu_torch.ops import osd_cs_device as tcs
    from qldpc_fault_tolerance_tpu_torch.ops import osd_device as od

    hx, perm, synd = ab_osd_elim.failures(root, name, dev, B)
    m, n = hx.shape
    plan = od.build_osd_plan(hx, np.full(n, 0.05), device=dev)
    # posteriors whose stable sort is the failures' permutation
    post = torch.empty(perm.shape, dtype=torch.float32, device=dev)
    post.scatter_(1, perm, torch.arange(n, dtype=torch.float32, device=dev)
                  .expand_as(post).contiguous())
    cfg = (n, plan.rank, ORDER, tcs.cs_pat_chunk(n, plan.rank, ORDER), "pallas")
    _, x = tcs.sweep_inputs(cfg, plan.packed, plan.cost, synd.t().contiguous(),
                            post, device=dev)
    rows = x.rows_piv if hasattr(x, "rows_piv") else od.pivot_rows(x.packed, x.pr)
    return n, min(ORDER, n - plan.rank), cfg[3], x, rows


def measure(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.ops import osd_cs_device as tcs

    dev = torch.device("cuda", 0)
    _kernels.build_all()
    fused = hasattr(tcs, "cs_sweep_rows")
    out = {"root": str(root), "card": torch.cuda.get_device_name(0),
           "sweep": "cs_sweep_rows" if fused else "cs_planes + cs_sweep"}
    for name in CODES:
        for B in BATCHES:
            n, w, chunk, x, rows = inputs(root, name, dev, B)
            key = f"{B}_{name}"

            def planes():
                return tcs.cs_planes(rows, x.signed_piv, x.cost_free,
                                     x.free_perm, n, w)

            if fused:
                args = (x.packed, x.pr, x.signed_piv, x.cost_free,
                        x.free_perm, x.base)

                def sweep():
                    return tcs.cs_sweep_rows(*args, n=n, w=w, pat_chunk=chunk)

                got = sweep()
                plain = tcs.cs_sweep_rows_plain(*args, n=n, w=w, pat_chunk=chunk)
                if not (torch.equal(got[0], plain[0])
                        and torch.equal(got[1], plain[1])):
                    raise AssertionError(f"cs_sweep_rows {key} differs from "
                                         f"its plain version")
                if key == "256_n625":
                    out["plain_256_n625_ms"] = ab_osd_elim.event_ms(
                        lambda: tcs.cs_sweep_rows_plain(
                            *args, n=n, w=w, pat_chunk=chunk), 1, 1)
            else:
                def sweep():
                    d, xf = planes()
                    return tcs.cs_sweep(d, xf, x.base, w=w, pat_chunk=chunk)

                got = sweep()
                out[f"planes_{key}_ms"] = ab_osd_elim.event_ms(planes)
                out[f"planes_{key}_dev_ms"] = ab_osd_elim.kernels_ms(planes)
            out[f"sweep_{key}_ms"] = ab_osd_elim.event_ms(sweep)
            out[f"sweep_{key}_dev_ms"] = ab_osd_elim.kernels_ms(sweep)
            out[f"idx_{key}"] = got[1].cpu().tolist()
            if key == "256_n625":  # phase 15's shots
                d, xf = planes()
                ds, xs = sequential_planes(rows, x.signed_piv, x.cost_free,
                                           x.free_perm, w)
                xp = xf[pair_rows(w)]
                out["planes_vs_sequential"] = {
                    "dplane_differ": int((d.view(torch.int32)
                                          != ds.view(torch.int32)).sum()),
                    "x_differ": int((xp.view(torch.int32)
                                     != xs.view(torch.int32)).sum()),
                    "entries": [d.numel(), xs.numel()],
                    "max_abs_diff": max(float((d - ds).abs().max()),
                                        float((xp - xs).abs().max()))}
    out.update({k: v for k, v in ab_osd_elim.main_path_runs(root, dev).items()
                if k == "phase16"})
    return out


def ties() -> int:
    """Phase 16 in this checkout, each OSD-CS call's winners beside the
    parent formula's: one JSON line per shot whose winner differs."""
    sys.path.insert(0, str(ROOT))
    import torch

    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.ops import osd_cs_device as tcs
    from qldpc_fault_tolerance_tpu_torch.ops import osd_device as od

    _kernels.build_all()
    dev = torch.device("cuda", 0)
    orig = tcs.cs_sweep_rows
    calls, changed = [0], []

    def cost_of(d, xp, base, idx, f, w):
        """Candidate ``idx``'s cost from planes d (f,) and pair X xp."""
        if idx == 0:
            return base
        if idx <= f:
            return base + d[idx - 1]
        k = idx - 1 - f
        a, b = next(p for i, p in enumerate((a, b) for a in range(w)
                                            for b in range(a + 1, w)) if i == k)
        return (base + (d[a] + d[b])) - 2 * xp[k]

    def hook(packed, pr, signed, cost_free, free_perm, base, *, n, w,
             pat_chunk):
        best = orig(packed, pr, signed, cost_free, free_perm, base, n=n, w=w,
                    pat_chunk=pat_chunk)
        calls[0] += 1
        rows = od.pivot_rows(packed, pr)
        old = tcs.cs_sweep_plain(*parent_planes(rows, signed, cost_free,
                                                free_perm, n, w), base, w=w,
                                 pat_chunk=pat_chunk)
        new_planes = tcs.cs_planes(rows, signed, cost_free, free_perm, n, w)
        old_planes = parent_planes(rows, signed, cost_free, free_perm, n, w)
        d64, x64 = sequential_planes(rows, signed, cost_free, free_perm, w,
                                     torch.float64)
        f = free_perm.shape[0]
        for s in torch.nonzero(old[1] != best[1]).flatten().tolist():
            wins = (int(best[1][s]), int(old[1][s]))
            row = {"call": calls[0], "shot": s, "winner_new": wins[0],
                   "winner_old": wins[1]}
            for tag, (d, xf) in (("new_order", new_planes),
                                 ("old_order", old_planes)):
                row[f"cost32_{tag}"] = [float(cost_of(
                    d[:, s], xf[pair_rows(w), s], base[s], i, f, w))
                    for i in wins]
            row["cost64"] = [float(cost_of(d64[:, s], x64[:, s],
                                           base[s].double(), i, f, w))
                             for i in wins]
            row["gap64"] = abs(row["cost64"][0] - row["cost64"][1])
            changed.append(row)
            print(json.dumps(row), flush=True)
        return best

    hook.launches = 0  # the wrapper counts on the module's name
    tcs.cs_sweep_rows = hook
    runs = ab_osd_elim.main_path_runs(ROOT, dev)
    print(json.dumps({"phase16": runs["phase16"], "calls": calls[0],
                      "winners_changed": len(changed),
                      "max_gap64": max([r["gap64"] for r in changed],
                                       default=0.0)}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="the other checkout's root")
    ap.add_argument("--ties", action="store_true",
                    help="phase 16's winners under both plane orders")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_cs_sweep: no CUDA device available", file=sys.stderr)
        return 2
    if args.measure:
        print(json.dumps(measure(Path(args.measure).resolve())), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if args.ties:
        return ties()
    if not args.parent:
        ap.error("--parent or --ties is required")
    parent = Path(args.parent).resolve()
    order = [("parent", parent), ("change", ROOT), ("change", ROOT),
             ("parent", parent)]
    runs = {side: [] for side, _ in order}
    for side, root in order:
        out = subprocess.run([sys.executable, __file__, "--measure", str(root)],
                             capture_output=True, text=True, timeout=1500)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["side"] = side
        print(json.dumps({k: v for k, v in res.items()
                          if not k.startswith("idx_")}), flush=True)
        runs[side].append(res)
    first = {side: rs[0] for side, rs in runs.items()}
    differ = {k[4:]: sum(a != b for a, b in zip(first["parent"][k],
                                                first["change"][k]))
              for k in first["change"] if k.startswith("idx_")}
    print(json.dumps({"card": card, "winners_differ": differ, "median": {
        side: {k: statistics.median(r[k] for r in rs)
               for k in rs[0] if k.endswith("_ms")}
        for side, rs in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
