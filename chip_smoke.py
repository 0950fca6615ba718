#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's code-capacity WER path on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card (nvidia-smi name and power limit); TF32 off for every matmul
  2. build both kernels from qldpc_fault_tolerance_tpu_torch/csrc (one nvcc
     per source, started together)
  3. kernel 1 (min-sum BP) against its plain PyTorch version on the card:
     hgp_34_n625 hx, B=4096, syndromes of p=0.05 errors, max_iter 50
  4. kernel 2 (GF(2) elimination) against its plain version: B=256 shots
     BP failed in phase 3, permuted by their posteriors
  5. main path, BP: CodeSimulator_DataError WER on hgp_34_n625, BP-50,
     depolarizing p=0.01, 16 batches of 4096
  6. main path, BPOSD: the same code, BP-50 + OSD-E order 10, p=0.05,
     8 batches of 2048
  7. anchors: zero failures at p=0; one BPOSD batch with every kernel
     replaced by its plain version gives the same failures and min weight;
     a small batch decoded on the CPU and on the card agrees
  8. a "kernels" JSON line: launches on the main path (phases 5-6), error
     against the plain version, times, bound

The last line of standard output is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "qldpc_fault_tolerance_tpu_torch"
CODE = ROOT / "codes_lib_tpu" / "hgp_34_n625.npz"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
SEED = 20261016


def log(msg: str) -> None:
    print(msg, flush=True)


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bp_bound_ms(graph, B: int, iters_total: int) -> tuple[float, str]:
    """Least time for the min-sum decode of these inputs: bytes of reading
    the syndromes, LLRs and graph once and writing the four outputs once,
    against the operations the decode does (per shot-iteration 11 per edge
    — 8 in the check pass, 2 in the variable pass, 1 in the parity pass —
    and 2 per variable)."""
    m, rw = graph.chk_nbr.shape
    n, cw = graph.var_nbr.shape
    edges = int(graph.chk_mask.sum())
    nbytes = (m * B + 4 * n + 5 * m * rw + 9 * n * cw      # inputs
              + n * B + 4 * n * B + B + 4 * B)               # outputs
    ops = iters_total * (11 * edges + 2 * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def message_bytes(graph) -> int:
    """Message bytes one live shot-iteration of the min-sum algorithm moves:
    16 per edge (v2c read and c2v write in the check pass, c2v read and v2c
    write in the variable pass), 1 per edge for the parity pass's hard
    decisions, 5 per variable (posterior and hard decision written) and 2
    per check (the syndrome read twice) — in device memory unless a kernel
    keeps the messages on chip."""
    m = graph.chk_nbr.shape[0]
    n = graph.var_nbr.shape[0]
    edges = int(graph.chk_mask.sum())
    return 17 * edges + 5 * n + 2 * m


def elim_bound_ms(W: int, m: int, r_star: int, B: int,
                  word_ops: int) -> tuple[float, str]:
    """Least time for the elimination of these inputs: bytes of the packed
    rows and syndromes read once and the five outputs written once, against
    the word operations the column-by-column elimination needs (counted by
    ops/osd_device.py elimination_work, at the float32 scalar rate)."""
    nbytes = 4 * B * (W * m + m) + 4 * B * (m + 2 * r_star + m + 32)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, word_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / PKG / "csrc").is_dir() or not CODE.exists():
        print(f"chip_smoke: run from a checkout holding {PKG}/ and "
              f"codes_lib_tpu/", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from qldpc_fault_tolerance_tpu_torch.codes import load_code
    from qldpc_fault_tolerance_tpu_torch.decoders import (
        BPDecoder,
        BPOSD_Decoder,
        decode_device,
    )
    from qldpc_fault_tolerance_tpu_torch.ops import _kernels
    from qldpc_fault_tolerance_tpu_torch.ops import bp as tbp
    from qldpc_fault_tolerance_tpu_torch.ops import osd_device as tod
    from qldpc_fault_tolerance_tpu_torch.ops.bp_kernel import bp_minsum
    from qldpc_fault_tolerance_tpu_torch.sim import CodeSimulator_DataError

    t_start = time.time()
    dev = torch.device("cuda", 0)

    # 1. the card
    card = card_line()
    log(f"[1] card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.time()
    libs = _kernels.build_all()
    log(f"[2] built {sorted(libs)} in {time.time() - t0:.2f} s")

    code = load_code(str(CODE))
    hx = code.hx
    m, n = hx.shape
    rng = np.random.default_rng(SEED)

    # 3. kernel 1 vs its plain version
    B1, p1, it1, scale = 4096, 0.05, 50, 0.625
    err = (rng.random((B1, n)) < 2 * p1 / 3).astype(np.uint8)
    synd = torch.from_numpy((err @ hx.T % 2).astype(np.uint8)).to(dev)
    graph = tbp.build_tanner_graph(hx, dev)
    llr0 = tbp.llr_from_probs(np.full(n, 2 * p1 / 3), dev)

    def run_k1():
        return bp_minsum(graph, synd, llr0, max_iter=it1, ms_scaling_factor=scale)

    k1 = run_k1()
    with _kernels.force_plain():
        p1_out = run_k1()
    torch.cuda.synchronize()
    for name, a, b in zip(("error", "converged", "iterations"),
                          (k1[0], k1[1], k1[3]), (p1_out[0], p1_out[1], p1_out[3])):
        if not torch.equal(a, b):
            raise AssertionError(f"kernel 1 {name} differs from the plain version")
    k1_err = float((k1[2] - p1_out[2]).abs().max())
    if k1_err > 0.0:  # tolerance 0: built with -fmad=false, same op order
        raise AssertionError(f"kernel 1 posterior differs by {k1_err}")
    k1_ms = event_ms(run_k1, 10)
    with _kernels.force_plain():
        k1_plain_ms = event_ms(run_k1, 2)
    shot_iters = int(k1[3].sum())
    k1_bound, k1_by = bp_bound_ms(graph, B1, shot_iters)
    msg_bytes = shot_iters * message_bytes(graph)
    log(f"[3] kernel 1 == plain (posterior max |diff| {k1_err}); converged "
        f"{float(k1[1].float().mean()):.4f}; kernel {k1_ms:.3f} ms, plain "
        f"{k1_plain_ms:.3f} ms, bound {k1_bound:.4f} ms ({k1_by}); "
        f"{shot_iters} shot-iterations move {msg_bytes / 1e9:.4f} GB of "
        f"messages")

    # 4. kernel 2 vs its plain version
    B2 = 256
    plan = tod.build_osd_plan(hx, np.full(n, 2 * p1 / 3), device=dev)
    w = min(10, n - plan.rank)
    bad = torch.nonzero(~k1[1]).flatten()[:B2]
    if bad.numel() < B2:
        raise AssertionError(f"only {bad.numel()} BP failures in phase 3")
    perm = torch.sort(k1[2][bad], dim=1, stable=True).indices
    packed = tod._permute_and_pack(tod._unpack_rows(plan.packed, n), perm)
    synd2 = synd[bad].to(torch.int32).t().contiguous()

    def run_k2():
        return tod.osd_elim(packed, synd2, n=n, r_star=plan.rank, fcap=w)

    k2 = run_k2()
    with _kernels.force_plain():
        p2_out = run_k2()
    torch.cuda.synchronize()
    k2_err = max(int((a - b).abs().max()) for a, b in zip(k2, p2_out))
    if k2_err != 0:
        raise AssertionError("kernel 2 differs from the plain version")
    k2_ms = event_ms(run_k2, 20)
    with _kernels.force_plain():
        k2_plain_ms = event_ms(run_k2, 1)
    work = tod.elimination_work(packed, synd2, n=n, r_star=plan.rank, fcap=w)
    k2_bound, k2_by = elim_bound_ms(packed.shape[0], m, plan.rank, B2, work)
    log(f"[4] kernel 2 == plain (all five outputs bit-exact); rank "
        f"{plan.rank}, fcap {w}, word ops {work}; kernel {k2_ms:.3f} ms, "
        f"plain {k2_plain_ms:.3f} ms, bound {k2_bound:.4f} ms ({k2_by})")

    def simulator(decoder_cls, p, batch, seed, **kw):
        probs = np.full(n, 2 * p / 3)
        dx = decoder_cls(code.hz, probs, 50, device=dev, **kw)
        dz = decoder_cls(code.hx, probs, 50, device=dev, **kw)
        return CodeSimulator_DataError(
            code=code, decoder_x=dx, decoder_z=dz,
            pauli_error_probs=[p / 3] * 3, seed=seed, batch_size=batch,
            scan_chunk=8, device=dev)

    def wer_phase(tag, sim, n_batches):
        reads0 = (tbp.bp_decode_two_phase.host_reads, decode_device.host_reads)
        torch.cuda.synchronize()
        t = time.time()
        wer, eb = sim.WordErrorRate(n_batches * sim.batch_size)
        dt = time.time() - t
        reads = (tbp.bp_decode_two_phase.host_reads - reads0[0],
                 decode_device.host_reads - reads0[1])
        log(f"[{tag}] failures {sim.last_failures} shots {sim.last_shots} "
            f"WER {wer:.6e} +- {eb:.3e} min_w {sim.min_logical_weight} "
            f"{sim.last_shots / dt:.1f} shots/s ({dt:.2f} s); host reads: "
            f"two-phase {reads[0]}, OSD tier {reads[1]}, megabatch "
            f"{sim.last_megabatches}")

    # 5-6. the main path, counts reset just before and read just after
    bp_minsum.launches = 0
    tod.osd_elim.launches = 0
    wer_phase("5 BP p=0.01", simulator(BPDecoder, 0.01, 4096, SEED), 16)
    l5 = bp_minsum.launches
    wer_phase("6 BPOSD p=0.05", simulator(
        BPOSD_Decoder, 0.05, 2048, SEED, osd_method="osd_e", osd_order=10), 8)
    launches = {"bp_minsum": bp_minsum.launches, "osd_elim": tod.osd_elim.launches}
    log(f"[5-6] main-path launches {launches} (bp_minsum {l5} in phase 5)")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched on the main path")

    # 7. anchors
    sim0 = simulator(BPOSD_Decoder, 0.0, 2048, SEED, osd_method="osd_e",
                     osd_order=10)
    sim0.WordErrorRate(2 * 2048)
    if sim0.last_failures != 0:
        raise AssertionError(f"{sim0.last_failures} failures at p=0")
    log(f"[7] p=0: 0 failures in {sim0.last_shots} shots")
    sim_k = simulator(BPOSD_Decoder, 0.05, 2048, SEED + 1, osd_method="osd_e",
                      osd_order=10)
    sim_p = simulator(BPOSD_Decoder, 0.05, 2048, SEED + 1, osd_method="osd_e",
                      osd_order=10)
    sim_k.WordErrorRate(2048)
    t = time.time()
    with _kernels.force_plain():
        sim_p.WordErrorRate(2048)
    dt_plain = time.time() - t
    if (sim_k.last_failures, sim_k.min_logical_weight) != (
            sim_p.last_failures, sim_p.min_logical_weight):
        raise AssertionError(
            f"kernel path {sim_k.last_failures}/{sim_k.min_logical_weight} vs "
            f"plain path {sim_p.last_failures}/{sim_p.min_logical_weight}")
    log(f"[7] one BPOSD batch, kernels vs plain on the card: failures "
        f"{sim_k.last_failures} == {sim_p.last_failures}, min_w "
        f"{sim_k.min_logical_weight} == {sim_p.min_logical_weight} "
        f"(plain path {dt_plain:.2f} s)")
    Bs = 64
    e_small = (rng.random((Bs, n)) < 2 * p1 / 3).astype(np.uint8)
    s_small = (e_small @ hx.T % 2).astype(np.uint8)
    probs = np.full(n, 2 * p1 / 3)
    out_gpu = BPOSD_Decoder(hx, probs, 50, device=dev).decode_batch(s_small)
    out_cpu = BPOSD_Decoder(hx, probs, 50, device="cpu").decode_batch(s_small)
    if not ((out_gpu @ hx.T % 2) == s_small).all():
        raise AssertionError("card BPOSD corrections miss their syndromes")
    cost = np.log((1 - probs) / probs)
    same = (out_gpu == out_cpu).all(axis=1)
    tied = np.abs(out_gpu @ cost - out_cpu @ cost) < 1e-4
    if not (same | tied).all():
        raise AssertionError("card and CPU BPOSD disagree beyond cost ties")
    log(f"[7] {Bs} BPOSD shots, card vs CPU: {int(same.sum())} identical, "
        f"{int((~same & tied).sum())} cost-tied, all syndrome-consistent")

    # 8. the kernels line
    kernels = [
        {"name": "bp_minsum", "route": "cuda",
         "source": f"{PKG}/csrc/bp_minsum.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/bp_pallas.py:740",
         "launches": launches["bp_minsum"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "osd_elim", "route": "cuda",
         "source": f"{PKG}/csrc/osd_elim.cu",
         "replaces": "qldpc_fault_tolerance_tpu/ops/osd_device.py:547",
         "launches": launches["osd_elim"], "max_abs_err": float(k2_err),
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
