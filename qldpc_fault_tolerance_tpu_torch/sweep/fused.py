"""Fused sweep execution: every p of a code in one program, buckets
pipelined (the JAX package's ``sweep/fused.py``).

The serial grid loop (``sweep/family.py``) runs one (code, p, logical type)
cell at a time, each building its decoders and engine and capturing its own
graph.  Here every cell of a code forms one shape bucket: one
representative engine (cell 0's) is built, the other cells' p-dependent
decoder state comes from the factories' ``GetDecoderState``, and the
bucket runs as one ``parallel.shots.CellFusedDriver`` program
(``sim/data_error.fused_cells_program``, ``sim/phenom.
fused_cells_program``): on the card one captured graph a bucket, one host
read for the whole bucket, or one a megabatch when streaming.

  * ``target_failures``: cells that reached the target hand their lanes to
    the undecided cells (``sim.common.fused_cell_adaptive``);
  * with a checkpoint, each drained megabatch saves the bucket's per-cell
    cursors, so a killed sweep resumes inside the bucket, and finished
    cells are stored under the serial loop's keys (the two interchange);
  * otherwise buckets pipeline: bucket b's run is enqueued and b + 1 is
    built (its graph captured) before b is read
    (``parallel.shots.drain_double_buffered``).

Every cell draws its serial run's stream, so its counts are the serial
loop's seed for seed.  With a ``mesh`` every bucket runs sharded over its
devices (``parallel.shots.MeshCellFusedDriver``), each cell then the
serial mesh run's seed for seed.  A bucket that cannot fuse (a decoder
without a device program, the fused sampler, statics that differ across
its p) runs in the serial loop, counted in
``sweep.fused_fallback_cells``.
"""
from __future__ import annotations

import time

import torch

__all__ = ["FusedUnsupported", "eval_cells_fused", "build_data_bucket"]


class FusedUnsupported(Exception):
    """A bucket (or grid) cannot run on the fused path; run it serially."""


def build_data_bucket(rep, bucket, decoder_class, params_fn,
                      eval_logical_type, num_samples, mesh=None):
    """The data bucket builder of both families: the representative engine
    ``rep`` (cell 0, built by the caller) and the other cells' decoder
    states from ``decoder_class.GetDecoderState(params_fn(eval_p,
    sector))`` (sector ``"x"`` or ``"z"``).  When those states share all
    but their p-dependent leaves with the representative's (the library
    classes' do), the per-cell leaves are stacked straight into its state
    (``sim.common.stack_from_overrides``); otherwise every leaf is
    compared (``stack_cell_states``).  Raises ValueError when the cells'
    statics differ."""
    from ..sim.common import (
        CELL_LEAVES,
        LTYPE_CODES,
        stack_from_overrides,
        states_share_but_llr,
    )
    from ..sim.data_error import fused_cells_program_states

    base = rep._cell_state()
    cells = {"dx": [base["dx"]], "dz": [base["dz"]]}
    probs = [base["probs"]]
    statics = {"dx": rep.decoder_x.device_static,
               "dz": rep.decoder_z.device_static}
    for _, _, _, eval_p in bucket[1:]:
        for sector, name in (("x", "dx"), ("z", "dz")):
            static, state = decoder_class.GetDecoderState(
                params_fn(eval_p, sector))
            if static != statics[name]:
                raise ValueError(
                    "decoder statics differ across the bucket's p-points")
            cells[name].append(state)
        p = eval_p * 3 / 2
        probs.append(torch.tensor([p / 3] * 3, dtype=torch.float32,
                                  device=rep.device))
    tags = [float(eval_p) for _, _, _, eval_p in bucket]
    lt = [LTYPE_CODES[eval_logical_type]] * len(bucket)
    if all(states_share_but_llr(cells[k][0], d)
           for k in cells for d in cells[k]):
        over = {(k, leaf): torch.stack([d[leaf] for d in cells[k]])
                for k in cells for leaf in CELL_LEAVES if leaf in base[k]}
        over[("probs",)] = torch.stack(probs)
        return fused_cells_program_states(
            rep, None, lt, tags, num_samples, mesh=mesh,
            prestacked=stack_from_overrides(base, over))
    states = [{"probs": pr, "dx": dx, "dz": dz}
              for pr, dx, dz in zip(probs, cells["dx"], cells["dz"])]
    return fused_cells_program_states(rep, states, lt, tags, num_samples,
                                      mesh=mesh)


def _devices(prog) -> list:
    """The distinct CUDA devices a bucket's program runs on."""
    driver = prog.driver
    devs = getattr(driver, "devices", (driver.device,))
    return [dev for dev in dict.fromkeys(devs) if dev.type == "cuda"]


def _bucket_progress_key(cell_keys: list[dict]) -> dict:
    """Checkpoint key of a fused bucket's mid-run progress records: the
    first cell's identity plus the full p-list, so a changed remainder
    (some cells already finished) keys a fresh cursor while finished-cell
    records stay shared with the serial path."""
    head = dict(cell_keys[0])
    head["fused_cells"] = [ck["p"] for ck in cell_keys]
    return head


def _record_cell(cell_key: dict, wer: float, failures: int,
                 shots: int) -> dict:
    """The serial loop's per-cell bookkeeping (one structured log line,
    a ``cell_done`` event, the sweep run's record) for a fused cell, plus
    the fused counter.  Returns the uncertainty block (empty with
    diagnostics off) for the checkpoint record."""
    from ..utils import diagnostics, telemetry
    from ..utils.observability import get_logger, log_record

    ci = diagnostics.ci_fields(failures, shots) if diagnostics.active() \
        else {}
    log_record(get_logger(), "cell_done", **cell_key, wer=float(wer), **ci)
    telemetry.event("cell_done", **cell_key, wer=float(wer), **ci)
    diagnostics.record_cell(cell_key, float(wer), ci)
    telemetry.count("sweep.cells")
    telemetry.count("sweep.fused_cells")
    return ci


def eval_cells_fused(cells, bucket_builder, cell_key_fn, *,
                     checkpoint=None, progress_every: int = 1,
                     target_failures=None, mesh=None):
    """Run a sweep grid on the fused path.

    ``cells``: ``(index, ci, code, eval_p)`` in grid order; consecutive
    cells of one ``ci`` form a bucket.  ``bucket_builder(bucket, mesh)``:
    the bucket's ``sim.common.FusedCellProgram`` (sharded over ``mesh``, a
    ``parallel.shots.ShotMesh``, when it is given); it raises ValueError
    when the bucket cannot fuse.  ``cell_key_fn(index, ci, code,
    eval_p)``: the cell's checkpoint key, the serial loop's.

    Returns ``(results, leftovers)``: ``{index: wer}`` for every cell that
    ran (or was checkpointed), and the cells of unfusable buckets for the
    caller's serial loop.  ``eval_cells_fused.buckets`` lists each fused
    bucket's run: its cells, megabatches, host reads, captured graphs and
    their nodes, build seconds, and on the card the peak device memory
    allocated while it was built and launched (``peak_gib``, the largest
    of its devices', and per device in ``peak_gib_devices``)."""
    from ..parallel.shots import drain_double_buffered
    from ..sim import common as simc
    from ..utils import diagnostics, resilience, telemetry
    from ..utils.checkpoint import CellProgress

    results: dict[int, float] = {}
    leftovers: list[tuple] = []
    runs: list[dict] = []
    eval_cells_fused.buckets = runs

    buckets: list[list[tuple]] = []
    for item in cells:
        index, ci, _, _ = item
        if checkpoint is not None and (
                rec := checkpoint.get(cell_key_fn(*item))):
            results[index] = rec["wer"]
            diagnostics.record_cell(
                cell_key_fn(*item), rec["wer"],
                {k: rec[k] for k in diagnostics.CI_KEYS if k in rec})
            continue
        if buckets and buckets[-1][0][1] == ci:
            buckets[-1].append(item)
        else:
            buckets.append([item])

    streaming = (checkpoint is not None and progress_every) \
        or target_failures is not None

    def build(bucket):
        """(bucket, program, run record), or None when it runs serially."""
        t0 = time.perf_counter()
        try:
            prog = bucket_builder(bucket, mesh)
        except ValueError as e:
            telemetry.count("sweep.fused_fallback_cells", len(bucket))
            telemetry.event("fused_fallback", reason=str(e),
                            cells=len(bucket))
            leftovers.extend(bucket)
            return None
        for dev in _devices(prog):
            torch.cuda.reset_peak_memory_stats(dev)
        telemetry.count("sweep.fused_buckets")
        prog.cell_keys = [cell_key_fn(*it) for it in bucket]
        run = {"cells": len(bucket), "build_s": time.perf_counter() - t0}
        runs.append(run)
        return bucket, prog, run

    def close(bucket, prog, run, failures, shots):
        driver = prog.driver
        run.update(megabatches=driver.megabatches,
                   host_reads=driver.host_reads, graphs=len(driver._graphs),
                   nodes=(driver.graph_stats or {}).get("nodes"),
                   capture_s=(driver.graph_stats or {}).get("capture_s"))
        for lane, item in enumerate(bucket):
            cell_key = cell_key_fn(*item)
            wer = float(prog.wer_fn(failures[lane], shots[lane])[0])
            ci = _record_cell(cell_key, wer, int(failures[lane]),
                              int(shots[lane]))
            if checkpoint is not None:
                checkpoint.put(cell_key, {"wer": wer, **ci})
            results[item[0]] = wer
        # the bucket's graph and its memory go now, not when the garbage
        # collector reaches the program
        prog.release()

    def peak(run, prog):
        gib = {str(dev): torch.cuda.max_memory_allocated(dev) / 2 ** 30
               for dev in _devices(prog)}
        if gib:
            run["peak_gib"] = max(gib.values())
            run["peak_gib_devices"] = gib

    if not streaming:
        def launch(bucket):
            built = build(bucket)
            if built is None:
                return None
            bucket, prog, run = built
            pending = resilience.run_cell(
                lambda: simc.fused_cell_launch(prog)[0], label="cell:fused")
            peak(run, prog)
            return bucket, prog, run, pending

        def finish(launched):
            if launched is None:
                return
            bucket, prog, run, pending = launched
            failures, shots, _ = simc.fused_cell_finish(pending)
            close(bucket, prog, run, failures, shots)

        for _ in drain_double_buffered(launch, finish, buckets):
            pass
        return results, leftovers

    # streaming (mid-bucket progress and/or adaptive reallocation): one
    # host read a megabatch for the whole bucket, buckets in turn
    for bucket in buckets:
        built = build(bucket)
        if built is None:
            continue
        bucket, prog, run = built
        progress = None
        if checkpoint is not None and progress_every:
            progress = CellProgress(
                checkpoint,
                _bucket_progress_key([cell_key_fn(*it) for it in bucket]),
                every=progress_every)

        def run_bucket(prog=prog, progress=progress):
            if target_failures is not None:
                return simc.fused_cell_adaptive(
                    prog, target_failures=int(target_failures),
                    progress=progress)
            return simc.fused_cell_stream(prog, progress=progress)

        host = resilience.run_cell(run_bucket, label="cell:fused")
        peak(run, prog)
        close(bucket, prog, run, host[0], host[1])
    return results, leftovers


eval_cells_fused.buckets = []
