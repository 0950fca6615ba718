"""Shared Monte-Carlo helpers of the simulators."""
from __future__ import annotations

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..ops.linalg import gf2_matmul
from ..ops.prng import key_words, split_key
from ..parallel.shots import count_min_driver
from ..utils import diagnostics

__all__ = ["wer_single_shot", "wer_per_cycle", "ShotBatcher",
           "dense_check_flags", "select_failures", "decoder_key",
           "megabatch_driver", "release_graphs", "run_signature",
           "resumable_stream",
           "count_failures", "st_round_counts", "st_window_count"]


def wer_single_shot(error_count: int, num_run: int, K: int):
    """WER + error bar for single-shot decoding."""
    logical_error_rate = error_count / num_run
    logical_error_rate_eb = np.sqrt(
        (1 - logical_error_rate) * logical_error_rate / num_run
    )
    word_error_rate = 1.0 - (1 - logical_error_rate) ** (1 / K)
    word_error_rate_eb = (
        logical_error_rate_eb * ((1 - logical_error_rate_eb) ** (1 / K - 1)) / K
    )
    return word_error_rate, word_error_rate_eb


def wer_per_cycle(error_count: int, num_samples: int, K: int, num_cycles: int):
    """Per-qubit-per-cycle WER + error bar (reference
    ``src/Simulators.py:334-362``), as the JAX package computes it.

    The inversion of (1 - 2P)^(1/cycles) takes its second branch above a
    per-qubit rate of 1/2, for any cycle count (the published notebooks
    sweep even counts, which the current reference's assert forbids).  The
    error bar is the notebook-era one: the binomial error of the per-cycle
    logical rate, then the (1 - eb)^(1/K - 1) / K factor of
    ``wer_single_shot``; the inversion base is clamped at 0 above a total
    rate of 1/2, where the reference's expression turns complex."""
    logical_error_rate = error_count / num_samples
    per_qubit = 1.0 - (1 - logical_error_rate) ** (1 / K)
    if per_qubit <= 0.5:
        wer = (1.0 - (1 - 2 * per_qubit) ** (1 / num_cycles)) / 2
    else:
        wer = (1.0 + (-1 + 2 * per_qubit) ** (1 / num_cycles)) / 2
    per_cycle = (1.0 - max(1 - 2 * logical_error_rate, 0.0)
                 ** (1 / num_cycles)) / 2
    per_cycle_eb = np.sqrt(max((1 - per_cycle) * per_cycle, 0.0) / num_samples)
    wer_eb = per_cycle_eb * ((1 - per_cycle_eb) ** (1 / K - 1)) / K
    return wer, wer_eb


def dense_check_flags(res_x, res_z, hz_t, hx_t, lz_t, lx_t, n: int, *,
                      z_weight_excludes_stab: bool = False):
    """Residual stabilizer/logical checks on unpacked (B, n) uint8 planes
    (``packed=False``; the same bits as ``packed_residual_stats``).  The
    ``*_t`` are (n, k) {0,1} transposes.  Returns per-shot ``(x_fail,
    z_fail)`` bool and the int32 minimum residual weight among logical
    failures (of the Z residuals whose stabilizer check passed with
    ``z_weight_excludes_stab``, the phenom engine's convention)."""
    x_stab, x_log, z_stab, z_log = (gf2_matmul(r, h_t).bool().any(dim=-1)
                                    for r, h_t in ((res_x, hz_t), (res_x, lz_t),
                                                   (res_z, hx_t), (res_z, lx_t)))
    z_counted = z_log & ~z_stab if z_weight_excludes_stab else z_log
    wx = torch.where(x_log, res_x.sum(dim=-1, dtype=torch.int32), n)
    wz = torch.where(z_counted, res_z.sum(dim=-1, dtype=torch.int32), n)
    min_w = torch.minimum(wx.min(), wz.min()).to(torch.int32)
    return x_stab | x_log, z_stab | z_log, min_w


def select_failures(x_fail, z_fail, eval_type: str):
    """The per-shot failures of ``eval_type`` ("X", "Z" or "Total")."""
    if eval_type == "X":
        return x_fail
    if eval_type == "Z":
        return z_fail
    return x_fail | z_fail


class ShotBatcher:
    """Splits a shot budget into batches of one fixed size.

    The trailing partial batch runs at full size and the surplus shots are
    counted in (they are i.i.d., so extra samples only tighten the
    estimate)."""

    def __init__(self, num_shots: int, batch_size: int):
        self.batch_size = int(batch_size)
        self.num_batches = max(1, -(-int(num_shots) // self.batch_size))

    @property
    def total(self) -> int:
        return self.num_batches * self.batch_size


def decoder_key(dec) -> tuple:
    """What a captured batch bakes in of a decoder: the object (held, so
    its id is not reused), its program and its state tensors' addresses."""
    leaves = pytree.tree_leaves(dec.device_state)
    return (dec, dec.device_static, tuple(
        t.data_ptr() if isinstance(t, torch.Tensor) else t for t in leaves))


def megabatch_driver(sim, chunk: int, program: tuple, stats_fn,
                     batch_input):
    """``sim``'s megabatch driver of ``chunk`` batches per megabatch over
    ``stats_fn``, kept in ``sim._drivers`` (its captured graphs with it) as
    long as ``program``, what a batch bakes in, is unchanged."""
    key = (chunk, *program)
    driver = sim._drivers.get(key)
    if driver is None:
        driver = sim._drivers[key] = count_min_driver(
            stats_fn, sim.N, sim.device, chunk, batch_input)
    return driver


def release_graphs(sim) -> None:
    """Drop ``sim``'s megabatch drivers and the CUDA graphs they captured.
    A driver's batch function is a method of ``sim``, so the two hold each
    other until the garbage collector runs; a loop over many simulators
    (a sweep's cells) frees each one's graph memory here, at once.  A
    later run of ``sim`` captures again."""
    sim._drivers.clear()


def run_signature(engine: str, key, **fields) -> dict:
    """Identity of a megabatch shot stream, stored with mid-cell progress
    records (``utils.checkpoint.CellProgress``): the key words plus the
    batch layout.  A resume is honoured only when it matches — resuming a
    cursor under another stream would silently change the estimate."""
    return {"engine": engine, "key": [int(w) for w in key_words(key)],
            **fields}


def resumable_stream(driver, key, n_batches, extra, *, signature, progress,
                     min_init):
    """The mid-cell resume protocol of the megabatch engines, as the JAX
    package's: ``driver.run_keys`` with its cursor loaded from and saved
    to a ``utils.checkpoint.CellProgress``.

    Returns ``((carry, batches_done), stream)``: the initial host carry —
    the persisted one on resume, ``(0, min_init)`` fresh — and an iterator
    of ``(carry, done)`` per drained megabatch that saves the cursor as it
    yields.  The cursor is honoured only when ``signature``
    (``run_signature``) matches; telemetry is not part of that identity
    (the port's carry holds no telemetry)."""
    start, carry0 = 0, None
    state = progress.load(signature) if progress is not None else None
    if state:
        start = int(state["batches_done"])
        carry0 = (int(state["failures"]), int(state["min_w"]))
    initial = carry0 if state else (0, int(min_init))

    def stream():
        for carry, done in driver.run_keys(key_words(key), n_batches, *extra,
                                           start=start, carry0=carry0):
            if progress is not None:
                progress.save(signature, batches_done=done,
                              failures=int(carry[0]), min_w=int(carry[1]))
            yield carry, done

    return (initial, start), stream()


def count_failures(sim, num_samples: int, key=None, target_failures=None,
                   *extra, progress=None):
    """One run of ``sim``: ``num_samples`` shots in batches of
    ``sim.batch_size``, ``sim._scan_chunk`` per megabatch, drained from
    ``sim._driver(chunk)`` (``extra`` goes to every batch).  Without
    ``key`` the run splits ``sim``'s base key.  With ``target_failures``
    the run stops after the first megabatch whose cumulative failure count
    reaches it; the shots actually run are the denominator.  With
    ``progress`` (a ``utils.checkpoint.CellProgress``) the cursor persists
    after every megabatch, and a run whose cursor was saved resumes from
    it, seed for seed what the unbroken run gives (``resumable_stream``).
    Records on ``sim`` the run's failures and shots, the megabatches it
    counted (one more may have been launched), its host reads and its
    capture, and folds its min weight into ``min_logical_weight``; with
    diagnostics active, reports the counts to an enclosing sweep cell
    (``utils.diagnostics.note_run``); returns ``(failures, shots run)``."""
    if key is None:
        sim._base_key, key = split_key(sim._base_key)
    batcher = ShotBatcher(num_samples, sim.batch_size)
    chunk = min(batcher.num_batches, sim._scan_chunk)
    n_batches = -(-batcher.num_batches // chunk) * chunk
    driver = sim._driver(chunk)
    reads = driver.host_reads
    signature = run_signature(type(sim).__name__, key,
                              batch_size=sim.batch_size, chunk=chunk,
                              n_batches=n_batches,
                              extra=[repr(e) for e in extra])
    ((failures, min_w), start), stream = resumable_stream(
        driver, key, n_batches, extra, signature=signature,
        progress=progress, min_init=sim.N)

    def hit(f):
        return target_failures is not None and f >= int(target_failures)

    # a resumed cursor may already sit past the early stop (killed between
    # the crossing megabatch's save and the cell's record): stopping here
    # returns what the unbroken run returned
    done = start
    if not hit(failures):
        for (failures, min_w), done in stream:
            if hit(failures):
                break
    sim.last_megabatches = (done - start) // driver.k_inner
    sim.last_host_reads = driver.host_reads - reads
    sim.last_graph = driver.graph_stats
    sim.last_failures, sim.last_shots = failures, done * sim.batch_size
    sim.min_logical_weight = min(sim.min_logical_weight, min_w)
    if diagnostics.active():
        diagnostics.note_run(failures, sim.last_shots)
    return failures, sim.last_shots


def st_round_counts(num_cycles: int, num_rep: int) -> tuple[int, int]:
    """Phenomenological space-time round bookkeeping, as the JAX package
    computes it: how many windowed rounds cover ``num_cycles`` noisy cycles
    (final perfect cycle included), and how many cycles those rounds
    realize.  Integer arithmetic (the reference's float division drifts for
    large cycle counts)."""
    num_cycles = int(num_cycles)
    num_rep = int(num_rep)
    if num_cycles < 1 or num_rep < 1:
        raise ValueError(
            f"need num_cycles >= 1 and num_rep >= 1, got "
            f"num_cycles={num_cycles}, num_rep={num_rep}")
    num_rounds = (num_cycles - 1) // num_rep + 1
    total_num_cycles = (num_rounds - 1) * num_rep + 1
    return num_rounds, total_num_cycles


def st_window_count(num_cycles: int, num_rep: int) -> int:
    """Circuit-level space-time window count: ``num_cycles`` holds
    ``num_rounds`` windows of ``num_rep`` noisy cycles plus one final
    perfect cycle, so ``num_cycles - 1`` must divide evenly (the
    reference's float assert lets a non-multiple slip for num_rep > 100)."""
    num_cycles = int(num_cycles)
    num_rep = int(num_rep)
    if num_cycles < 1 or num_rep < 1:
        raise ValueError(
            f"need num_cycles >= 1 and num_rep >= 1, got "
            f"num_cycles={num_cycles}, num_rep={num_rep}")
    num_rounds, rem = divmod(num_cycles - 1, num_rep)
    if rem:
        raise ValueError(
            f"num_cycles - 1 must be a multiple of num_rep "
            f"(got num_cycles={num_cycles}, num_rep={num_rep}, "
            f"remainder {rem})")
    return num_rounds
