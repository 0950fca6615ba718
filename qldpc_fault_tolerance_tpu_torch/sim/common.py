"""Shared Monte-Carlo helpers of the simulators.

Besides the serial run's helpers, the JAX package's two families of
``sim/common.py`` helpers:

  * the cell-fused sweep's (``LTYPE_CODES`` to ``fused_cell_adaptive``):
    a bucket of same-shape cells (one code, many p) runs as one
    ``parallel.shots.CellFusedDriver`` program.  The port's lane unit is
    the serial cell's own batch unit, run once per lane on a ``lane_view``
    of the bucket's representative engine whose p-dependent leaves (priors,
    channel probabilities) are gathered from the cells' stacked states by
    the lane's device cell index;
  * the weighted (importance-sampled) runs' (``check_tilt_probs`` to
    ``drive_weighted_run``): the carry gains the weight moments
    ``(s1, s2, w1, w2)`` and ``WeightedStats`` holds them on the host;
  * the shot mesh's (``replicate`` to ``degrade_mesh``): an engine built
    with ``mesh=`` runs every mesh device's share of the shots on its own
    replica of the engine (``mesh_batch_stats``), one captured megabatch
    graph per device, and folds the devices' host reads;
  * the resilience layer's (``resilient_engine_run``,
    ``engine_ladder_step``, ``windowed_count``): every engine run under the
    active ``utils.resilience`` policy behind a fault site, its
    degradation ladder (rungs that stay on the card's kernels: the fused
    sampler's v2 -> v1, packed -> dense), the host-assisted (host OSD)
    batch loop, and the mesh's ``mesh_replan`` rung stepped on a device
    fault;
  * the run record's (``tele_stats``, ``record_wer_run``,
    ``joint_kernel_variant``, ``joint_osd_backend``): with telemetry on,
    the data and phenom engines' batch units (serial, mesh, weighted and
    fused) return the batch's device telemetry vector
    (``utils.telemetry.device_tele_vec``) as a last element, the carry
    sums it and the run's host read brings it back (telemetry off: the
    units, carries and captured graphs of a run without it); every
    engine's run ends in ``record_wer_run`` (the ``sim.*`` counters, one
    ``wer_run`` and one ``heartbeat`` event with the run's waterfall,
    ``utils.profiling``).
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import math
import time
import types

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..decoders.bp_decoders import decode_device
from ..ops.linalg import gf2_matmul
from ..ops.prng import key_words, split_key
from ..parallel.shots import (
    MegabatchDriver,
    cell_fused_driver,
    check_mesh,
    count_min_driver,
    drain_double_buffered,
    replay_fold,
    tele_zeros,
)
from ..utils import diagnostics, faultinject, profiling, resilience, telemetry
from ..utils.device import canonical

__all__ = ["wer_single_shot", "wer_per_cycle", "ShotBatcher",
           "dense_check_flags", "select_failures", "decoder_key",
           "megabatch_driver", "release_graphs", "run_signature",
           "resumable_stream",
           "count_failures", "st_round_counts", "st_window_count",
           "LTYPE_CODES", "CELL_LEAVES", "LaneDecoder", "lane_view",
           "stack_cell_states", "states_share_but_llr",
           "stack_from_overrides", "gather_lane_states", "FusedCellProgram",
           "bucket_layout", "bucket_driver",
           "tags_json", "plan_lanes", "fused_cell_launch", "fused_cell_finish",
           "fused_cell_stream", "fused_cell_adaptive",
           "check_tilt_probs", "weight_moments", "weighted_unit",
           "WeightedStats",
           "wer_single_shot_weighted", "wer_per_cycle_weighted",
           "weighted_driver", "resumable_weighted_stream",
           "drive_weighted_run", "replicate", "mesh_replica",
           "mesh_batch_stats", "degrade_mesh", "refuse_mesh",
           "resilient_engine_run", "engine_ladder_step", "windowed_count",
           "needs_host", "launch_decode", "finish_decode", "tele_stats",
           "SimResult", "accumulate_device", "accumulate_counts",
           "timed_host_sync", "key_bytes",
           "tele_on", "record_wer_run", "record_engine_run",
           "joint_kernel_variant", "joint_osd_backend"]


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
    """The per-shot failures of ``eval_type`` ("X", "Z" or "Total"), or for
    "ALL" the (B, 3) flags of all three (a fused sweep lane's)."""
    if eval_type == "X":
        return x_fail
    if eval_type == "Z":
        return z_fail
    if eval_type == "ALL":
        return torch.stack([x_fail, z_fail, x_fail | z_fail], dim=-1)
    return x_fail | z_fail


@dataclasses.dataclass
class SimResult:
    """Structured result record (the reference prints these)."""

    failures: int
    num_samples: int
    wer: float
    wer_eb: float | None
    extra: dict = dataclasses.field(default_factory=dict)


def accumulate_device(step_fn, keys, combine):
    """Fold ``step_fn(key)`` outputs with ``combine`` on the device, with
    no host read (the caller reads the result once).  None for no keys."""
    acc = None
    for k in keys:
        out = step_fn(k)
        acc = out if acc is None else combine(acc, out)
    return acc


def accumulate_counts(count_fn, keys) -> int:
    """The sum of ``count_fn(key)``'s device counts over ``keys`` with one
    host read at the end, watchdog-guarded (``resilience.guarded_fetch``):
    the ``device_dispatch`` and ``device_sync`` stage timers, the
    dispatch and host-read waterfall, and ``driver.dispatches``, as in the
    JAX package."""
    from ..utils.observability import stage_timer

    keys = list(keys)
    with stage_timer("device_dispatch"):
        t0 = time.perf_counter()
        total = accumulate_device(count_fn, keys, lambda a, b: a + b)
        profiling.record_dispatch(time.perf_counter() - t0)
    telemetry.count("driver.dispatches", len(keys))
    if total is None:
        return 0
    with stage_timer("device_sync"):
        return timed_host_sync(lambda: resilience.guarded_fetch(
            lambda: int(total), label="device_sync"))


def timed_host_sync(fn):
    """Run a blocking device-to-host read ``fn()`` and record its wall
    clock as ``host_sync`` time in the active profiling scope."""
    t0 = time.perf_counter()
    out = fn()
    profiling.record_host_sync(time.perf_counter() - t0)
    return out


def key_bytes(key) -> np.ndarray:
    """The uint32 words of a key (``ops.prng``: two 32-bit words)."""
    return np.asarray(key_words(key), dtype=np.uint32)


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


def tele_on(sim) -> bool:
    """Whether ``sim``'s runs carry the device telemetry vector now:
    telemetry enabled and an engine that threads it (the data and phenom
    engines, ``_DEVICE_TELE``, as in the JAX package)."""
    return telemetry.enabled() and getattr(sim, "_DEVICE_TELE", False)


def tele_stats(stats_fn, device):
    """``stats_fn`` with the batch's device telemetry vector appended to
    its outputs: the decodes it runs note their aux
    (``telemetry.note_device_aux``), folded by ``device_tele_vec``."""

    @functools.wraps(stats_fn)
    def stats(*args):
        with telemetry.collect_device_aux() as aux:
            out = stats_fn(*args)
        return (*out, telemetry.device_tele_vec(aux, device))

    return stats


def megabatch_driver(sim, chunk: int, program: tuple, stats_fn,
                     batch_input, tele: bool = False):
    """``sim``'s megabatch driver of ``chunk`` batches per megabatch over
    ``stats_fn``, kept in ``sim._drivers`` (its captured graphs with it) as
    long as ``program``, what a batch bakes in, is unchanged.  A mesh
    replica (``mesh_replica``) draws its slot's stream.  ``tele`` (part of
    the key) carries the device telemetry vector (``tele_stats``)."""
    key = (chunk, *program) + (("tele",) if tele else ())
    driver = sim._drivers.get(key)
    if driver is None:
        slot = getattr(sim, "_mesh_slot", None)
        if slot is not None:
            batch_input = batch_input.on_slot(slot)
        if tele:
            stats_fn = tele_stats(stats_fn, sim.device)
        driver = sim._drivers[key] = count_min_driver(
            stats_fn, sim.N, sim.device, chunk, batch_input, tele=tele)
    return driver


def _engine_driver(sim, chunk: int, tele: bool):
    """``sim._driver(chunk)``, with the telemetry slot when ``tele``."""
    return sim._driver(chunk, tele=True) if tele else sim._driver(chunk)


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
    return {"engine": engine, "key": key_bytes(key).tolist(), **fields}


def resumable_stream(driver, key, n_batches, extra, *, signature, progress,
                     min_init, tele_on: bool = False):
    """The mid-cell resume protocol of the megabatch engines, as the JAX
    package's: ``driver.run_keys`` with its cursor loaded from and saved
    to a ``utils.checkpoint.CellProgress``.

    Returns ``((carry, batches_done), stream)``: the initial host carry —
    the persisted one on resume, ``(0, min_init)`` fresh — and an iterator
    of ``(carry, done)`` per drained megabatch that saves the cursor as it
    yields.  The cursor is honoured only when ``signature``
    (``run_signature``) matches; telemetry is not part of that identity:
    with ``tele_on`` the carry's telemetry vector persists in the cursor's
    ``"tele"`` and seeds a resumed run's (zeros when a run saved without
    it), as in the JAX package."""
    start, carry0 = 0, None
    state = progress.load(signature) if progress is not None else None
    if state:
        start = int(state["batches_done"])
        carry0 = (int(state["failures"]), int(state["min_w"]))
        if tele_on:
            carry0 += (state.get("tele") or [0] * telemetry.TELE_LEN,)
    initial = carry0 if state else (0, int(min_init))

    def stream():
        for carry, done in driver.run_keys(key_words(key), n_batches, *extra,
                                           start=start, carry0=carry0):
            if progress is not None:
                progress.save(signature, batches_done=done,
                              failures=int(carry[0]), min_w=int(carry[1]),
                              tele=carry[2] if len(carry) > 2 else None)
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
    (``utils.diagnostics.note_run``); with telemetry on (``tele_on``) the
    carry also sums the device telemetry vector, published at the run's
    last read; returns ``(failures, shots run)``.
    An engine with a mesh runs ``mesh_batch_stats`` instead (no
    ``target_failures``, no cursor)."""
    if getattr(sim, "_mesh", None) is not None:
        if target_failures is not None:
            raise ValueError(
                "target_failures early stopping requires the single-device "
                "path (no mesh)")
        if key is None:
            sim._base_key, key = split_key(sim._base_key)
        return mesh_batch_stats(sim, num_samples, key, *extra)
    if key is None:
        sim._base_key, key = split_key(sim._base_key)
    batcher = ShotBatcher(num_samples, sim.batch_size)
    chunk = min(batcher.num_batches, sim._scan_chunk)
    n_batches = -(-batcher.num_batches // chunk) * chunk
    tele = tele_on(sim)
    driver = _engine_driver(sim, chunk, tele)
    reads = driver.host_reads
    signature = run_signature(type(sim).__name__, key,
                              batch_size=sim.batch_size, chunk=chunk,
                              n_batches=n_batches,
                              extra=[repr(e) for e in extra])
    (carry, start), stream = resumable_stream(
        driver, key, n_batches, extra, signature=signature,
        progress=progress, min_init=sim.N, tele_on=tele)

    def hit(f):
        return target_failures is not None and f >= int(target_failures)

    # a resumed cursor may already sit past the early stop (killed between
    # the crossing megabatch's save and the cell's record): stopping here
    # returns what the unbroken run returned
    done = start
    if not hit(carry[0]):
        for carry, done in stream:
            if hit(carry[0]):
                break
    failures, min_w = carry[0], carry[1]
    if len(carry) > 2:
        telemetry.publish_device_tele(carry[2])
    sim.last_megabatches = (done - start) // driver.k_inner
    sim.last_dispatches = sim.last_megabatches
    sim.last_host_reads = driver.host_reads - reads
    sim.last_graph = driver.graph_stats
    sim.last_failures, sim.last_shots = failures, done * sim.batch_size
    sim.min_logical_weight = min(sim.min_logical_weight, min_w)
    if diagnostics.active():
        diagnostics.note_run(failures, sim.last_shots)
    return failures, sim.last_shots


# ---------------------------------------------------------------------------
# The shot mesh: an engine's replicas and its sharded shot loop
# ---------------------------------------------------------------------------
_PORT = __name__.split(".")[0]


def replicate(obj, device, **fields):
    """``obj`` with every tensor it reaches moved to ``device``: tensors
    ``.to(device)``, ``torch.device`` values replaced, and tuples, lists,
    dicts, named tuples and the port's own objects (its dataclasses too)
    rebuilt where something inside them moved (bound methods follow their object;
    what is shared stays shared).  What already lives on ``device`` is
    returned as it is, so a replica on the object's own device shares its
    state.  ``fields`` set attributes of the (always copied) top object,
    whose own values under those names are not visited.  The mesh's one
    copy path: engines (``mesh_replica``) and fused buckets' states."""
    device = canonical(device)
    memo: dict = {}

    def moved_dict(x, skip=()):
        return {k: v if k in skip else move(v) for k, v in vars(x).items()}

    def move(x):
        hit = memo.get(id(x))
        if hit is not None:
            return hit[1]
        if isinstance(x, torch.Tensor):
            out = x.to(device)
        elif isinstance(x, torch.device):
            out = x if canonical(x) == device else device
        elif isinstance(x, types.MethodType):
            self_ = move(x.__self__)
            out = x if self_ is x.__self__ else types.MethodType(x.__func__,
                                                                 self_)
        elif isinstance(x, tuple) and hasattr(type(x), "_fields"):
            items = [move(v) for v in x]
            out = x if all(a is b for a, b in zip(items, x)) else \
                type(x)(*items)
        elif isinstance(x, (tuple, list)):
            items = [move(v) for v in x]
            out = x if all(a is b for a, b in zip(items, x)) else \
                type(x)(items)
        elif isinstance(x, dict):
            items = {k: move(v) for k, v in x.items()}
            out = x if all(items[k] is v for k, v in x.items()) else \
                type(x)(items)
        elif type(x).__module__.split(".")[0] == _PORT and (
                hasattr(x, "__dict__") or hasattr(x, "__slots__")):
            # held while its fields move, so a cycle back to it ends here
            memo[id(x)] = (x, x)
            if hasattr(x, "__dict__"):
                items = moved_dict(x)
                changed = any(items[k] is not v for k, v in vars(x).items())
            else:
                items = {k: move(getattr(x, k)) for k in x.__slots__}
                changed = any(items[k] is not getattr(x, k) for k in items)
            out = x
            if changed:
                out = copy.copy(x)
                for k, v in items.items():
                    object.__setattr__(out, k, v)
        else:
            out = x
        memo[id(x)] = (x, out)
        return out

    if not fields:
        return move(obj)
    out = copy.copy(obj)
    memo[id(obj)] = (obj, out)
    for k, v in moved_dict(obj, skip=fields).items():
        object.__setattr__(out, k, v)
    for k, v in fields.items():
        object.__setattr__(out, k, v)
    return out


# bookkeeping that changes run to run and is not what a replica copies
_RUN_FIELDS = ("min_logical_weight", "_base_key", "_drivers",
               "_mesh_replicas", "_mesh_lost", "_ladder")


def _state_of(sim) -> list:
    """What ``sim``'s state is made of: the object each attribute holds (a
    reassigned decoder or a rebuilt graph changes it)."""
    return [(k, v) for k, v in vars(sim).items()
            if k not in _RUN_FIELDS and not k.startswith("last_")]


def _same_state(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        ka == kb and va is vb for (ka, va), (kb, vb) in zip(a, b))


def mesh_replica(sim, device, slot: int):
    """Logical device ``slot``'s replica of ``sim`` on ``device``: its
    state moved there (``replicate``; shared where it already lives
    there), its own megabatch drivers and graphs, its batches drawn from
    the slot's stream.  Kept on ``sim`` until its state changes."""
    cache = sim.__dict__.setdefault("_mesh_replicas", {})
    state = _state_of(sim)
    hit = cache.get((device, slot))
    if hit is not None and _same_state(hit[0], state):
        return hit[1]
    rep = replicate(sim, device, _drivers={}, _mesh=None, _mesh_slot=slot,
                    _mesh_replicas={}, _ladder=None)
    cache[(device, slot)] = (state, rep)
    return rep


def refuse_mesh(sim, what: str) -> None:
    """Raise for a path the mesh does not shard (the JAX package's
    refusals)."""
    if getattr(sim, "_mesh", None) is not None:
        raise ValueError(f"{what} requires the single-device path (no mesh)")


def degrade_mesh(sim) -> None:
    """The ``mesh_replan`` rung of the JAX package's engines: from the next
    run on, ``sim``'s mesh runs replay the same logical key streams in
    turn on the mesh's first device (counted in telemetry's
    ``mesh.replans``).  ``mesh_batch_stats`` steps it on a device fault
    that is not deterministic; it can also be called directly."""
    if getattr(sim, "_mesh", None) is None or sim.__dict__.get("_mesh_lost"):
        return
    telemetry.count("mesh.replans")
    sim._mesh_lost = True


def _mesh_stream(drivers, seed, n_batches, extra, inject):
    """Every driver's megabatch stream in lockstep: each megabatch launched
    on every device (after ``inject()``, its fault site), then their
    reads, double-buffered.  Returns each driver's last host carry."""
    k = drivers[0].k_inner
    n_run = -(-int(n_batches) // k) * k
    its = [drv.stream(seed, n_batches, *extra) for drv in drivers]

    def launch(_):
        inject()
        return [drv.read_launch(next(it)[0]) for drv, it in zip(drivers, its)]

    def finish(pending):
        return [p.finish() for p in pending]

    last = None
    for last in drain_double_buffered(launch, finish, range(0, n_run, k)):
        pass
    return last


def _mesh_run(sim, chunk, seed, n_batches, extra, lost: bool,
              tele: bool = False):
    """One pass of the mesh's streams: on every mesh device, or after a
    replan (``lost``) the replay runner, the n streams one after another on
    the mesh's first device.  Returns ``(drivers, their host reads before,
    host carries, devices)``."""
    mesh = sim._mesh
    if lost:
        home = mesh.devices[0]
        drivers = [_engine_driver(mesh_replica(sim, home, d), chunk, tele)
                   for d in range(mesh.size)]
        reads = [drv.host_reads for drv in drivers]

        def inject():
            faultinject.site("mesh_replay_dispatch")

        hosts = [_mesh_stream([drv], seed, n_batches, extra, inject)[0]
                 for drv in drivers]
        return drivers, reads, hosts, [home] * mesh.size
    drivers = [_engine_driver(mesh_replica(sim, dev, d), chunk, tele)
               for d, dev in enumerate(mesh.devices)]
    reads = [drv.host_reads for drv in drivers]
    hosts = _mesh_stream(drivers, seed, n_batches, extra,
                         lambda: faultinject.site("mesh_dispatch"))
    return drivers, reads, hosts, list(mesh.devices)


def mesh_batch_stats(sim, num_samples: int, key, *extra):
    """The shot loop sharded over ``sim._mesh`` (the JAX package's
    ``mesh_batch_stats``): ``ShotBatcher(num_samples, batch_size *
    n_dev)``; logical device ``d`` runs batch ``i`` of the run as the
    engine's one-batch unit under ``split(fold_in(key, i), n_dev)[d]``,
    on its replica (``mesh_replica``), ``sim._scan_chunk`` batches per
    captured megabatch, one host read a megabatch per device; the devices'
    host carries fold with ``replay_fold``.  After ``degrade_mesh(sim)``
    the same streams run in turn on the mesh's first device (the replay
    runner) and fold the same way, so counts and min weight are the mesh
    run's bit for bit.

    A fault in the mesh run (the ``mesh_dispatch`` site fires before each
    megabatch; a ``mesh_device_loss`` fault, or any fault
    ``utils.resilience.classify_error`` does not call deterministic)
    steps the ``mesh_replan`` ladder rung (``degrade_mesh``: counted,
    with a ``degrade`` event) and reruns the whole cell from batch 0 on
    the replay runner (site ``mesh_replay_dispatch``), as the JAX package
    does: restarting keeps the counts equal to the uninterrupted run's,
    since the lost device's partial counts are gone.  A deterministic
    fault raises.  ``progress`` has no cursor here (as in the JAX
    package).  Records the run on ``sim`` (``last_mesh`` per device) and
    returns ``(failures, shots run)``."""
    mesh = sim._mesh
    n = mesh.size
    batcher = ShotBatcher(num_samples, sim.batch_size * n)
    chunk = min(batcher.num_batches, sim._scan_chunk)
    n_batches = -(-batcher.num_batches // chunk) * chunk
    seed = key_words(key)
    lost = bool(sim.__dict__.get("_mesh_lost"))
    tele = tele_on(sim)
    try:
        drivers, reads, hosts, devices = _mesh_run(
            sim, chunk, seed, n_batches, extra, lost, tele)
    except Exception as exc:  # noqa: BLE001 — classification decides
        if lost or resilience.classify_error(exc) == "deterministic":
            raise
        resilience.DegradationLadder(
            [("mesh_replan", lambda: degrade_mesh(sim))]).step()
        drivers, reads, hosts, devices = _mesh_run(
            sim, chunk, seed, n_batches, extra, True, tele)
    failures, min_w, *rest = replay_fold(hosts, has_tele=tele)
    if tele:
        telemetry.publish_device_tele(rest[0])
    megabatches = n_batches // chunk
    sim.last_megabatches = megabatches
    sim.last_dispatches = megabatches * n
    sim.last_host_reads = sum(drv.host_reads - r
                              for drv, r in zip(drivers, reads))
    sim.last_graph = drivers[0].graph_stats
    sim.last_mesh = [{"device": str(dev), "megabatches": megabatches,
                      "host_reads": drv.host_reads - r,
                      "graph": drv.graph_stats}
                     for dev, drv, r in zip(devices, drivers, reads)]
    sim.last_failures = int(failures)
    sim.last_shots = n_batches * sim.batch_size * n
    sim.min_logical_weight = min(sim.min_logical_weight, int(min_w))
    if diagnostics.active():
        diagnostics.note_run(sim.last_failures, sim.last_shots)
    return sim.last_failures, sim.last_shots


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


# ---------------------------------------------------------------------------
# Cell-fused sweep execution (every p of a code in one program)
# ---------------------------------------------------------------------------
# per-cell logical-type codes: a fused lane computes the X, Z and Total
# counts of its batch and picks its cell's by this index, on the device,
# so cells of every logical type share one program
LTYPE_CODES = {"X": 0, "Z": 1, "Total": 2}
# the decoder-state leaves that depend on p (the rest depend on H alone)
CELL_LEAVES = ("llr0", "osd_cost")


class LaneDecoder:
    """A decoder as a fused lane sees it: the representative's program and
    the lane's state (its cell's priors gathered on the device)."""

    __slots__ = ("device_static", "device_state")

    def __init__(self, device_static, device_state):
        self.device_static = device_static
        self.device_state = device_state


def lane_view(rep, **fields):
    """A shallow copy of the engine ``rep`` with ``fields`` replaced: the
    serial batch unit run on a lane's state (probabilities as device
    tensors, decoders as ``LaneDecoder``s, ``eval_logical_type="ALL"``)."""
    view = copy.copy(rep)
    view.__dict__.update(fields)
    return view


def _leaf_equal(a, b) -> bool:
    if a is b:
        return True
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return (a.shape == b.shape and a.dtype == b.dtype
                and a.device == b.device and bool(torch.equal(a, b)))
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return False
    return a == b


def stack_cell_states(states):
    """Stack per-cell state pytrees along a leading cell axis, sharing the
    leaves equal across cells (Tanner graphs, heads, parity adjacencies:
    whatever does not depend on p).  Returns ``(stacked, spec, axes)``:
    the stacked pytree, its spec and a tuple with 0 for each stacked leaf
    and None for each shared one.  Raises ValueError when the states differ
    in structure or in a leaf that is not a tensor (such cells cannot
    share a program)."""
    flats = [pytree.tree_flatten(s) for s in states]
    spec = flats[0][1]
    if any(sp != spec for _, sp in flats[1:]):
        raise ValueError("cell states differ in structure; cells of one "
                         "fused bucket must come from identically "
                         "configured decoders and engines")
    stacked, axes = [], []
    for group in zip(*(leaves for leaves, _ in flats)):
        if all(_leaf_equal(group[0], x) for x in group[1:]):
            stacked.append(group[0])
            axes.append(None)
        elif all(isinstance(x, torch.Tensor) and x.shape == group[0].shape
                 for x in group):
            stacked.append(torch.stack(list(group)))
            axes.append(0)
        else:
            raise ValueError("cell states differ in a leaf that cannot be "
                             "stacked; split them into separate buckets")
    return pytree.tree_unflatten(stacked, spec), spec, tuple(axes)


def states_share_but_llr(rep_dec_state, dec_state) -> bool:
    """Whether a decoder state dict differs from the representative's only
    in its p-dependent leaves (``CELL_LEAVES``: the prior and OSD's costs),
    the other leaves compared by identity (the decoders' per-H memo makes
    them the same objects): the gate of ``stack_from_overrides``."""
    if not (isinstance(dec_state, dict)
            and dec_state.keys() == rep_dec_state.keys()):
        return False
    return all(dec_state[k] is rep_dec_state[k]
               for k in dec_state if k not in CELL_LEAVES)


def _path_key(path) -> tuple:
    return tuple(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p)))
                 for p in path)


def stack_from_overrides(rep_state, overrides):
    """``stack_cell_states`` for builders that know which leaves vary: the
    representative's pytree with the (C, ...) ``overrides`` at their key
    paths, e.g. ``{("dx", "llr0"): (C, n) tensor, ("probs",): (C, 3)}``.
    Returns the same ``(stacked, spec, axes)`` triple; raises KeyError for
    a path the state does not have."""
    paths, spec = pytree.tree_flatten_with_path(rep_state)
    stacked, axes, used = [], [], set()
    for path, leaf in paths:
        key = _path_key(path)
        if key in overrides:
            stacked.append(overrides[key])
            axes.append(0)
            used.add(key)
        else:
            stacked.append(leaf)
            axes.append(None)
    missing = set(overrides) - used
    if missing:
        raise KeyError(f"override paths not found in state: {missing}")
    return pytree.tree_unflatten(stacked, spec), spec, tuple(axes)


def gather_lane_states(stacked, spec, axes, lane_cell):
    """One lane's view of a stacked bucket state: each stacked leaf at the
    lane's cell (``lane_cell`` a (1,) int64 device index: a gather kernel,
    no host read), the shared leaves as they are."""
    return pytree.tree_unflatten(
        [x.index_select(0, lane_cell).squeeze(0) if a == 0 else x
         for x, a in zip(pytree.tree_leaves(stacked), axes)], spec)


@dataclasses.dataclass
class FusedCellProgram:
    """One shape bucket's fused cell-axis run, ready to drive: built by the
    engines (``sim/data_error.fused_cells_program``,
    ``sim/phenom.fused_cells_program``) from same-shape cells, run by
    ``sweep/fused.py``.  ``key`` is the key every cell's serial run splits
    from the shared seed, so each cell draws its serial stream."""

    driver: object          # parallel.shots.CellFusedDriver
    key: tuple              # the run key's two words
    extras: tuple           # the driver's extra arguments (hashable)
    n_batches: int          # per-cell batch budget (chunk-rounded)
    chunk: int
    batch_size: int
    n_cells: int
    engine: str             # "data" | "phenl"
    wer_fn: object          # (failures, shots) -> (wer, eb) for one cell
    signature_fn: object = None
    _signature: dict = dataclasses.field(default=None, repr=False)
    cell_tags: tuple = None
    cell_keys: list = None
    # importance-sampled bucket: the carry gains the per-cell weight
    # moments and rare/sweep.py drives it
    weighted: bool = False
    # lane-batches given to lanes beyond a cell's first (adaptive runs)
    reallocated_batches: int = 0
    # the bucket's representative engine and a builder of its driver anew:
    # ``degrade`` steps the engine's ladder and rebuilds the driver
    rep: object = None
    rebuild: object = None

    @property
    def tele(self) -> bool:
        """Whether the bucket's carry holds the device telemetry vector
        (telemetry was on when its driver was built)."""
        return self.driver.tele

    @property
    def signature(self) -> dict:
        if self._signature is None:
            self._signature = self.signature_fn()
        return self._signature

    def release(self) -> None:
        """Drop the bucket's captured graphs (their memory with them)."""
        self.driver.release()

    def degrade(self):
        """The bucket's degradation ladder (``utils.resilience.RetryPolicy``
        steps it on repeated faults of the bucket's run): one rung of the
        representative engine's ladder (its ``_degrade_once``: the
        ``packed->dense`` rung of ``engine_ladder_step``), then the driver
        built and captured anew on it, so the bucket's next attempt runs
        the rung, bit for bit the run above it.  Returns the rung, or None
        when the ladder is spent (or the bucket has none)."""
        if self.rep is None:
            return None
        rung = self.rep._degrade_once()
        if rung is not None:
            self.driver.release()
            self.driver = self.rebuild()
        return rung


def bucket_layout(rep, num_samples: int, mesh=None):
    """The key, chunk and batch budget of each cell's serial run: the key
    its first ``WordErrorRate`` splits from the shared seed, and
    ``count_failures``'s chunk rounding.  A fused lane-batch runs on every
    mesh device, so the budget divides by the mesh size, as the serial
    mesh path's does."""
    key = split_key(rep._base_key)[1]
    n_dev = 1 if mesh is None else mesh.size
    batcher = ShotBatcher(num_samples, rep.batch_size * n_dev)
    chunk = min(batcher.num_batches, rep._scan_chunk)
    return key, chunk, -(-batcher.num_batches // chunk) * chunk


def bucket_driver(unit, rep, stacked, ltypes, chunk: int, mesh=None,
                  weighted: bool = False):
    """The ``CellFusedDriver`` of a bucket whose lane unit is ``unit(rep,
    stacked, ltypes)`` (its representative engine, stacked states and
    logical-type codes); on a ``mesh`` each device runs the unit on its
    ``replicate`` of the three.  With telemetry on (``tele_on(rep)``) each
    lane-batch also returns its device telemetry vector, which the
    bucket's carry sums over the active lanes."""
    tele = tele_on(rep)

    def lane_unit(r, st, lt):
        stats = unit(r, st, lt)
        return tele_stats(stats, r.device) if tele else stats

    return cell_fused_driver(
        lane_unit(rep, stacked, ltypes), len(ltypes), rep.batch_size, chunk,
        min_init=rep.N, device=rep.device, weighted=weighted,
        mesh=check_mesh(mesh), tele=tele,
        replicate=lambda dev: lane_unit(*replicate((rep, stacked, ltypes),
                                                   dev)))


def tags_json(cell_tags) -> list:
    """Cell tags as a resume fingerprint stores them: JSON lists (a tuple
    would come back a list and fail the fingerprint's match)."""
    return [list(t) if isinstance(t, (list, tuple)) else t
            for t in cell_tags]


def plan_lanes(cursors, undecided, n_lanes: int, k_inner: int,
               max_batches: int):
    """Assign ``n_lanes`` lanes across the undecided cells of a fused
    bucket for one megabatch (adaptive shot reallocation), as the JAX
    package does.

    Each undecided cell gets a fair share of lanes, capped by its remaining
    batch budget; leftover lanes spill to cells that can still absorb them.
    Co-assigned lanes interleave disjoint batch indices (stride = share),
    so a cell's stream stays the serial positional stream regardless of how
    many lanes serve it.

    Returns ``(lane_base, lane_stride, lane_cell, active, advance,
    realloc_batches)``: the lane plan vectors, the per-cell batch advance
    this megabatch, and how many lane-batches went to lanes BEYOND a cell's
    first (the reallocated work the fused batch would otherwise idle)."""
    cursors = np.asarray(cursors, np.int64)
    undecided = list(undecided)
    m = len(undecided)
    base = np.zeros(n_lanes, np.int64)
    stride = np.ones(n_lanes, np.int64)
    cell = np.zeros(n_lanes, np.int64)
    active = np.zeros(n_lanes, bool)
    advance = np.zeros(len(cursors), np.int64)
    if m == 0:
        return base, stride, cell, active, advance, 0
    cap = np.array(
        [-(-(max_batches - cursors[c]) // k_inner) for c in undecided],
        np.int64)
    share = np.array([n_lanes // m + (i < n_lanes % m) for i in range(m)],
                     np.int64)
    share = np.minimum(share, cap)
    # spill leftover lanes round-robin into cells with remaining budget
    leftover = n_lanes - int(share.sum())
    while leftover > 0:
        room = np.nonzero(share < cap)[0]
        if room.size == 0:
            break
        for i in room[:leftover]:
            share[i] += 1
        leftover = n_lanes - int(share.sum())
    lane = 0
    realloc = 0
    for i, c in enumerate(undecided):
        s = int(share[i])
        for r in range(s):
            cell[lane] = c
            base[lane] = cursors[c] + r
            stride[lane] = s
            active[lane] = True
            lane += 1
        advance[c] = s * k_inner
        realloc += max(0, s - 1) * k_inner
    return base, stride, cell, active, advance, realloc


def _fused_carry0(state, weighted: bool = False, tele: bool = False):
    """A fused carry's host values from a persisted per-cell progress
    record (``utils.checkpoint.CellProgress.save_cells``)."""
    carry = [state["failures"], state["shots"], state["min_w"]]
    if weighted:
        wm = state.get("weighted") or {}
        C = len(state["failures"])
        carry += [wm.get(k, [0.0] * C) for k in ("s1", "s2", "w1", "w2")]
    if tele:
        carry.append(state.get("tele") or [0] * telemetry.TELE_LEN)
    return tuple(carry)


def _fused_host(carry):
    """(failures, shots, min_w) host arrays of a fused host carry."""
    return tuple(np.asarray(x) for x in carry[:3])


def _save_cells(progress, prog, signature, batches_done, host,
                cursors=None) -> None:
    failures, shots, min_w = _fused_host(host)
    extra = None
    if prog.weighted:
        extra = {"weighted": {k: [float(x) for x in v] for k, v in zip(
            ("s1", "s2", "w1", "w2"), host[3:7])}}
    progress.save_cells(signature, batches_done=batches_done,
                        failures=failures, shots=shots, min_w=min_w,
                        cursors=cursors,
                        tele=np.asarray(host[-1]) if prog.tele else None,
                        extra=extra)


def fused_cell_launch(prog: FusedCellProgram, *, start: int = 0,
                      carry0=None):
    """Enqueue a whole fixed-budget fused bucket and the read of its
    carry, without waiting: the launch half of the bucket pipeline (while
    it runs on the card the caller builds the next bucket).  Returns
    ``(pending read, batches run)``; ``fused_cell_finish`` completes the
    read."""
    faultinject.site("fused_cells_launch")
    with telemetry.span("fused_cells_launch"):
        carry, n_run = prog.driver.run_plan(
            prog.key, prog.n_batches, *prog.extras, start=start,
            carry0=carry0)
        return prog.driver.read_launch(carry), n_run


def _fused_cell_progress(prog: FusedCellProgram, host) -> None:
    """Publish the bucket's per-cell intervals (gauges and one
    ``cell_progress`` event) from a host carry a read already fetched (no
    further read; one boolean when diagnostics are off); a weighted
    bucket's event carries each cell's ESS interval and effective sample
    size instead, as the JAX package's ``rare/sweep.py`` publishes it."""
    if not diagnostics.active():
        return
    if not prog.weighted:
        cells = (prog.cell_keys if prog.cell_keys is not None
                 else prog.cell_tags)
        diagnostics.publish_cell_progress(prog.engine, cells, host[0],
                                          host[1])
        return
    failures, shots, _, s1, s2, w1, w2 = (np.asarray(x) for x in host[:7])
    if prog.cell_keys is not None:
        cells = prog.cell_keys
    elif prog.cell_tags is not None:
        # a weighted tag is (px, py, pz, qx, qy, qz): the p total names it
        cells = [{"p": round(float(sum(t[:3])), 12)} for t in prog.cell_tags]
    else:
        cells = [{"p": i} for i in range(len(failures))]
    blocks = [diagnostics.weighted_ci_fields(int(f), a, b, c, d, int(n))
              for f, a, b, c, d, n in zip(failures, s1, s2, w1, w2, shots)]
    telemetry.event(
        "cell_progress", engine=prog.engine,
        cells=[c if isinstance(c, dict) else {"p": c} for c in cells],
        failures=[int(x) for x in failures], shots=[int(x) for x in shots],
        ci_low=[b["ci_low"] for b in blocks],
        ci_high=[b["ci_high"] for b in blocks],
        rse=[b["rse"] for b in blocks], ess=[b["ess"] for b in blocks])


def fused_cell_finish(pending, tele: bool = False, prog=None):
    """The drain half: one host read of the whole bucket's per-cell
    counters -> host ``(failures, shots, min_w)`` arrays, watchdog-guarded
    (``utils.resilience.guarded_fetch``; the pending read survives a
    retry).  With ``tele`` (the program's ``tele``) the carry's telemetry
    vector is published at that read; with ``prog`` (the bucket's
    program) its per-cell intervals too."""

    def fetch():
        faultinject.site("fused_cells_drain")
        return pending.finish()

    with telemetry.span("megabatch_drain"):
        host = resilience.guarded_fetch(fetch, label="fused_cells_drain")
    if tele:
        telemetry.publish_device_tele(host[-1])
    if prog is not None:
        _fused_cell_progress(prog, host)
    return _fused_host(host)


def fused_cell_stream(prog: FusedCellProgram, *, progress=None):
    """Fixed-budget fused run drained megabatch by megabatch
    (double-buffered, one host read each), every drained carry saving the
    bucket's per-cell cursors to ``progress``, so a killed sweep resumes
    inside the bucket seed for seed.  Returns the last host carry."""
    start, carry0 = 0, None
    state = progress.load(prog.signature) if progress is not None else None
    if state:
        start = int(state["batches_done"])
        carry0 = _fused_carry0(state, prog.weighted, prog.tele)
    k = prog.chunk
    n_run = -(-int(prog.n_batches) // k) * k
    if start >= n_run and state:
        # resumed past the end: the persisted counters are the result
        last = tuple(np.asarray(x) for x in carry0)
    else:
        last = None
        for host, done in prog.driver.run_plan_keys(
                prog.key, prog.n_batches, *prog.extras, start=start,
                carry0=carry0):
            if progress is not None:
                _save_cells(progress, prog, prog.signature, done, host)
            last = tuple(np.asarray(x) for x in host)
            # live per-cell intervals at the read the stream already pays
            _fused_cell_progress(prog, last)
    if prog.tele:
        telemetry.publish_device_tele(last[-1])
    return last


def fused_cell_adaptive(prog: FusedCellProgram, *, target_failures=None,
                        converged=None, mode=None, progress=None):
    """Adaptive shot reallocation over a fused bucket: megabatches with one
    host read each for the whole bucket; cells that reached
    ``target_failures`` (or ``converged(host carry, cell)``, the weighted
    runs' test) or their batch budget are masked out and their lanes go to
    the undecided cells (``plan_lanes``), so the bucket's lanes stay busy
    until every cell is decided.

    Every batch a cell runs draws from its serial positional stream (exact
    counts); once lanes reallocate, a cell's stop is checked at coarser
    boundaries than the serial early stop, so it may run more shots than
    the serial run would have (never beyond its serial budget).  ``mode``
    (a dict, by default the target) joins the progress fingerprint: the
    adaptive stream's per-cell cursors are not the uniform stream's.  Records
    the reallocated lane-batches in ``prog.reallocated_batches`` and
    telemetry's ``sweep.reallocated_shots``.  Returns the host carry."""
    driver, k = prog.driver, prog.chunk
    C = prog.n_cells
    n_run = -(-int(prog.n_batches) // k) * k
    cursors = np.zeros(C, np.int64)
    signature = None
    if progress is not None:
        signature = dict(prog.signature, **(
            mode if mode is not None else {"adaptive": int(target_failures)}))
    state = progress.load(signature) if progress is not None else None
    host = driver.host_init()
    carry = driver._init_fn()
    if state:
        cursors = np.asarray(
            state.get("cursors") or [state["batches_done"]] * C, np.int64)
        host = _fused_carry0(state, prog.weighted, prog.tele)
        driver._fill(carry, host)
    host = tuple(np.asarray(x) for x in host)

    def decided(c):
        if target_failures is not None:
            return host[0][c] >= int(target_failures)
        return converged(host, c)

    while True:
        undecided = [c for c in range(C)
                     if cursors[c] < n_run and not decided(c)]
        if not undecided:
            break
        base, stride, cell, active, advance, realloc = plan_lanes(
            cursors, undecided, C, k, n_run)
        if realloc:
            prog.reallocated_batches += realloc
            telemetry.count("sweep.reallocated_shots",
                            realloc * prog.batch_size)
        carry = driver.dispatch(carry, prog.key, (base, stride, cell,
                                                  active), *prog.extras)
        cursors += advance
        host = tuple(np.asarray(x) for x in driver.read(carry))
        if progress is not None:
            _save_cells(progress, prog, signature, 0, host, cursors=cursors)
        # the adaptive read already holds the whole bucket's counts
        _fused_cell_progress(prog, host)
    stopped = sum(1 for c in range(C) if cursors[c] < n_run)
    if stopped:
        telemetry.count("driver.early_stops", stopped)
    if prog.tele:
        telemetry.publish_device_tele(host[-1])
    return host


# ---------------------------------------------------------------------------
# Weighted (importance-sampled) runs: the rare-event estimators' statistics
# ---------------------------------------------------------------------------
def check_tilt_probs(tilt_probs, channel_probs) -> list:
    """Validate an importance-sampling tilt against its target channel and
    return it as a plain float list.

    The weighted estimator is unbiased only when the proposal covers the
    target's support: a component the channel can produce (``p_i > 0``)
    that the tilt never proposes (``q_i == 0``) biases the estimate low, so
    it is rejected here."""
    tilt = [float(np.asarray(q)) for q in tilt_probs]
    probs = [float(np.asarray(p)) for p in channel_probs]
    if len(tilt) != len(probs):
        raise ValueError(
            f"tilt_probs must have {len(probs)} components (one per Pauli "
            f"type), got {len(tilt)}")
    if any(q < 0 for q in tilt) or not 0.0 <= sum(tilt) < 1.0:
        raise ValueError(
            f"tilt_probs must be a sub-probability triple (q_i >= 0, "
            f"sum < 1), got {tilt}")
    for i, (q, p) in enumerate(zip(tilt, probs)):
        if p > 0 and q <= 0:
            raise ValueError(
                f"tilt component {i} is 0 but the channel's is {p}: the "
                "proposal must cover the target's support (outcomes the "
                "physical channel produces would never be drawn, biasing "
                "the estimate low); use rare.tilt_channel to scale the "
                "channel, or give every p>0 component a q>0")
    return tilt


def weight_moments(fail, w):
    """``(count, s1, s2)`` of one weighted batch: the raw failure count and
    the failure-weight moments ``sum w*I`` and ``sum w^2*I``, on the
    device (int32, float32, float32)."""
    wf = w * fail.to(torch.float32)
    return (fail.to(torch.int32).sum(dtype=torch.int32),
            wf.sum(dtype=torch.float32), (wf * w).sum(dtype=torch.float32))


def weighted_unit(x_fail, z_fail, min_w, logw):
    """The weighted batch unit of every logical type: ``(counts (3,),
    min_w, s1 (3,), s2 (3,), w1, w2)`` from per-shot flags and log weights.
    A serial run takes its type's slots, a fused lane its cell's."""
    w = torch.exp(logw)
    moments = [weight_moments(f, w) for f in
               (x_fail.bool(), z_fail.bool(), x_fail.bool() | z_fail.bool())]
    cnt, s1, s2 = (torch.stack(list(v)) for v in zip(*moments))
    return (cnt, min_w, s1, s2, w.sum(dtype=torch.float32),
            (w * w).sum(dtype=torch.float32))


@dataclasses.dataclass
class WeightedStats:
    """First and second weight moments of an importance-sampled failure
    stream, as the JAX package keeps them: per cell ``s1 = sum w_i I_i``,
    ``s2 = sum w_i^2 I_i``, ``w1 = sum w_i``, ``w2 = sum w_i^2`` and the
    raw failure count.  ``rate = s1 / shots`` is unbiased (the weights are
    exact likelihood ratios); uniform weights collapse every field onto the
    direct counts."""

    failures: int
    shots: int
    s1: float
    s2: float
    w1: float
    w2: float
    min_w: int | None = None

    @classmethod
    def from_carry(cls, carry, shots: int) -> "WeightedStats":
        """From a serial weighted host carry ``(count, min_w, s1, s2, w1,
        w2)``."""
        return cls(failures=int(carry[0]), shots=int(shots),
                   s1=float(carry[2]), s2=float(carry[3]),
                   w1=float(carry[4]), w2=float(carry[5]),
                   min_w=int(carry[1]))

    def merge(self, other: "WeightedStats") -> "WeightedStats":
        """Fold two disjoint weighted streams (moments and counts add)."""
        mins = [m for m in (self.min_w, other.min_w) if m is not None]
        return WeightedStats(
            failures=self.failures + other.failures,
            shots=self.shots + other.shots,
            s1=self.s1 + other.s1, s2=self.s2 + other.s2,
            w1=self.w1 + other.w1, w2=self.w2 + other.w2,
            min_w=min(mins) if mins else None)

    @property
    def rate(self) -> float:
        return self.s1 / self.shots if self.shots else 0.0

    @property
    def variance(self) -> float:
        """Variance estimate of ``rate`` (population form of the sample
        variance of the per-shot ``w*I`` terms, over ``shots``)."""
        if not self.shots:
            return 0.0
        r = self.rate
        return max(self.s2 / self.shots - r * r, 0.0) / self.shots

    @property
    def rse(self) -> float | None:
        r = self.rate
        return math.sqrt(self.variance) / r if r > 0 else None

    @property
    def ess(self) -> float:
        return diagnostics.effective_sample_size(self.w1, self.w2)

    @property
    def log_weight_sum(self) -> float | None:
        """``log sum w_i``: ``log(shots)`` for uniform weights; None when
        nothing ran."""
        return math.log(self.w1) if self.w1 > 0 else None

    def ci_fields(self, z: float | None = None) -> dict:
        """The ESS-aware uncertainty block (``utils.diagnostics.
        weighted_ci_fields``) of this stream."""
        kw = {} if z is None else {"z": z}
        return diagnostics.weighted_ci_fields(
            self.failures, self.s1, self.s2, self.w1, self.w2, self.shots,
            **kw)

    def event_fields(self, tilt=None) -> dict:
        """The weighted ``wer_run`` fields."""
        out = {"log_weight_sum": self.log_weight_sum, "ess": self.ess}
        if tilt is not None:
            out["tilt"] = float(tilt)
        return out


def wer_single_shot_weighted(stats: WeightedStats, K: int):
    """``wer_single_shot`` on the weighted rate, its binomial standard
    error replaced by the weighted estimator's ``sqrt(variance)``."""
    logical_error_rate = stats.rate
    logical_error_rate_eb = math.sqrt(stats.variance)
    word_error_rate = 1.0 - (1 - logical_error_rate) ** (1 / K)
    word_error_rate_eb = (
        logical_error_rate_eb * ((1 - logical_error_rate_eb) ** (1 / K - 1))
        / K)
    return word_error_rate, word_error_rate_eb


def wer_per_cycle_weighted(stats: WeightedStats, K: int, num_cycles: int):
    """``wer_per_cycle`` on the weighted rate; the per-cycle binomial error
    scaled by the weighted-over-binomial standard-error ratio of the total
    rate (1 for uniform weights: the reference's propagation)."""
    logical_error_rate = stats.rate
    per_qubit = 1.0 - (1 - logical_error_rate) ** (1 / K)
    if per_qubit <= 0.5:
        wer = (1.0 - (1 - 2 * per_qubit) ** (1 / num_cycles)) / 2
    else:
        wer = (1.0 + (-1 + 2 * per_qubit) ** (1 / num_cycles)) / 2
    per_cycle = (1.0 - max(1 - 2 * logical_error_rate, 0.0)
                 ** (1 / num_cycles)) / 2
    var_binom = max((1 - logical_error_rate) * logical_error_rate, 0.0) \
        / max(stats.shots, 1)
    scale = math.sqrt(stats.variance / var_binom) if var_binom > 0 else 1.0
    per_cycle_eb = math.sqrt(
        max((1 - per_cycle) * per_cycle, 0.0) / max(stats.shots, 1)) * scale
    wer_eb = per_cycle_eb * ((1 - per_cycle_eb) ** (1 / K - 1)) / K
    return wer, wer_eb


def weighted_driver(sim, chunk: int, program: tuple, stats_fn,
                    batch_input, tele: bool = False) -> MegabatchDriver:
    """``sim``'s weighted megabatch driver (carry ``(count, min_w, s1, s2,
    w1, w2)``, with ``tele`` the device telemetry vector after them), kept
    in ``sim._drivers`` like ``megabatch_driver``'s."""
    key = ("weighted", chunk, *program) + (("tele",) if tele else ())
    driver = sim._drivers.get(key)
    if driver is None:
        dev = sim.device

        def combine(c, o):
            return (c[0] + o[0], torch.minimum(c[1], o[1]),
                    *(c[i] + o[i] for i in range(2, len(c))))

        def init():
            out = (torch.zeros((), dtype=torch.int32, device=dev),
                   torch.full((), int(sim.N), dtype=torch.int32,
                              device=dev),
                   *(torch.zeros((), dtype=torch.float32, device=dev)
                     for _ in range(4)))
            return out + (tele_zeros(dev),) if tele else out

        if tele:
            stats_fn = tele_stats(stats_fn, dev)
        driver = sim._drivers[key] = MegabatchDriver(
            stats_fn, combine, init, chunk, batch_input=batch_input)
    return driver


def resumable_weighted_stream(driver, key, n_batches, extra, *, signature,
                              progress, tele_on: bool = False):
    """``resumable_stream`` for the weighted carry ``(count, min_w, s1, s2,
    w1, w2[, tele])``: the float32 moments persist exactly in the cursor's
    ``weighted`` block, the telemetry vector in its ``"tele"``.  Returns
    ``((host carry0 or None, start), stream)``."""
    start, carry0 = 0, None
    state = progress.load(signature) if progress is not None else None
    if state:
        start = int(state["batches_done"])
        wm = state.get("weighted") or {}
        carry0 = (int(state["failures"]), int(state["min_w"]),
                  *(float(wm.get(k, 0.0)) for k in ("s1", "s2", "w1", "w2")))
        if tele_on:
            carry0 += (state.get("tele") or [0] * telemetry.TELE_LEN,)

    def stream():
        for carry, done in driver.run_keys(key_words(key), n_batches, *extra,
                                           start=start, carry0=carry0):
            if progress is not None:
                progress.save(
                    signature, batches_done=done, failures=int(carry[0]),
                    min_w=int(carry[1]),
                    tele=carry[6] if len(carry) > 6 else None,
                    extra={"weighted": {
                        "s1": float(carry[2]), "s2": float(carry[3]),
                        "w1": float(carry[4]), "w2": float(carry[5])}})
            yield carry, done

    return (carry0, start), stream()


def drive_weighted_run(driver, key, n_batches, extra, *, batch_size, total,
                       carry0, start, stream, target_rse, progress):
    """The drive loop of the weighted engines: a fixed budget is one fold
    and one host read; with ``progress`` or ``target_rse`` the megabatch
    stream runs instead, stopping once the weighted relative standard
    error reaches ``target_rse``.  Returns the host carry and the batches
    done."""
    if progress is None and target_rse is None:
        carry, done = driver.run(key_words(key), n_batches, *extra)
        return driver.read(carry), done

    def rse_hit(c, shots):
        if target_rse is None or not shots:
            return False
        rse = WeightedStats.from_carry(c, shots).rse
        return rse is not None and rse <= float(target_rse)

    carry, done = carry0, start
    if carry is None or not rse_hit(carry, start * batch_size):
        for carry, done in stream:
            if rse_hit(carry, done * batch_size):
                if done * batch_size < total:
                    telemetry.count("driver.early_stops")
                break
    else:
        telemetry.count("driver.early_stops")
    return carry, done



# ---------------------------------------------------------------------------
# The resilience layer: engine runs under the retry policy, the degradation
# ladder and the host-assisted (host OSD) batch loop
# ---------------------------------------------------------------------------
def needs_host(*decoders) -> bool:
    """Whether any decoder runs a host stage after ``decode_device`` (a
    ``BPOSD_Decoder(device_osd=False)``)."""
    return any(getattr(d, "needs_host_postprocess", False) for d in decoders)


def launch_decode(dec, syndromes):
    """The device half of one decode: ``decode_device``'s corrections, or
    for a decoder with a host OSD stage its BP's outputs; pass the result
    to ``finish_decode``."""
    if getattr(dec, "needs_host_postprocess", False):
        res = dec.bp_batch_device(syndromes)
        return syndromes, res.error, res._asdict()
    cor, _ = decode_device(dec.device_static, dec.device_state, syndromes)
    return syndromes, cor, None


def finish_decode(dec, pending) -> torch.Tensor:
    """The corrections of a ``launch_decode``: a host OSD decoder's host
    stage runs here (one host read), a device decoder's are returned."""
    syndromes, err, aux = pending
    if aux is None:
        return err
    return torch.from_numpy(dec.host_postprocess(syndromes, err, aux)).to(
        err.device)


def resilient_engine_run(fn, *, site, degrade=None):
    """Run ``fn()`` under the active ``utils.resilience`` policy, the JAX
    package's engine-level wrapper: the fault site ``site`` fires before
    each attempt; transient faults retry (the run's key is fixed before the
    first attempt, so a retry is bit-exact), deterministic ones raise, and
    repeated faults step ``degrade`` (the engine's ladder).  A fault that
    outlives the retries and the ladder raises.  With no policy installed
    the run is one call behind one site check.

    The run is one ``utils.profiling.engine_scope(site)``: its dispatches
    and host reads record into it, and ``record_wer_run`` embeds the
    scope's waterfall in the run's heartbeat."""

    def attempt():
        faultinject.site(site)
        return fn()

    with profiling.engine_scope(site):
        return resilience.run_cell(attempt, label=site, degrade=degrade)


def engine_ladder_step(sim, extra_rungs=()):
    """Build ``sim``'s degradation ladder on first use and step it once
    (``utils.resilience.DegradationLadder``): ``extra_rungs`` (the engine's
    own, the fused sampler's) in front of ``packed->dense`` where the
    engine runs packed planes and no fused sampler
    (``sim._set_packed(False)``, bit for bit the packed run).  Every rung stays on the card's kernels: the JAX
    package's ``fused_pallas->fused_xla`` and ``device->cpu`` rungs (and
    the fused sampler's ``fused->packed``) would move the run off them, so
    the port has none and a fault past the last rung raises (ROADMAP §C).
    Returns the rung taken, or None when exhausted."""
    if sim.__dict__.get("_ladder") is None:
        rungs = list(extra_rungs)
        if getattr(sim, "_packed", False) and not getattr(
                sim, "_fused_sampler", False):
            rungs.append(("packed->dense", lambda: sim._set_packed(False)))
        sim._ladder = resilience.DegradationLadder(rungs)
    return sim._ladder.step()


def windowed_count(launch, finish, keys, in_flight: int = 4) -> int:
    """Failure count of the host-assisted paths (a decoder with a host OSD
    stage): ``launch(key)`` enqueues one batch's device work (behind the
    ``windowed_launch`` site, retried under the policy), ``finish(pending)``
    reads it, runs the host stage and returns the batch's per-shot failure
    flags (behind ``windowed_drain``, watchdog-guarded; the pending batch
    survives a retry).  ``in_flight`` batches stay launched, so the device
    works while the host post-processes."""

    def _launch_one(k):
        faultinject.site("windowed_launch")
        return launch(k)

    def _finish_one(item):
        def fetch():
            faultinject.site("windowed_drain")
            return int(finish(item).sum())

        return timed_host_sync(lambda: resilience.guarded_fetch(
            fetch, label="windowed_drain"))

    window, count = [], 0
    for k in keys:
        t0 = time.perf_counter()
        window.append(resilience.run_cell(lambda k=k: _launch_one(k),
                                          label="windowed_launch"))
        profiling.record_dispatch(time.perf_counter() - t0)
        telemetry.count("driver.dispatches")
        telemetry.set_gauge("driver.drain_depth", len(window))
        if len(window) >= in_flight:
            count += _finish_one(window.pop(0))
    while window:
        count += _finish_one(window.pop(0))
    return count


# ---------------------------------------------------------------------------
# The run record: the sim.* counters, wer_run and heartbeat
# ---------------------------------------------------------------------------
def joint_kernel_variant(*decoders, batch_size: int | None = None) -> str:
    """The BP program serving a simulator's decoders
    (``decoders.bp_decoders.kernel_variant`` of each, with the engine's
    batch size so the heads' per-batch gates apply): their common variant,
    or ``"mixed"`` when they differ."""
    from ..decoders.bp_decoders import kernel_variant

    vs = set()
    for dec in decoders:
        static = getattr(dec, "device_static", None)
        if static is None:
            vs.add("xla_twin")
            continue
        vs.add(kernel_variant(static, dec.device_state, batch_size))
    if not vs:
        return "xla_twin"
    return vs.pop() if len(vs) == 1 else "mixed"


def joint_osd_backend(*decoders) -> str:
    """Where a simulator's OSD stages run (the ``wer_run`` event's
    ``osd_backend``): ``"device"`` when every OSD decoder keeps OSD in its
    device program (``"device_cs"`` when they all run the combination
    sweep), ``"host"`` when every one runs it on the host, ``"mixed"`` on
    disagreement, ``"none"`` without an OSD stage."""
    backends = set()
    for dec in decoders:
        method = getattr(dec, "osd_method", None)
        if method is None:
            continue
        if getattr(dec, "needs_host_postprocess", False):
            backends.add("host")
        else:
            backends.add("device_cs" if method == "osd_cs" else "device")
    if not backends:
        return "none"
    return backends.pop() if len(backends) == 1 else "mixed"


def record_wer_run(engine: str, failures, shots, wer, dispatches=None,
                   kernel_variant=None, weighted=None, tilt=None,
                   osd_backend=None) -> dict:
    """The per-run record of every engine's WER paths, the JAX package's:
    the ``sim.shots`` / ``sim.failures`` / ``sim.runs`` counters, one
    ``wer_run`` event (``dispatches`` where the path counts them,
    ``kernel_variant`` of ``ops.bp_kernel.KERNEL_VARIANTS`` or
    ``"mixed"``, ``osd_backend``, and for a weighted run (``weighted``, a
    ``WeightedStats``) its ESS fields) and one ``heartbeat`` event with the
    waterfall of the enclosing ``utils.profiling.engine_scope``.  With
    ``utils.diagnostics`` active the event carries the run's uncertainty
    block (ESS-aware for weighted runs), which is returned ({} otherwise)
    so a cell's record can reuse it.  Host arithmetic on numbers already
    read: the estimate is untouched."""
    fields = {"engine": engine, "shots": int(shots),
              "failures": int(failures), "wer": float(wer)}
    if dispatches is not None:
        fields["dispatches"] = int(dispatches)
    if osd_backend is not None:
        fields["osd_backend"] = str(osd_backend)
    if weighted is not None:
        fields.update(weighted.event_fields(tilt=tilt))
    if kernel_variant is not None:
        from ..ops.bp_kernel import KERNEL_VARIANTS

        fields["kernel_variant"] = str(kernel_variant)
        code = (KERNEL_VARIANTS.index(kernel_variant)
                if kernel_variant in KERNEL_VARIANTS else -1)
        telemetry.set_gauge("bp.kernel_variant", code)
        telemetry.count(f"bp.kernel_variant.{kernel_variant}")
    ci = {}
    if diagnostics.active():
        ci = (weighted.ci_fields() if weighted is not None
              else diagnostics.ci_fields(failures, shots))
        fields.update(ci)
    telemetry.count("sim.shots", int(shots))
    telemetry.count("sim.failures", int(failures))
    telemetry.count("sim.runs")
    telemetry.event("wer_run", **fields)
    hb = {"engine": engine, "shots": int(shots)}
    if ci:
        hb["rse"] = ci["rse"]
    wf = profiling.run_heartbeat()
    if wf is not None:
        hb["waterfall"] = wf
        gap = wf.get("dispatch_gap_fraction")
        if gap is not None:
            telemetry.set_gauge("profile.dispatch_gap_fraction", gap)
    telemetry.event("heartbeat", **hb)
    return ci


def record_engine_run(sim, engine: str, decoders, failures, shots, wer,
                      **kw) -> dict:
    """``record_wer_run`` of one run of ``sim`` with its ``decoders``: the
    run's dispatches, their joint kernel variant at the engine's batch size
    and their OSD backend."""
    return record_wer_run(
        engine, failures, shots, wer,
        dispatches=getattr(sim, "last_dispatches", None),
        kernel_variant=joint_kernel_variant(*decoders,
                                            batch_size=sim.batch_size),
        osd_backend=joint_osd_backend(*decoders), **kw)
