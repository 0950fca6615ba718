"""Megabatch driver: many Monte-Carlo batches per host read.

``MegabatchDriver`` runs ``stats_fn(batch_input(seed, j), *extra)`` for
``k_inner`` batches per megabatch and folds the results on the device
(counts summed, min-weights minimized); the carry stays a tuple of device
tensors.  The stream is positional, so batch j's draws depend only on
(seed, j): the caller's ``batch_input`` makes them, ``GeneratorInput`` (a
``torch.Generator`` seeded by ``batch_seed(seed, j)``) or, for the
counter-PRNG engines, ``KeyInput`` (``ops/prng.py`` ``fold_in``, the key
words the JAX package's driver folds).

On the card a megabatch is one captured CUDA graph, the counterpart of the
JAX package's jitted ``lax.scan``: the driver captures ``k_inner`` batches
and their fold into a static carry once per ``extra`` (the tier ladders'
``device_cond``s become conditional nodes) and replays the capture, each
replay's generators reseeded with ``batch_seed(seed, j)`` or its keys folded
on the device from a batch index that the graph advances.  Warm-up and
capture draw from throwaway generators and keys, so batch j draws exactly
what it draws eagerly.  ``run_keys`` drains the carries double-buffered:
megabatch d's carry is snapshotted and copied to the host while d+1
computes, one host read per megabatch.  Elsewhere (the CPU, the plain
versions under ``_kernels.force_plain()``, ``_kernels.force_eager()``) a
megabatch is the eager loop.

The shot mesh (the JAX package's ``shot_mesh`` / ``shard_map`` over a
``shots`` axis): a ``ShotMesh`` is a tuple of ``torch.device``s, logical
devices that may repeat (two entries on one card run two replicas there, as
the JAX tests' virtual CPU devices do).  Logical device ``d`` draws batch
``j`` of a run keyed ``seed`` from ``prng.mesh_key(seed, j, d)``
(``split(fold_in(key, j), n)[d]``): a batch input's ``slot`` selects that
stream.  Every device runs its own replica of the state; only the folded
scalars (counts summed, min weights minimized, ``replay_fold``) cross
between them, on the host.  ``MeshCellFusedDriver`` shards a fused bucket
that way, and its ``degrade_mesh()`` swaps in the same folds run in turn
on one device.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from ..ops import _kernels
from ..ops.prng import (
    fold_in,
    fold_in_device,
    mesh_key,
    mesh_keys_device,
    split_key,
)
from ..utils import device as _device
from ..utils import faultinject, profiling, resilience, telemetry

__all__ = ["SHOT_AXIS", "ShotMesh", "shot_mesh", "check_mesh",
           "split_keys_for_mesh", "replay_fold", "sharded_batch_stats",
           "batch_seed",
           "batch_generator", "GeneratorInput", "KeyInput",
           "MegabatchDriver", "CellFusedDriver", "MeshCellFusedDriver",
           "count_min_driver", "cell_fused_driver", "drain_double_buffered",
           "tele_zeros",
           "check_syncs", "CapturedStep"]

SHOT_AXIS = "shots"


class ShotMesh(NamedTuple):
    """A 1-D mesh of logical devices over the shot axis: ``devices`` a
    tuple of ``torch.device``s (entries may repeat).  Immutable and
    hashable, so drivers and caches key on it."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def shot_mesh(devices=None) -> ShotMesh:
    """The mesh over ``devices`` (names or ``torch.device``s; by default
    every visible CUDA device).  A CUDA entry raises when no card is
    present or its index is past the cards there."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass the mesh's "
                               "devices, e.g. shot_mesh(['cpu'] * 2)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    out = []
    for dev in devices:
        dev = _device.canonical(dev)
        if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
            raise ValueError(f"{dev} is past the {torch.cuda.device_count()} "
                             "visible CUDA devices")
        out.append(dev)
    if not out:
        raise ValueError("a shot mesh needs at least one device")
    return ShotMesh(tuple(out))


def check_mesh(mesh):
    """``mesh`` itself when it is None or a ``ShotMesh``; raises otherwise."""
    if mesh is not None and not isinstance(mesh, ShotMesh):
        raise TypeError(f"mesh must be a parallel.shots.ShotMesh "
                        f"(shot_mesh(...)), got {type(mesh).__name__}")
    return mesh


def split_keys_for_mesh(key, mesh: ShotMesh) -> tuple:
    """One key per mesh device: ``split_key(key, mesh.size)``, the JAX
    package's ``jax.random.split(key, n)``."""
    return split_key(key, mesh.size)


def _minimum(a, b):
    if isinstance(a, torch.Tensor):
        return torch.minimum(a, b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.minimum(a, b)
    return min(a, b)


def replay_fold(outs, n_w: int = 0, has_tele: bool = False):
    """Fold per-logical-device stats ``outs[d] = (count, min_w, *moments[,
    tele])`` in device order, as the JAX package's mesh collectives fold
    them: counts summed, min weights minimized, the ``n_w`` weight moments
    and a trailing telemetry vector summed.  Host numbers, numpy arrays or
    device tensors.  Integer folds are order-free, so a replay of the same
    key streams gives the mesh run's counts bit for bit."""
    width = 2 + n_w + (1 if has_tele else 0)
    res = list(outs[0][:width])
    for out in outs[1:]:
        res[0] = res[0] + out[0]
        res[1] = _minimum(res[1], out[1])
        for i in range(2, width):
            res[i] = res[i] + out[i]
    return tuple(res)


def sharded_batch_stats(stats_fn, mesh: ShotMesh, has_tele: bool = False):
    """The mesh unit of every engine: ``run(keys)`` runs ``stats_fn(key,
    device) -> (count, min_w[, tele])`` once on each mesh device with that
    device's key (``split_keys_for_mesh``), the function placing its work
    on ``device`` (its replica of the state there), launches every device
    before reading any, and returns the ``replay_fold`` of the host
    values.  Only those scalars leave the devices."""

    def run(keys):
        if len(keys) != mesh.size:
            raise ValueError(f"{len(keys)} keys for a mesh of {mesh.size}")
        outs = [stats_fn(k, dev) for k, dev in zip(keys, mesh.devices)]
        host = [tuple(x.tolist() if isinstance(x, torch.Tensor) else x
                      for x in out) for out in outs]
        return replay_fold(host, has_tele=has_tele)

    return run


def batch_seed(seed, j: int) -> int:
    """Deterministic 63-bit generator seed of batch ``j`` of stream
    ``seed`` (an int or a tuple of ints)."""
    entropy = list(seed) if isinstance(seed, (tuple, list)) else [int(seed)]
    state = np.random.SeedSequence(entropy + [int(j)]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def batch_generator(seed, j: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(batch_seed(seed, j))
    return gen


# the stream warm-up and capture draw from, never a run's
_THROWAWAY = (0x5EED, 0xC0DE)


def slot_seed(seed, j: int, slot=None) -> tuple:
    """The ``(seed, index)`` a batch generator is seeded from: batch ``j``
    of stream ``seed``, or on logical device ``slot`` of a mesh the
    one-batch unit under that device's key (``mesh_key(seed, j, slot)``,
    index 0)."""
    if slot is None:
        return seed, j
    return mesh_key(seed, j, slot), 0


class GeneratorInput:
    """Batch ``j`` draws from ``batch_generator(seed, j, device)``; with a
    mesh ``slot``, from the generator of ``slot_seed(seed, j, slot)``."""

    def __init__(self, device, slot=None):
        self.device = torch.device(device)
        self.slot = slot

    def __call__(self, seed, j: int) -> torch.Generator:
        return batch_generator(*slot_seed(seed, j, self.slot), self.device)

    def on_slot(self, slot) -> "GeneratorInput":
        return GeneratorInput(self.device, slot)

    def captured(self, k: int):
        return _CapturedGenerators(self.device, k, self.slot)


class _CapturedGenerators:
    """``k`` generators registered with the graph, reseeded before each
    replay."""

    def __init__(self, device, k: int, slot=None):
        self.gens = [batch_generator(_THROWAWAY, j, device) for j in range(k)]
        self.slot = slot

    def warmup(self):
        return batch_generator(_THROWAWAY, 0, self.gens[0].device)

    def register(self, graph) -> None:
        for gen in self.gens:
            graph.register_generator_state(gen)

    def inputs(self):
        return self.gens

    def advance(self) -> None:
        pass

    def start(self, seed, offset: int) -> None:
        pass

    def before_replay(self, seed, offset: int) -> None:
        for j, gen in enumerate(self.gens):
            gen.manual_seed(batch_seed(*slot_seed(seed, offset + j,
                                                  self.slot)))


class KeyInput:
    """Batch ``j`` draws from the counter-PRNG key ``fold_in(seed, j)``;
    with a mesh ``slot``, from ``mesh_key(seed, j, slot)``."""

    def __init__(self, device, slot=None):
        self.device = torch.device(device)
        self.slot = slot

    def __call__(self, seed, j: int):
        if self.slot is None:
            return fold_in(seed, j)
        return mesh_key(seed, j, self.slot)

    def on_slot(self, slot) -> "KeyInput":
        return KeyInput(self.device, slot)

    def captured(self, k: int):
        return _CapturedKeys(self.device, k, self.slot)


class _CapturedKeys:
    """The run's key words and the next batch index on the device; the
    graph folds ``k`` keys from them (and, on a mesh slot, each key's
    split for that slot) and advances the index by ``k``."""

    def __init__(self, device, k: int, slot=None):
        self.k = k
        self.slot = slot
        self.base = torch.tensor(_THROWAWAY, dtype=torch.int64).to(device)
        self.index = torch.zeros((), dtype=torch.int64, device=device)

    def warmup(self):
        return fold_in(_THROWAWAY, 0)

    def register(self, graph) -> None:
        pass

    def inputs(self):
        j = self.index + torch.arange(self.k, device=self.index.device)
        keys = (fold_in_device(self.base, j) if self.slot is None
                else mesh_keys_device(self.base, j, self.slot))
        return [keys[i] for i in range(self.k)]

    def advance(self) -> None:
        self.index.add_(self.k)

    def start(self, seed, offset: int) -> None:
        # kernels, each with its value as an argument: no host buffer that a
        # queued copy could still read
        for i, word in enumerate(seed):
            self.base[i].fill_(int(word))
        self.index.fill_(int(offset))

    def before_replay(self, seed, offset: int) -> None:
        pass


def drain_double_buffered(launch, finish, items, depth: int = 2):
    """Keep ``depth`` launched payloads in flight; yield ``finish(payload)``
    in order.  ``launch`` only enqueues device work; ``finish`` waits for
    and reads one payload, so item d+1 computes while d drains."""
    pending = deque()
    for it in items:
        pending.append(launch(it))
        if len(pending) >= depth:
            yield finish(pending.popleft())
    while pending:
        yield finish(pending.popleft())


class _Graph(NamedTuple):
    """One captured megabatch: the graph, its static carry and inputs, the
    pool its conditional bodies allocate from (kept with it), and what its
    capture cost."""

    graph: torch.cuda.CUDAGraph
    carry: tuple
    inputs: object
    body_pool: object
    stats: dict


def _on(device):
    """``torch.cuda.device(device)`` for a CUDA device, else nothing: the
    guard a launch or event on a mesh replica's card needs."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@contextlib.contextmanager
def _sync_mode(checked: bool):
    if not checked:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


_checks = threading.local()


@contextlib.contextmanager
def check_syncs():
    """Within the block (this thread only) a graph run's replays and reads
    run under ``torch.cuda.set_sync_debug_mode("error")``: they raise on
    any synchronizing CUDA call besides the one read per megabatch, which
    waits on an event.  chip_smoke.py and the card tests use it."""
    prev = getattr(_checks, "syncs", False)
    _checks.syncs = True
    try:
        yield
    finally:
        _checks.syncs = prev


def _capture_graph(dev, warmup, body, register=None, label=None):
    """``warmup()`` under ``device_cond``'s both-branches hook on a side
    stream (counting no launch), then ``body()`` captured into a CUDA graph
    (``register(graph)`` first, for its generators) and instantiated.
    Returns (graph, body's outputs, the pool its conditional bodies
    allocate from, which must live as long as the graph, and what the
    capture cost: its seconds, nodes and the device memory it took).  With
    profiling on, the graph's ``ProgramCost`` is recorded under ``label``
    (``utils.profiling.capture_jit_cost``)."""
    with torch.cuda.device(dev):
        _kernels.launch_counts(dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with (torch.cuda.stream(stream), _device._both_branches(),
              _kernels.uncounted()):
            warmup()
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        mem0 = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if register is not None:
            register(graph)
        with (_kernels.collect_costs() as costs,
              _device.graph_capture(graph, dev, stream) as rec):
            outs = body()
        t2 = time.perf_counter()
        graph.instantiate()
        t3 = time.perf_counter()
    stats = {"warmup_s": t1 - t0, "capture_s": t2 - t1,
             "instantiate_s": t3 - t2,
             "nodes": _device.graph_nodes(graph) + rec.body_nodes,
             # the device memory the capture's private pool reserved
             "pool_bytes": max(0, torch.cuda.memory_reserved(dev) - mem0)}
    telemetry.note_capture(t3 - t0)
    if profiling.enabled():
        profiling.capture_jit_cost(label or "graph", stats,
                                   [tuple(c) for c in costs])
    return graph, outs, rec.body_pool, stats


class MegabatchDriver:
    """Fold ``stats_fn(batch_input(seed, j), *extra)`` over batches,
    ``k_inner`` per megabatch (module docstring).

    stats_fn:    (batch input, *extra) -> tuple of device tensors.
    combine:     (carry, out) -> carry — the on-device fold.
    init_fn:     () -> initial carry (device tensors).
    batch_input: (seed, j) -> what batch ``j`` draws from; a
                 ``GeneratorInput`` or ``KeyInput`` also gives the captured
                 counterpart that a run on the card needs.
    """

    def __init__(self, stats_fn, combine, init_fn, batch_input,
                 k_inner: int = 8):
        self.k_inner = max(1, int(k_inner))
        self._stats_fn = stats_fn
        self._combine = combine
        self._init_fn = init_fn
        self._batch_input = batch_input
        self._graphs: dict = {}  # extra -> _Graph
        self.megabatches = 0  # cumulative
        self.host_reads = 0  # cumulative, run_keys' reads
        self.graph_stats = None  # of the capture the last run replayed

    def _megabatch(self, carry, seed, offset, *extra):
        for j in range(self.k_inner):
            batch = self._batch_input(seed, offset + j)
            carry = self._combine(carry, self._stats_fn(batch, *extra))
        self.megabatches += 1
        return carry

    @staticmethod
    def _graphed(carry) -> bool:
        return (carry[0].is_cuda and not _kernels.plain_forced()
                and not _kernels.eager_forced())

    def _capture(self, extra, carry) -> _Graph:
        """Warm every branch up on throwaway draws, then capture one
        megabatch folding into ``carry``."""
        if not hasattr(self._batch_input, "captured"):
            raise TypeError("a run on the card needs a batch input with a "
                            "captured counterpart (GeneratorInput, KeyInput)")
        inputs = self._batch_input.captured(self.k_inner)

        def megabatch():
            for batch in inputs.inputs():
                new = self._combine(carry, self._stats_fn(batch, *extra))
                for c, v in zip(carry, new):
                    c.copy_(v)
            inputs.advance()

        graph, _, body_pool, stats = _capture_graph(
            carry[0].device, lambda: self._stats_fn(inputs.warmup(), *extra),
            megabatch, inputs.register, label=self.cost_label)
        return _Graph(graph, carry, inputs, body_pool, stats)

    @property
    def cost_label(self) -> str:
        """The captured graph's label in ``utils.profiling``'s cost table:
        its batch function's name and the batches a megabatch."""
        fn = getattr(self._stats_fn, "__qualname__", "stats")
        return f"megabatch.{fn}.k{self.k_inner}"

    def _start(self, n_batches: int, start: int, carry0):
        """The run's batch count (a k_inner multiple) and its first carry:
        ``init_fn()``'s, or ``carry0``'s values written into it."""
        k = self.k_inner
        n_run = -(-int(n_batches) // k) * k
        if start % k or not 0 <= start <= n_run:
            raise ValueError(f"start={start} must be a multiple of k_inner="
                             f"{k} in [0, {n_run}]")
        carry = self._init_fn()
        if carry0 is not None:
            self._fill(carry, carry0)
        return n_run, carry

    @staticmethod
    def _fill(carry, values) -> None:
        """Write host ``values`` (a number, or a sequence for a vector slot,
        per carry slot) into the device ``carry``: a kernel each, the value
        as its argument (no host buffer that a queued copy could still
        read)."""
        if len(values) != len(carry):
            raise ValueError(f"carry0 has {len(values)} values, the carry "
                             f"{len(carry)}")
        for c, v in zip(carry, values):
            conv = float if c.is_floating_point() else int
            if c.dim() == 0:
                c.fill_(conv(v))
            else:
                for i, x in enumerate(np.asarray(v).reshape(-1).tolist()):
                    c[i].fill_(conv(x))

    @staticmethod
    def _pack(carry) -> torch.Tensor:
        """The carry as one 1-D tensor for one host read: int64, or float64
        when a slot is floating (exact for float32 moments and for counts
        below 2**53)."""
        dtype = (torch.float64 if any(c.is_floating_point() for c in carry)
                 else torch.int64)
        return torch.cat([c.reshape(-1).to(dtype) for c in carry])

    @staticmethod
    def _unpack(carry, values) -> tuple:
        """Host values of ``_pack(carry)``: a Python number per scalar slot,
        a numpy array per vector slot."""
        out, i = [], 0
        for c in carry:
            n = c.numel()
            vals = values[i:i + n]
            i += n
            if c.dim() == 0:
                out.append(float(vals[0]) if c.is_floating_point()
                           else int(vals[0]))
            else:
                out.append(np.asarray(vals, np.float64 if c.is_floating_point()
                                      else np.int64))
        return tuple(out)

    def read_launch(self, carry) -> "_PendingRead":
        """Start the one host read of ``carry`` (with a replayed graph's
        launch counts): a pinned copy and an event; ``.finish()`` waits and
        returns the host values."""
        dev = carry[0].device if self._graphed(carry) else None
        checked = getattr(_checks, "syncs", False)
        ready = None
        with _sync_mode(checked and dev is not None), _on(carry[0].device):
            snap = self._pack(carry)
            if dev is not None:
                snap = torch.cat([snap, _kernels.launch_counts(dev).to(
                    snap.dtype)])
            if snap.is_cuda:
                host = torch.empty(snap.shape, dtype=snap.dtype,
                                   pin_memory=True)
                host.copy_(snap, non_blocking=True)
                # the copy runs on the carry's device's stream: the event
                # goes there too, whichever device is current
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(snap.device))
            else:
                host = snap
        return _PendingRead(self, carry, host, ready, dev, checked)

    def read(self, carry) -> tuple:
        """The host values of ``carry``: one host read."""
        return self.read_launch(carry).finish()

    def release(self) -> None:
        """Drop the captured graphs (their memory with them)."""
        self._graphs.clear()

    def stream(self, seed, n_batches: int, *extra, start: int = 0,
               carry0=None):
        """Yield ``(carry, batches_done)`` after every megabatch.  On the
        card the carry is the graph's own buffer, which the next megabatch
        updates: read or copy it before advancing.

        ``start`` (a multiple of ``k_inner``) and ``carry0`` resume a run:
        batches ``start..`` fold into a carry holding ``carry0``'s values
        (ints, one per carry slot), so the stream from there is what an
        unbroken run draws; a captured megabatch resumes by writing them
        into its graph's carry and batch index, without capturing again."""
        k = self.k_inner
        n_run, carry = self._start(n_batches, int(start), carry0)
        if not self._graphed(carry):
            for s in range(int(start), n_run, k):
                carry = profiling.timed_dispatch(
                    lambda c=carry, s=s: _dispatch(lambda: self._megabatch(
                        c, seed, s, *extra)), carry[0].device)
                yield carry, s + k
            return
        entry = self._graphs.get(extra)
        if entry is None:
            entry = self._graphs[extra] = self._capture(extra, carry)
        self.graph_stats = entry.stats
        checked = getattr(_checks, "syncs", False)
        with _sync_mode(checked):
            for c, v in zip(entry.carry, carry):
                c.copy_(v)
            entry.inputs.start(seed, int(start))
        dev = entry.carry[0].device
        for s in range(int(start), n_run, k):
            def replay(s=s):
                with _sync_mode(checked):
                    entry.inputs.before_replay(seed, s)
                    entry.graph.replay()
            profiling.timed_dispatch(lambda: _dispatch(replay), dev)
            self.megabatches += 1
            yield entry.carry, s + k

    def run(self, seed, n_batches: int, *extra):
        """Fold ``n_batches`` batches (rounded up to a k_inner multiple).
        Returns ``(carry, batches_run)``; the carry is unread device
        tensors."""
        carry, done = self._init_fn(), 0
        for carry, done in self.stream(seed, n_batches, *extra):
            pass
        return tuple(c.clone() for c in carry), done

    def run_keys(self, seed, n_batches: int, *extra, start: int = 0,
                 carry0=None):
        """Like ``stream`` but yields ``(host carry, batches_done)``: host
        values per megabatch, drained double-buffered (module docstring),
        one host read each.  A caller that stops early has launched one
        megabatch more than it reads.  ``start`` and ``carry0`` resume a
        run (``stream``)."""
        k = self.k_inner
        n_run = -(-int(n_batches) // k) * k
        it = self.stream(seed, n_batches, *extra, start=start, carry0=carry0)

        def launch(_):
            carry, done = next(it)
            return self.read_launch(carry), done

        def finish(item):
            pending, done = item

            def fetch():
                faultinject.site("megabatch_drain")
                return pending.finish()

            return resilience.guarded_fetch(fetch,
                                            label="megabatch_drain"), done

        yield from drain_double_buffered(launch, finish,
                                         range(int(start), n_run, k))


def _dispatch(fn):
    """One megabatch dispatch under the active resilience policy, behind
    the ``megabatch_dispatch`` fault site: a transient fault before the
    launch retries it (the carry and the batch inputs are rebuilt from
    the same seed and offset, so a retry is bit-exact); a deterministic
    one raises."""

    def attempt():
        faultinject.site("megabatch_dispatch")
        return fn()

    return resilience.run_cell(attempt, label="megabatch_dispatch")


class _PendingRead(NamedTuple):
    """A host read in flight (``MegabatchDriver.read_launch``)."""

    driver: object
    carry: tuple
    host: torch.Tensor
    ready: object
    dev: object
    checked: bool

    def finish(self) -> tuple:
        t0 = time.perf_counter()
        with _sync_mode(self.checked and self.dev is not None):
            if self.ready is not None:
                self.ready.synchronize()
            values = self.host.tolist()
        profiling.record_host_sync(time.perf_counter() - t0)
        self.driver.host_reads += 1
        n = sum(c.numel() for c in self.carry)
        if self.dev is not None:
            _kernels.fold_launch_counts(self.dev,
                                        [int(v) for v in values[n:]])
        return self.driver._unpack(self.carry, values[:n])


def tele_zeros(device) -> torch.Tensor:
    """A zero device telemetry vector (``telemetry.TELE_LEN`` int32): the
    telemetry slot of a carry."""
    return torch.zeros(telemetry.TELE_LEN, dtype=torch.int32, device=device)


def count_min_driver(stats_fn, min_init: int, device, k_inner: int,
                     batch_input, tele: bool = False) -> MegabatchDriver:
    """MegabatchDriver for the ``(failure count, min logical weight)`` fold
    on ``device``; ``min_init`` seeds the min-weight track (the code length
    N).  With ``tele`` the stats function returns a third element, the
    batch's device telemetry vector, which the carry sums."""

    def combine(c, o):
        out = (c[0] + o[0], torch.minimum(c[1], o[1]))
        return out + (c[2] + o[2],) if tele else out

    def init():
        out = (torch.zeros((), dtype=torch.int32, device=device),
               torch.full((), int(min_init), dtype=torch.int32,
                          device=device))
        return out + (tele_zeros(device),) if tele else out

    return MegabatchDriver(stats_fn, combine, init, batch_input,
                           k_inner=k_inner)


class _LaneGenerators:
    """``k`` x ``L`` x ``S`` generators registered with a fused graph:
    batch j of lane l draws, for each of the driver's ``S`` slots, from
    ``gens[j][l][s]``, reseeded before each replay from its batch index of
    the lane plan (``slot_seed``)."""

    def __init__(self, device, k: int, n_lanes: int, slots):
        self.slots = slots
        self.gens = [[[batch_generator(_THROWAWAY, (j * n_lanes + lane)
                                       * len(slots) + s, device)
                       for s in range(len(slots))]
                      for lane in range(n_lanes)] for j in range(k)]

    def warmup(self):
        return batch_generator(_THROWAWAY, 0, self.gens[0][0][0].device)

    def register(self, graph) -> None:
        for row in self.gens:
            for lane in row:
                for gen in lane:
                    graph.register_generator_state(gen)

    def reseed(self, seed, base, stride) -> None:
        for j, row in enumerate(self.gens):
            for lane, gens in enumerate(row):
                b = int(base[lane]) + j * int(stride[lane])
                for gen, slot in zip(gens, self.slots):
                    gen.manual_seed(batch_seed(*slot_seed(seed, b, slot)))


class CellFusedDriver(MegabatchDriver):
    """Megabatch driver of a fused sweep bucket (the JAX package's
    ``CellFusedDriver``): one megabatch advances ``n_cells`` lanes, each
    running ``k_inner`` batches of one (code, p, logical type) cell, and
    folds a carry of per-CELL counters.

    ``stats_fn(generator, cell, *extra)``: one batch of the cell ``cell``
    (a (1,) int64 device index into the bucket's stacked states) drawn from
    ``generator`` -> ``(count, min_w)`` int32 device scalars, and with
    ``weighted`` the four float32 weight moments ``(s1, s2, w1, w2)``
    after them.  The stats function gathers its cell's state; the driver
    masks by ``active`` and adds at the lane's cell.

    Carry: ``(failures (C,) int32, shots (C,) int64, min_w (C,) int32)``,
    with ``weighted`` ``(s1, s2, w1, w2) (C,) float32`` after them, and
    with ``tele`` the bucket's device telemetry vector last (the stats
    function returns a lane-batch's vector last; the active lanes' sum).

    The lane plan, per megabatch, is host vectors ``(lane_base,
    lane_stride, lane_cell, active)``: batch j of lane l draws from
    ``batch_generator(seed, lane_base[l] + j * lane_stride[l])``, the
    serial stream's batch of that index, so a cell's draws are its serial
    run's whichever lane (or lanes) run them.  ``lane_cell`` and
    ``active`` live in device buffers (written by a kernel per changed
    lane), so a changed plan (adaptive reallocation) replays the same
    graph.

    ``slots``: the mesh slots (logical devices) a lane-batch runs, each
    from its own key (``slot_seed``), folded with ``replay_fold``; a
    lane-batch then counts ``batch_size * len(slots)`` shots.  One slot
    ``(d,)`` is device ``d``'s share of a ``MeshCellFusedDriver``, every
    slot ``(0, ..., n-1)`` the mesh's replay on one device.

    On the card a megabatch is one captured CUDA graph per ``extra``: the
    L x k lane units in turn, each the serial cell's unit on its lane's
    gathered state, with L x k registered generators (per slot) reseeded
    before each replay.  Elsewhere the megabatch is the eager loop, which
    skips inactive lanes (they add nothing)."""

    def __init__(self, stats_fn, n_cells: int, batch_size: int,
                 k_inner: int, min_init: int, device,
                 weighted: bool = False, slots=None, tele: bool = False):
        self.n_cells = int(n_cells)
        self.batch_size = int(batch_size)
        self.weighted = bool(weighted)
        self.tele = bool(tele)
        self.device = torch.device(device)
        self.slots = None if slots is None else tuple(int(d) for d in slots)
        self._min_init = int(min_init)
        super().__init__(stats_fn, None, self._init, GeneratorInput(device),
                         k_inner=k_inner)
        C, dev = self.n_cells, self.device
        self._shots_inc = self.batch_size * len(self.slots or (None,))
        self._arange = torch.arange(C, device=dev)
        self._cell = torch.arange(C, device=dev)
        self._active = torch.ones(C, dtype=torch.bool, device=dev)
        self._plan = [(c, True) for c in range(C)]  # the buffers' values

    def _init(self):
        C, dev = self.n_cells, self.device
        carry = (torch.zeros(C, dtype=torch.int32, device=dev),
                 torch.zeros(C, dtype=torch.int64, device=dev),
                 torch.full((C,), self._min_init, dtype=torch.int32,
                            device=dev))
        if self.weighted:
            carry += tuple(torch.zeros(C, dtype=torch.float32, device=dev)
                           for _ in range(4))
        if self.tele:
            carry += (tele_zeros(dev),)
        return carry

    def host_init(self) -> tuple:
        """The initial carry's host values (no device read)."""
        C = self.n_cells
        host = (np.zeros(C, np.int64), np.zeros(C, np.int64),
                np.full(C, self._min_init, np.int64))
        if self.weighted:
            host += tuple(np.zeros(C, np.float64) for _ in range(4))
        if self.tele:
            host += (np.zeros(telemetry.TELE_LEN, np.int64),)
        return host

    def _unit(self, gens, lane: int, extra):
        """Lane ``lane``'s batch on each slot's generator of ``gens``, the
        slots folded."""
        outs = [self._stats_fn(gen, self._lane(lane), *extra) for gen in gens]
        if len(outs) == 1:
            return outs[0]
        return replay_fold(outs, n_w=4 if self.weighted else 0,
                           has_tele=self.tele)

    def _fold(self, carry, lane: int, out):
        """Add lane ``lane``'s batch ``out`` at its cell if it is active:
        the cell's slots take the serial fold (``c + o``, ``min(c, o)``),
        every other slot keeps its value."""
        hit = (self._arange == self._cell[lane]) & self._active[lane]
        new = (torch.where(hit, carry[0] + out[0], carry[0]),
               torch.where(hit, carry[1] + self._shots_inc, carry[1]),
               torch.where(hit, torch.minimum(carry[2], out[1]), carry[2]))
        if self.weighted:
            new += tuple(torch.where(hit, carry[3 + i] + out[2 + i],
                                     carry[3 + i]) for i in range(4))
        if self.tele:
            new += (torch.where(self._active[lane], carry[-1] + out[-1],
                                carry[-1]),)
        return new

    def _lane(self, lane: int):
        return self._cell[lane:lane + 1]

    def _write_plan(self, cells, active) -> None:
        for lane, (c, a) in enumerate(zip(cells, active)):
            want = (int(c), bool(a))
            if self._plan[lane] != want:
                self._cell[lane].fill_(want[0])
                self._active[lane].fill_(want[1])
                self._plan[lane] = want

    def _megabatch_plan(self, carry, seed, base, stride, active, *extra):
        for j in range(self.k_inner):
            for lane in range(self.n_cells):
                if not active[lane]:
                    continue
                b = int(base[lane]) + j * int(stride[lane])
                gens = [batch_generator(*slot_seed(seed, b, slot),
                                        self.device)
                        for slot in self.slots or (None,)]
                carry = self._fold(carry, lane, self._unit(gens, lane, extra))
        self.megabatches += 1
        return carry

    def _capture(self, extra, carry) -> _Graph:
        inputs = _LaneGenerators(self.device, self.k_inner, self.n_cells,
                                 self.slots or (None,))

        def megabatch():
            new = carry
            for j in range(self.k_inner):
                for lane in range(self.n_cells):
                    new = self._fold(new, lane, self._unit(
                        inputs.gens[j][lane], lane, extra))
            for c, v in zip(carry, new):
                c.copy_(v)

        graph, _, body_pool, stats = _capture_graph(
            self.device, lambda: self._stats_fn(inputs.warmup(),
                                                self._lane(0), *extra),
            megabatch, inputs.register,
            label=f"fused_cells.c{self.n_cells}.k{self.k_inner}")
        return _Graph(graph, carry, inputs, body_pool, stats)

    def degrade_mesh(self) -> None:
        """The ``mesh_replan`` rung of the JAX package's driver: a no-op
        for a driver on one device (``MeshCellFusedDriver`` runs a mesh)."""

    def dispatch_plan(self, carry, seed, plan, *extra):
        """``dispatch`` under the JAX package's name."""
        return self.dispatch(carry, seed, plan, *extra)

    def dispatch(self, carry, seed, plan, *extra):
        """One megabatch of every lane under the host lane plan ``(base,
        stride, cell, active)``, folded into ``carry``; returns the new
        carry (on the card the graph's own buffers, which the next
        dispatch updates)."""
        base, stride, cells, active = plan
        self._write_plan(cells, active)
        if not self._graphed(carry):
            return profiling.timed_dispatch(
                lambda: self._megabatch_plan(carry, seed, base, stride,
                                             active, *extra), self.device)
        entry = self._graphs.get(extra)
        if entry is None:
            entry = self._graphs[extra] = self._capture(extra, carry)
        self.graph_stats = entry.stats

        def replay():
            with _sync_mode(getattr(_checks, "syncs", False)):
                if carry is not entry.carry:
                    for c, v in zip(entry.carry, carry):
                        c.copy_(v)
                entry.inputs.reseed(seed, base, stride)
                entry.graph.replay()

        profiling.timed_dispatch(replay, self.device)
        self.megabatches += 1
        return entry.carry

    def stream_plan(self, seed, n_batches: int, *extra, start: int = 0,
                    carry0=None):
        """The fixed-budget stream: lane l runs cell l, every cell batches
        ``[start, n_run)`` in lockstep; yields ``(carry, batches_done)``
        after each megabatch.  ``start`` and ``carry0`` (host values per
        slot) resume it, as ``MegabatchDriver.stream``."""
        k, C = self.k_inner, self.n_cells
        n_run, carry = self._start(n_batches, int(start), carry0)
        cells, active, stride = list(range(C)), [True] * C, [1] * C
        for s in range(int(start), n_run, k):
            carry = self.dispatch(carry, seed, ([s] * C, stride, cells,
                                                active), *extra)
            yield carry, s + k

    def run_plan(self, seed, n_batches: int, *extra, start: int = 0,
                 carry0=None):
        """Fold the fixed-budget stream with no host read: ``(carry,
        batches run)``, the carry unread device tensors."""
        carry, done = None, int(start)
        for carry, done in self.stream_plan(seed, n_batches, *extra,
                                            start=start, carry0=carry0):
            pass
        if carry is None:
            _, carry = self._start(n_batches, int(start), carry0)
        return carry, done

    def run_plan_keys(self, seed, n_batches: int, *extra, start: int = 0,
                      carry0=None):
        """``run_plan`` drained megabatch by megabatch: yields ``(host
        carry, batches_done)``, double-buffered, one host read each."""
        k = self.k_inner
        n_run = -(-int(n_batches) // k) * k
        it = self.stream_plan(seed, n_batches, *extra, start=start,
                              carry0=carry0)

        def launch(_):
            carry, done = next(it)
            return self.read_launch(carry), done

        def finish(item):
            pending, done = item
            return pending.finish(), done

        yield from drain_double_buffered(launch, finish,
                                         range(int(start), n_run, k))


def _fold_cells(hosts, weighted: bool) -> tuple:
    """Fold fused host carries ``(failures, shots, min_w[, s1, s2, w1,
    w2])`` of a mesh's devices in device order: counts, shots and moments
    summed, min weights minimized."""
    out = list(hosts[0])
    for host in hosts[1:]:
        for i, x in enumerate(host):
            out[i] = np.minimum(out[i], x) if i == 2 else out[i] + x
    return tuple(out)


class _MeshRead(NamedTuple):
    """Host reads of every device's carry in flight; ``finish`` waits for
    each and folds them."""

    reads: list
    weighted: bool

    def finish(self) -> tuple:
        return _fold_cells([r.finish() for r in self.reads], self.weighted)


class MeshCellFusedDriver:
    """A fused bucket sharded over a ``ShotMesh`` (the JAX package's
    ``CellFusedDriver(mesh=)``): every mesh device runs all lanes at the
    lane batch size, device ``d`` from its keys ``mesh_key(seed, b, d)``
    (``fold_in(key_lane, d)``), in a ``CellFusedDriver`` of slot ``(d,)``
    on its replica of the bucket's state (``replicate(device)`` gives that
    device's stats function).  Each device's carry stays on it; the host
    reads every device's carry (every launch before any read) and folds the
    per-cell vectors.  A lane-batch counts ``batch_size * n_dev`` shots.

    The carry is one ``CellFusedDriver`` carry per device, in a list; a
    resumed run's ``carry0`` goes to device 0's and the others start from
    the initial carry, which the fold leaves unchanged.

    ``degrade_mesh()`` (the ``mesh_replan`` rung, called directly) swaps
    the devices for one ``CellFusedDriver`` on the first mesh device that
    runs every slot's keys in turn, ``replay_fold``-ed: its counts and min
    weights are the mesh run's bit for bit, its float moments up to the
    order of summation."""

    def __init__(self, replicate, n_cells: int, batch_size: int,
                 k_inner: int, min_init: int, mesh: ShotMesh,
                 weighted: bool = False, tele: bool = False):
        self.mesh = mesh
        self.n_cells = int(n_cells)
        self.batch_size = int(batch_size)
        self.k_inner = max(1, int(k_inner))
        self.weighted = bool(weighted)
        self.tele = bool(tele)
        self.device = mesh.devices[0]
        self.mesh_degraded = False
        self._replicate = replicate
        self._min_init = int(min_init)
        self.subs = [self._sub(dev, (d,))
                     for d, dev in enumerate(mesh.devices)]

    def _sub(self, device, slots) -> CellFusedDriver:
        return CellFusedDriver(self._replicate(device), self.n_cells,
                               self.batch_size, self.k_inner, self._min_init,
                               device, weighted=self.weighted, slots=slots,
                               tele=self.tele)

    def degrade_mesh(self) -> None:
        """Run the mesh's key streams in turn on its first device from the
        next dispatch on (idempotent); counted in telemetry's
        ``mesh.replans``."""
        if self.mesh_degraded:
            return
        self.mesh_degraded = True
        telemetry.count("mesh.replans")
        self.release()
        self.subs = [self._sub(self.device, tuple(range(self.mesh.size)))]

    @property
    def devices(self) -> tuple:
        return tuple(dict.fromkeys(sub.device for sub in self.subs))

    @property
    def megabatches(self) -> int:
        return sum(sub.megabatches for sub in self.subs)

    @property
    def host_reads(self) -> int:
        return sum(sub.host_reads for sub in self.subs)

    @property
    def graph_stats(self):
        return self.subs[0].graph_stats

    @property
    def _graphs(self) -> dict:
        return {(d, k): g for d, sub in enumerate(self.subs)
                for k, g in sub._graphs.items()}

    def release(self) -> None:
        for sub in self.subs:
            sub.release()

    def host_init(self) -> tuple:
        return self.subs[0].host_init()

    def _init_fn(self) -> list:
        return [sub._init_fn() for sub in self.subs]

    def _fill(self, carry, values) -> None:
        self.subs[0]._fill(carry[0], values)

    def read_launch(self, carry) -> _MeshRead:
        return _MeshRead([sub.read_launch(c)
                          for sub, c in zip(self.subs, carry)],
                         self.weighted)

    def read(self, carry) -> tuple:
        return self.read_launch(carry).finish()

    def dispatch(self, carry, seed, plan, *extra) -> list:
        return [sub.dispatch(c, seed, plan, *extra)
                for sub, c in zip(self.subs, carry)]

    def run_plan(self, seed, n_batches: int, *extra, start: int = 0,
                 carry0=None):
        """Every device's fixed-budget fold, launched device after device
        with no host read: ``(carry, batches run)``."""
        carry, done = [], int(start)
        for d, sub in enumerate(self.subs):
            c, done = sub.run_plan(seed, n_batches, *extra, start=start,
                                   carry0=carry0 if d == 0 else None)
            carry.append(c)
        return carry, done

    def run_plan_keys(self, seed, n_batches: int, *extra, start: int = 0,
                      carry0=None):
        """``run_plan`` drained megabatch by megabatch: every device's
        megabatch launched, then their reads, double-buffered; yields the
        folded ``(host carry, batches_done)``."""
        k = self.k_inner
        n_run = -(-int(n_batches) // k) * k
        its = [sub.stream_plan(seed, n_batches, *extra, start=start,
                               carry0=carry0 if d == 0 else None)
               for d, sub in enumerate(self.subs)]

        def launch(_):
            steps = [next(it) for it in its]
            return (self.read_launch([c for c, _ in steps]), steps[0][1])

        def finish(item):
            pending, done = item
            return pending.finish(), done

        yield from drain_double_buffered(launch, finish,
                                         range(int(start), n_run, k))


def cell_fused_driver(stats_fn, n_cells: int, batch_size: int, k_inner: int,
                      *, min_init: int, device, weighted: bool = False,
                      mesh=None, replicate=None, tele: bool = False):
    """A ``CellFusedDriver`` for one bucket (its graph is captured once,
    at its first megabatch, and replayed for every megabatch and plan), or
    with a ``ShotMesh`` a ``MeshCellFusedDriver`` whose device ``dev``
    runs ``replicate(dev)`` (the bucket's stats function on that device's
    replica of its state; ``stats_fn`` itself where ``replicate`` is
    None)."""
    if check_mesh(mesh) is None:
        return CellFusedDriver(stats_fn, n_cells, batch_size, k_inner,
                               min_init, device, weighted=weighted, tele=tele)
    return MeshCellFusedDriver(
        replicate or (lambda dev: stats_fn), n_cells, batch_size, k_inner,
        min_init, mesh, weighted=weighted, tele=tele)


class CapturedStep:
    """One fixed-shape step of a stream, replayed from a CUDA graph on the
    card: ``body(generator, carry) -> (new carry, outputs)`` over device
    tensors, ``carry`` a tuple that the step updates in place (the new
    carry is copied into it).

    On the card the first call warms every branch up (``device_cond``'s
    both-branches hook, on a throwaway generator, its carry left as it
    was), captures one step, ``generator`` registered with the graph, and
    every call replays it: no host read, and the registered generator's
    Philox offset advances by one step's draws a replay, so step i draws
    what the i-th step draws eagerly.  The outputs are the graph's own
    buffers, which the next call overwrites.  Elsewhere (the CPU,
    ``force_plain()``, ``force_eager()``) a call runs ``body`` eagerly.
    ``generator`` may be None for a body that draws nothing."""

    def __init__(self, body, carry: tuple, generator=None):
        self._body = body
        self.carry = carry
        self.generator = generator
        self._graph = None  # (graph, outputs, body pool)
        self.graph_stats = None

    def _graphed(self) -> bool:
        return (self.carry[0].is_cuda and not _kernels.plain_forced()
                and not _kernels.eager_forced())

    def _step(self, generator):
        new, outs = self._body(generator, self.carry)
        for c, v in zip(self.carry, new):
            c.copy_(v)
        return outs

    def _capture(self):
        dev = self.carry[0].device
        gen = self.generator
        throwaway = (None if gen is None
                     else batch_generator(_THROWAWAY, 0, dev))
        graph, outs, body_pool, self.graph_stats = _capture_graph(
            dev, lambda: self._body(throwaway, self.carry),
            lambda: self._step(gen),
            None if gen is None
            else lambda graph: graph.register_generator_state(gen),
            label="stream_step")
        self._graph = (graph, outs, body_pool)

    def __call__(self):
        if not self._graphed():
            return self._step(self.generator)
        if self._graph is None:
            self._capture()
        graph, outs, _ = self._graph
        with _sync_mode(getattr(_checks, "syncs", False)):
            graph.replay()
        return outs
