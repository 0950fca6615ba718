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
from ..ops.prng import fold_in, fold_in_device
from ..utils import device as _device

__all__ = ["batch_seed", "batch_generator", "GeneratorInput", "KeyInput",
           "MegabatchDriver", "count_min_driver", "drain_double_buffered",
           "check_syncs", "CapturedStep"]


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


class GeneratorInput:
    """Batch ``j`` draws from ``batch_generator(seed, j, device)``."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __call__(self, seed, j: int) -> torch.Generator:
        return batch_generator(seed, j, self.device)

    def captured(self, k: int):
        return _CapturedGenerators(self.device, k)


class _CapturedGenerators:
    """``k`` generators registered with the graph, reseeded before each
    replay."""

    def __init__(self, device, k: int):
        self.gens = [batch_generator(_THROWAWAY, j, device) for j in range(k)]

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
            gen.manual_seed(batch_seed(seed, offset + j))


class KeyInput:
    """Batch ``j`` draws from the counter-PRNG key ``fold_in(seed, j)``."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __call__(self, seed, j: int):
        return fold_in(seed, j)

    def captured(self, k: int):
        return _CapturedKeys(self.device, k)


class _CapturedKeys:
    """The run's key words and the next batch index on the device; the
    graph folds ``k`` keys from them and advances the index by ``k``."""

    def __init__(self, device, k: int):
        self.k = k
        self.base = torch.tensor(_THROWAWAY, dtype=torch.int64).to(device)
        self.index = torch.zeros((), dtype=torch.int64, device=device)

    def warmup(self):
        return fold_in(_THROWAWAY, 0)

    def register(self, graph) -> None:
        pass

    def inputs(self):
        j = self.index + torch.arange(self.k, device=self.index.device)
        keys = fold_in_device(self.base, j)
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


def _capture_graph(dev, warmup, body, register=None):
    """``warmup()`` under ``device_cond``'s both-branches hook on a side
    stream (counting no launch), then ``body()`` captured into a CUDA graph
    (``register(graph)`` first, for its generators) and instantiated.
    Returns (graph, body's outputs, the pool its conditional bodies
    allocate from, which must live as long as the graph, and what the
    capture cost)."""
    _kernels.launch_counts(dev)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    t0 = time.perf_counter()
    with (torch.cuda.stream(stream), _device._both_branches(),
          _kernels.uncounted()):
        warmup()
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    if register is not None:
        register(graph)
    with _device.graph_capture(graph, dev, stream) as rec:
        outs = body()
    t2 = time.perf_counter()
    graph.instantiate()
    t3 = time.perf_counter()
    stats = {"warmup_s": t1 - t0, "capture_s": t2 - t1,
             "instantiate_s": t3 - t2,
             "nodes": _device.graph_nodes(graph) + rec.body_nodes}
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
            megabatch, inputs.register)
        return _Graph(graph, carry, inputs, body_pool, stats)

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
            if len(carry0) != len(carry):
                raise ValueError(f"carry0 has {len(carry0)} values, the "
                                 f"carry {len(carry)}")
            # a kernel each, the value as its argument (no host read)
            for c, v in zip(carry, carry0):
                c.fill_(int(v))
        return n_run, carry

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
                carry = self._megabatch(carry, seed, s, *extra)
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
        for s in range(int(start), n_run, k):
            with _sync_mode(checked):
                entry.inputs.before_replay(seed, s)
                entry.graph.replay()
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
        """Like ``stream`` but yields ``(host carry, batches_done)``: a
        tuple of ints per megabatch, drained double-buffered (module
        docstring), one host read each.  A caller that stops early has
        launched one megabatch more than it reads.  ``start`` and
        ``carry0`` resume a run (``stream``)."""
        k = self.k_inner
        n_run = -(-int(n_batches) // k) * k
        it = self.stream(seed, n_batches, *extra, start=start, carry0=carry0)
        checked = getattr(_checks, "syncs", False)

        def launch(_):
            carry, done = next(it)
            # a replayed graph's launch counts ride with its carry
            dev = carry[0].device if self._graphed(carry) else None
            ready = None
            with _sync_mode(checked and dev is not None):
                snap = torch.stack([c.to(torch.int64) for c in carry])
                if dev is not None:
                    snap = torch.cat([snap, _kernels.launch_counts(dev)])
                if snap.is_cuda:
                    host = torch.empty(snap.shape, dtype=snap.dtype,
                                       pin_memory=True)
                    host.copy_(snap, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record()
                else:
                    host = snap
            return host, ready, dev, len(carry), done

        def finish(item):
            host, ready, dev, n_carry, done = item
            with _sync_mode(checked and dev is not None):
                if ready is not None:
                    ready.synchronize()
                values = host.tolist()
            self.host_reads += 1
            if dev is not None:
                _kernels.fold_launch_counts(dev, values[n_carry:])
            return tuple(values[:n_carry]), done

        yield from drain_double_buffered(launch, finish,
                                         range(int(start), n_run, k))


def count_min_driver(stats_fn, min_init: int, device, k_inner: int,
                     batch_input) -> MegabatchDriver:
    """MegabatchDriver for the ``(failure count, min logical weight)`` fold
    on ``device``; ``min_init`` seeds the min-weight track (the code length
    N)."""

    def combine(c, o):
        return (c[0] + o[0], torch.minimum(c[1], o[1]))

    def init():
        return (torch.zeros((), dtype=torch.int32, device=device),
                torch.full((), int(min_init), dtype=torch.int32,
                           device=device))

    return MegabatchDriver(stats_fn, combine, init, batch_input,
                           k_inner=k_inner)


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
            else lambda graph: graph.register_generator_state(gen))
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
