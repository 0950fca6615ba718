"""Host telemetry: metrics registry, timing spans, run events, sinks.

The port's counterpart of the JAX package's ``utils/telemetry.py``, host
registry only:

  * a process-wide, thread-safe **metrics registry** — counters and the
    spans' fixed-bucket histograms — with an in-memory ``snapshot``;
  * hierarchical **timing spans** whose wall-clock lands in per-span
    duration histograms;
  * **run events** (``event``) to pluggable **sinks**: a JSONL stream
    (``QLDPC_TELEMETRY_JSONL`` or ``enable(path)``) and an in-memory list;
  * ``session`` for one enabled region.

Everything is behind one enable switch and costs nothing when disabled:
every hot-path helper (``count`` / ``span`` / ``event``) starts with a
single module-global boolean check.

Not here yet (ROADMAP queue A item 10): gauges, the device telemetry
vector (BP convergence and iteration histograms folded through the
megabatch carry), the compile tracker, the event schema registry and the
Prometheus text.
"""
from __future__ import annotations

import contextlib
import json
import os
import platform
import threading
import time

__all__ = [
    "enabled", "enable", "disable", "reset", "session",
    "count", "span", "event", "snapshot",
    "add_sink", "remove_sink", "JsonlSink", "MemorySink",
    "write_snapshot_event", "process_info",
]

# span-duration histogram edges (seconds, ~half-decade)
DEFAULT_TIME_BUCKETS = (
    1e-4, 3.2e-4, 1e-3, 3.2e-3, 1e-2, 3.2e-2, 0.1, 0.32, 1.0, 3.2, 10.0,
    32.0, 100.0,
)


class Counter:
    """Monotonic counter.  ``inc`` under the registry lock."""

    kind = "counter"

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self.value = 0

    def inc(self, n=1):
        with self._lock:
            self.value += n

    def to_dict(self):
        return {"type": "counter", "value": self.value}


class Histogram:
    """Fixed-bucket histogram: counts per upper-inclusive edge + overflow,
    plus exact ``sum``/``count``."""

    kind = "histogram"

    def __init__(self, name: str, lock: threading.Lock, buckets=None):
        self.name = name
        self._lock = lock
        self.buckets = tuple(buckets if buckets is not None
                             else DEFAULT_TIME_BUCKETS)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def _bucket_index(self, v) -> int:
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                return i
        return len(self.buckets)

    def observe(self, v):
        with self._lock:
            self.counts[self._bucket_index(v)] += 1
            self.sum += v
            self.count += 1

    def to_dict(self):
        return {
            "type": "histogram", "buckets": list(self.buckets),
            "counts": list(self.counts), "sum": self.sum, "count": self.count,
            "mean": (self.sum / self.count) if self.count else None,
        }


class MetricsRegistry:
    """Process-wide, thread-safe name -> metric map; one lock guards
    creation and every mutation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(name, self._lock, **kw)
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def histogram(self, name: str, buckets=None) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    def snapshot(self) -> dict:
        """{name: metric dict}, a copy built under the shared lock."""
        with self._lock:
            return {name: m.to_dict()
                    for name, m in sorted(self._metrics.items())}

    def reset(self):
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()
_ENABLED = False            # the single hot-path check
_SINKS: list = []
_SINKS_SNAPSHOT: tuple = ()  # lock-free read copy for the event hot path
_SINK_LOCK = threading.Lock()
_SPAN_STACK = threading.local()


def enabled() -> bool:
    return _ENABLED


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def reset() -> None:
    """Clear all metrics (the enable switch and sinks are untouched)."""
    _REGISTRY.reset()


def count(name: str, n=1) -> None:
    if not _ENABLED:
        return
    _REGISTRY.counter(name).inc(n)


@contextlib.contextmanager
def _span_enabled(name: str):
    stack = getattr(_SPAN_STACK, "stack", None)
    if stack is None:
        stack = _SPAN_STACK.stack = []
    path = "/".join(stack + [name]) if stack else name
    stack.append(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        _REGISTRY.histogram(f"span.{path}.seconds").observe(dt)


def span(name: str):
    """Hierarchical timing span: nested spans join into a ``/``-path (per
    thread), each recording its wall-clock into ``span.<path>.seconds``.
    A no-op context when disabled."""
    if not _ENABLED:
        return contextlib.nullcontext()
    return _span_enabled(name)


def event(kind: str, **fields) -> None:
    """Emit one structured run event to every installed sink.  No-op when
    disabled or without sinks."""
    if not _ENABLED or not _SINKS_SNAPSHOT:
        return
    rec = {"ts": round(time.time(), 6), "kind": kind, **fields}
    for s in _SINKS_SNAPSHOT:
        try:
            s.emit(rec)
        except Exception:  # a broken sink must not kill the run
            pass


class JsonlSink:
    """Append-only JSONL event stream, flushed per event so a crashed run
    keeps its tail."""

    def __init__(self, path: str):
        self.path = str(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", encoding="utf-8")

    def emit(self, record: dict):
        line = json.dumps(record, sort_keys=True, default=str)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self):
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


class MemorySink:
    """Collects events in a list (tests, notebooks)."""

    def __init__(self):
        self.records: list[dict] = []
        self._lock = threading.Lock()

    def emit(self, record: dict):
        with self._lock:
            self.records.append(record)

    def close(self):
        pass


def add_sink(sink) -> None:
    global _SINKS_SNAPSHOT
    with _SINK_LOCK:
        _SINKS.append(sink)
        _SINKS_SNAPSHOT = tuple(_SINKS)


def remove_sink(sink) -> None:
    global _SINKS_SNAPSHOT
    with _SINK_LOCK:
        if sink in _SINKS:
            _SINKS.remove(sink)
        _SINKS_SNAPSHOT = tuple(_SINKS)


def write_snapshot_event(**extra_fields) -> dict:
    """Emit the metrics snapshot as one ``kind="snapshot"`` event; returns
    the snapshot."""
    snap = snapshot()
    event("snapshot", metrics=snap, **extra_fields)
    return snap


def process_info() -> dict:
    """Environment provenance for the run ledger: pid, hostname, python
    and platform strings, and the torch version and CUDA build when torch
    is already imported (this never imports it)."""
    import sys

    info = {"pid": os.getpid(), "hostname": platform.node() or "unknown",
            "python": platform.python_version(),
            "platform": platform.platform(), "torch": None, "cuda": None}
    torch = sys.modules.get("torch")
    if torch is not None:
        info["torch"] = str(torch.__version__)
        info["cuda"] = getattr(torch.version, "cuda", None)
    return info


_OWNED_SINKS: list = []


def enable(jsonl_path: str | None = None) -> None:
    """Turn telemetry on.  ``jsonl_path`` (or the ``QLDPC_TELEMETRY_JSONL``
    environment variable when no path is given) additionally streams run
    events to a JSONL file.  A second ``enable`` keeps the switch and the
    existing sinks; an explicit new path still gets its sink."""
    global _ENABLED
    if jsonl_path is None and not _ENABLED:
        jsonl_path = os.environ.get("QLDPC_TELEMETRY_JSONL") or None
    if jsonl_path is not None:
        with _SINK_LOCK:
            streaming = any(isinstance(s, JsonlSink)
                            and s.path == str(jsonl_path) for s in _SINKS)
        if not streaming:
            s = JsonlSink(jsonl_path)
            with _SINK_LOCK:
                _OWNED_SINKS.append(s)
            add_sink(s)
    if _ENABLED:
        return
    _ENABLED = True
    event("telemetry_enabled", pid=os.getpid())
    event("process_info", **process_info())


def disable() -> None:
    """Turn telemetry off and close the sinks ``enable`` opened.  Metrics
    stay in the registry until ``reset()``."""
    global _ENABLED
    _ENABLED = False
    with _SINK_LOCK:
        owned = list(_OWNED_SINKS)
        _OWNED_SINKS.clear()
    for s in owned:
        remove_sink(s)
        s.close()


@contextlib.contextmanager
def session(jsonl_path: str | None = None, reset_metrics: bool = True):
    """One telemetry-enabled region: enable, yield the registry, emit a
    final snapshot event, disable.  Inside an already-enabled region it
    leaves the outer enable, sinks and metrics as they are
    (``reset_metrics`` ignored), though ``jsonl_path`` still gets its own
    stream for the session's events."""
    was_enabled = _ENABLED
    own_sink = None
    if was_enabled:
        if jsonl_path is not None:
            own_sink = JsonlSink(jsonl_path)
            add_sink(own_sink)
    else:
        if reset_metrics:
            reset()
        enable(jsonl_path)
    try:
        yield _REGISTRY
    finally:
        write_snapshot_event()
        if own_sink is not None:
            remove_sink(own_sink)
            own_sink.close()
        if not was_enabled:
            disable()
