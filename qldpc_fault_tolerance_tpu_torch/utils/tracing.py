"""End-to-end request tracing + an always-on flight recorder.

The serve stack's telemetry is aggregate-only: counters and
histograms say *that* p99 regressed, but no single request can be followed
from wire frame through queue, batch assembly, graph dispatch and response —
and when a dispatch dies under the resilience ladder, the events that would
explain it are already gone.  This module adds both missing pieces:

  * **Trace-context propagation** — a client mints a ``(trace_id,
    span_id)`` pair that rides an optional field in the JSON wire frame
    (backward compatible: old clients simply omit it), flows through the
    ``ContinuousBatcher`` queues as part of the request, and every stage
    of the request's life (queue_wait, batch_assemble, pad, device_decode
    amortized per batch, slice, respond) lands as one **span**: a
    ``trace`` event in the versioned telemetry JSONL stream plus an entry
    in the flight-recorder ring.  ``trace_tree`` / ``traces_from_records``
    reassemble the span tree per trace id for ``/tracez`` and tests.

  * **Flight recorder** — a bounded, lock-cheap ring buffer of the last N
    spans/events per process (``collections.deque(maxlen=...)``; appends
    are GIL-atomic, so the hot path takes NO lock).  It is always on:
    recording costs one dict build + one deque append, so the service can
    afford it per request, and when something dies the ring holds exactly
    the requests and spans that were in flight.  ``utils.resilience`` and
    ``utils.faultinject`` call ``note_failure`` on watchdog timeouts,
    ladder degrades and exhausted retries, which dumps the ring to a
    postmortem JSONL (``QLDPC_POSTMORTEM_DIR`` or ``configure``) — the
    black box a crashed batch ships home.

Nothing here touches the sweep hot path: engines never call into this
module, and the serve-side cost per untraced request is a few ring
appends.  Trace *events* additionally flow to the telemetry sinks only
when telemetry is enabled (the usual free-when-disabled switch).
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time

from . import telemetry

__all__ = [
    "TraceContext",
    "new_id",
    "record_span",
    "span",
    "FlightRecorder",
    "recorder",
    "configure",
    "flight_record",
    "note_failure",
    "dump_postmortem",
    "postmortem_dir",
    "traces_from_records",
    "trace_tree",
    "trace_summaries",
]

# wire-controlled strings are bounded before they reach the ring or the
# event stream: a hostile client must not grow records without limit
_MAX_ID_CHARS = 64

# id generation is on the per-span hot path, and ``os.urandom`` is a
# syscall per call (tens of µs on some hosts, which alone would blow a
# small tracing-overhead budget).  Trace
# ids need UNIQUENESS, not cryptographic strength: one urandom seeds a
# per-process prefix, and an atomic counter (``itertools.count``; CPython
# GIL-atomic) makes every id distinct within the process.
_ID_PREFIX = os.urandom(4).hex()
_ID_COUNTER = itertools.count(1)


def new_id(nbytes: int = 8) -> str:
    """A unique hex id (16 chars by default) for trace/span ids:
    ``<8-char process-random prefix><counter hex>``."""
    width = max(2, 2 * int(nbytes) - 8)
    return f"{_ID_PREFIX}{next(_ID_COUNTER):0{width}x}"


class TraceContext:
    """One request's position in a trace: the trace id plus the span the
    next recorded span should parent to.  ``child()`` mints a new span id
    under the same trace — the propagation primitive."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str | None = None,
                 span_id: str | None = None):
        self.trace_id = str(trace_id) if trace_id else new_id(16)
        self.span_id = str(span_id) if span_id else new_id(8)

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, new_id(8))

    def to_wire(self) -> dict:
        """The optional ``"trace"`` field of a decode frame."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_wire(cls, obj) -> "TraceContext | None":
        """Parse the optional wire field; anything malformed (wrong type,
        oversized, missing trace_id) is DROPPED, not an error — a bad
        trace annotation must never fail the decode it rides on."""
        if not isinstance(obj, dict):
            return None
        tid = obj.get("trace_id")
        if not isinstance(tid, str) or not tid or len(tid) > _MAX_ID_CHARS:
            return None
        sid = obj.get("span_id")
        if not isinstance(sid, str) or not sid or len(sid) > _MAX_ID_CHARS:
            sid = None
        return cls(tid, sid or new_id(8))

    def __repr__(self):
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"


# ---------------------------------------------------------------------------
# Flight recorder: bounded ring, postmortem dumps
# ---------------------------------------------------------------------------
class FlightRecorder:
    """Bounded ring of the last ``capacity`` records (dicts).

    The append path is deliberately lock-free: ``deque.append`` with a
    ``maxlen`` is atomic under the GIL, so concurrent scheduler / server /
    watchdog threads record without contention.  ``snapshot()`` copies the
    ring (a point-in-time view; a concurrent append may or may not be
    included, which is fine for a black box)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(16, int(capacity))
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=self.capacity)
        self._dump_lock = threading.Lock()
        self._dump_seq = itertools.count(1)

    def record(self, kind: str, **fields) -> dict:
        rec = {"ts": round(time.time(), 6), "kind": str(kind), **fields}
        self._ring.append(rec)
        return rec

    def append(self, rec: dict) -> None:
        self._ring.append(rec)

    def snapshot(self) -> list[dict]:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)

    def dump(self, reason: str, directory: str, extra: dict | None = None,
             ) -> str:
        """Write the ring to ``<directory>/postmortem-<pid>-<seq>-<reason>
        .jsonl``: one header line naming the reason + process, then every
        ring record oldest-first.  Returns the path.

        The write is ATOMIC (tmp file + fsync + ``os.replace``) — the same
        torn-line discipline utils/checkpoint.py applies to its appends: a
        postmortem is dumped precisely because something is dying, so a
        crash mid-dump is the expected case, and a half-written JSONL
        would choke the reassembly tooling (``traces_from_records`` over a
        parsed dump) that reads it afterwards.  The dump either appears
        whole under its final name or not at all."""
        os.makedirs(directory, exist_ok=True)
        with self._dump_lock:
            seq = next(self._dump_seq)
        safe = "".join(c if (c.isalnum() or c in "-_") else "_"
                       for c in str(reason))[:48] or "unknown"
        path = os.path.join(
            directory, f"postmortem-{os.getpid()}-{seq:04d}-{safe}.jsonl")
        records = self.snapshot()
        header = {
            "kind": "postmortem", "reason": str(reason),
            "ts": round(time.time(), 6), "pid": os.getpid(),
            "capacity": self.capacity, "records": len(records),
        }
        if extra:
            header.update(extra)
        tmp = f"{path}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(json.dumps(header, sort_keys=True, default=str)
                         + "\n")
                for rec in records:
                    fh.write(json.dumps(rec, sort_keys=True, default=str)
                             + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except BaseException:
            # never leave the torn tmp behind to be globbed up later
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path


_RECORDER = FlightRecorder(
    int(os.environ.get("QLDPC_FLIGHT_RECORDER_CAPACITY", "4096") or 4096))
_POSTMORTEM_DIR: str | None = None


def recorder() -> FlightRecorder:
    return _RECORDER


def configure(capacity: int | None = None,
              postmortem_dir: str | None = None) -> FlightRecorder:
    """Re-size the process flight recorder and/or set the postmortem
    directory (overrides the ``QLDPC_POSTMORTEM_DIR`` env var).  Returns
    the active recorder.  Resizing replaces the ring (records carry
    over, newest-first truncated to the new capacity)."""
    global _RECORDER, _POSTMORTEM_DIR
    if capacity is not None and int(capacity) != _RECORDER.capacity:
        fresh = FlightRecorder(int(capacity))
        for rec in _RECORDER.snapshot()[-fresh.capacity:]:
            fresh.append(rec)
        _RECORDER = fresh
    if postmortem_dir is not None:
        _POSTMORTEM_DIR = str(postmortem_dir) or None
    return _RECORDER


def postmortem_dir() -> str | None:
    """Where postmortems land: ``configure()`` wins, else the
    ``QLDPC_POSTMORTEM_DIR`` env var, else None (dumps are no-ops)."""
    if _POSTMORTEM_DIR is not None:
        return _POSTMORTEM_DIR
    env = os.environ.get("QLDPC_POSTMORTEM_DIR", "").strip()
    return env or None


def flight_record(kind: str, **fields) -> None:
    """Append one record to the process flight-recorder ring (always on,
    lock-free)."""
    _RECORDER.record(kind, **fields)


def dump_postmortem(reason: str, extra: dict | None = None) -> str | None:
    """Dump the ring to the postmortem directory; a no-op (returns None)
    when no directory is configured — sweeps and tests that never opt in
    pay nothing and write nothing."""
    directory = postmortem_dir()
    if not directory:
        return None
    try:
        path = _RECORDER.dump(reason, directory, extra=extra)
    except OSError:
        return None  # a full disk must not mask the failure being recorded
    telemetry.count("tracing.postmortems")
    return path


def note_failure(reason: str, **fields) -> str | None:
    """The resilience/faultinject hook: record the failure into the ring,
    then ship a postmortem naming it (when a directory is configured).
    Returns the postmortem path, if one was written."""
    _RECORDER.record("failure", reason=str(reason), **fields)
    return dump_postmortem(reason, extra=fields or None)


# ---------------------------------------------------------------------------
# Span recording
# ---------------------------------------------------------------------------
_UNSET = object()


def record_span(name: str, ctx: "TraceContext | None", *,
                span_id: str | None = None, parent_id=_UNSET,
                t0: float | None = None, dur_s: float,
                **attrs) -> "dict | None":
    """Record one span of ``ctx``'s trace: always into the flight-recorder
    ring, and as a ``trace`` event on the telemetry stream when telemetry
    is enabled.  ``ctx`` None is the untraced fast path (returns None
    immediately) so call sites stay unconditional.  ``parent_id`` defaults
    to the context's span id (the usual child-of-request shape); pass it
    explicitly to build deeper trees, or ``None`` to record a root span.
    ``span_id`` defaults to a fresh id; the server passes its request
    span's pre-minted id so stage spans recorded earlier link up."""
    if ctx is None:
        return None
    parent = ctx.span_id if parent_id is _UNSET else parent_id
    fields = {
        "trace_id": ctx.trace_id,
        "span_id": span_id or new_id(8),
        "name": str(name),
        "dur_s": round(float(dur_s), 9),
        **attrs,
    }
    if parent is not None:
        fields["parent_id"] = parent
    if t0 is not None:
        fields["t0"] = round(float(t0), 6)
    # pre-built record straight onto the ring: no kwargs re-expansion —
    # record_span is the per-span hot path the <2% overhead gate measures
    _RECORDER.append({"ts": round(time.time(), 6), "kind": "trace",
                      **fields})
    telemetry.count("tracing.spans")
    telemetry.event("trace", **fields)
    return fields


class _SpanTimer:
    """Context manager returned by ``span``: times the region and records
    it on exit (with ``ok``/``error`` from the exception state)."""

    __slots__ = ("_name", "_ctx", "_attrs", "_t0", "record")

    def __init__(self, name, ctx, attrs):
        self._name = name
        self._ctx = ctx
        self._attrs = attrs
        self.record = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        attrs = dict(self._attrs)
        if exc is not None:
            attrs.setdefault("ok", False)
            attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        self.record = record_span(self._name, self._ctx, dur_s=dt,
                                  t0=time.time() - dt, **attrs)
        return False


_NULL_SPAN = telemetry._NULL_CONTEXT


def span(name: str, ctx: "TraceContext | None", **attrs):
    """Time a region as one span of ``ctx``'s trace; the shared no-op when
    the request is untraced."""
    if ctx is None:
        return _NULL_SPAN
    return _SpanTimer(name, ctx, attrs)


# ---------------------------------------------------------------------------
# Trace reassembly (for /tracez, the JSONL stream, and tests)
# ---------------------------------------------------------------------------
def _is_span(rec: dict) -> bool:
    return rec.get("kind") == "trace" and isinstance(
        rec.get("trace_id"), str)


def traces_from_records(records) -> "dict[str, list[dict]]":
    """Group span records (ring snapshot or parsed JSONL events) by trace
    id, each trace's spans in record order."""
    out: dict[str, list[dict]] = {}
    for rec in records:
        if _is_span(rec):
            out.setdefault(rec["trace_id"], []).append(rec)
    return out


def trace_tree(spans: list[dict]) -> dict:
    """One trace's spans as a tree: ``{"roots": [...], "spans": n}`` where
    each node is ``{"span": <record>, "children": [...]}``.  A span whose
    parent is not among the records (the client's root) becomes a root."""
    by_id = {s["span_id"]: {"span": s, "children": []}
             for s in spans if isinstance(s.get("span_id"), str)}
    roots = []
    for node in by_id.values():
        parent = node["span"].get("parent_id")
        if isinstance(parent, str) and parent in by_id:
            by_id[parent]["children"].append(node)
        else:
            roots.append(node)
    return {"roots": roots, "spans": len(spans)}


def trace_summaries(records=None, *, limit: int = 50,
                    slow_s: float | None = None,
                    errored_only: bool = False) -> list[dict]:
    """Per-trace rollups from ``records`` (default: the live ring),
    newest-first: trace id, span count, total/max span duration, names,
    and whether any span errored.  ``slow_s`` keeps only traces whose
    longest span is at least that; ``errored_only`` keeps error traces —
    the two filters ``/tracez`` serves."""
    if records is None:
        records = _RECORDER.snapshot()
    rows = []
    for tid, spans in traces_from_records(records).items():
        max_dur = max((float(s.get("dur_s", 0.0)) for s in spans),
                      default=0.0)
        errored = any(s.get("ok") is False or s.get("error")
                      for s in spans)
        if slow_s is not None and max_dur < slow_s:
            continue
        if errored_only and not errored:
            continue
        rows.append({
            "trace_id": tid,
            "spans": len(spans),
            "names": sorted({str(s.get("name")) for s in spans}),
            "max_dur_s": round(max_dur, 6),
            "total_dur_s": round(sum(float(s.get("dur_s", 0.0))
                                     for s in spans), 6),
            "errored": errored,
            "last_ts": max((s.get("ts") or 0.0) for s in spans),
        })
    rows.sort(key=lambda r: r["last_ts"], reverse=True)
    return rows[:max(1, int(limit))]
